"""Port parity: gpu/curve.py against lighthouse_tpu's curve.py, bit for bit:
the complete group law on both curves, the 64-bit weight ladders at 4
rows, the static ladders behind the subgroup checks, point sums and the
affine conversions."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import curve_ref as JCR
from lighthouse_tpu.crypto.bls.tpu import curve as JC
from lighthouse_tpu_torch.crypto.bls.constants import R
from lighthouse_tpu_torch.crypto.bls.gpu import curve as C

from torch_port_util import assert_same, lazy

GROUPS = {"g1": ((4, 3), JC.FP, C.FP), "g2": ((4, 3, 2), JC.FP2, C.FP2)}


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("op", ["add", "double", "eq", "neg"])
def test_group_law_bitexact(group, op):
    """The formulas are exact integer schedules, so any limbs (on the curve
    or not, all-maximal included) must give the JAX limbs."""
    shape, JF, TF = GROUPS[group]
    rng = np.random.default_rng(51)
    p, q = lazy(rng, shape, maximal_rows=1), lazy(rng, shape)
    if op in ("add", "eq"):
        assert_same(lambda a, b: getattr(JC, op)(a, b, JF),
                    lambda a, b: getattr(C, op)(a, b, TF), p, q)
    else:
        assert_same(lambda a: getattr(JC, op)(a, JF),
                    lambda a: getattr(C, op)(a, TF), p)


def _points(n, group, seed):
    """n valid projective points (one infinity) as host limbs."""
    rng = np.random.default_rng(seed)
    gen = JCR.g1_generator() if group == "g1" else JCR.g2_generator()
    pts = [gen.mul(int(rng.integers(1, 2**62))) for _ in range(n - 1)]
    pts.append(JCR.Point(gen.x, gen.y, True))
    return (JC.g1_pack if group == "g1" else JC.g2_pack)(pts)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_scalar_mul_u64_ladder_bitexact(group):
    _, JF, TF = GROUPS[group]
    p = np.asarray(_points(4, group, 52))
    rng = np.random.default_rng(53)
    scalars = rng.integers(0, 1 << 32, size=(4, 2), dtype=np.uint32)
    scalars[0] = [0xFFFFFFFF, 0xFFFFFFFF]  # every bit set, high word first
    assert_same(
        lambda a, s: JC.scalar_mul_u64(a, s, JF),
        lambda a, s: C.scalar_mul_u64(a, s.to(torch.int64), TF),
        p, scalars,
    )


def test_subgroup_checks_bitexact():
    g1 = np.asarray(_points(4, "g1", 54))
    g2 = np.asarray(_points(4, "g2", 55))
    assert_same(JC.g1_subgroup_check, C.g1_subgroup_check, g1)
    assert_same(JC.g2_subgroup_check, C.g2_subgroup_check, g2)
    # a point off the subgroup fails on both sides: psi check rejects it
    bad = g2.copy()
    bad[1, 0, 0, 0] += 1
    assert_same(JC.g2_subgroup_check, C.g2_subgroup_check, bad)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_to_affine_and_sum_points_bitexact(group):
    _, JF, TF = GROUPS[group]
    rng = np.random.default_rng(56)
    p = lazy(rng, (5,) + GROUPS[group][0][1:], maximal_rows=1)
    p[2, 2] = 0  # one infinity (Z = 0) row
    to_aff = {"g1": (JC.to_affine_g1, C.to_affine_g1),
              "g2": (JC.to_affine_g2, C.to_affine_g2)}[group]
    assert_same(*to_aff, p)
    assert_same(lambda a: JC.sum_points(a, JF), lambda a: C.sum_points(a, TF), p)


def test_from_affine_and_psi_bitexact():
    rng = np.random.default_rng(57)
    aff, inf = lazy(rng, (4, 2, 2)), np.array([True, False, True, False])
    assert_same(lambda a, i: JC.from_affine(a, i, JC.FP2),
                lambda a, i: C.from_affine(a, i, C.FP2), aff, inf)
    assert_same(JC.psi, C.psi, lazy(rng, (3, 3, 2), maximal_rows=1))


def test_generators_and_oracle_round_trip():
    np.testing.assert_array_equal(C.G1_GEN, np.asarray(JC.G1_GEN))
    np.testing.assert_array_equal(C.G2_GEN, np.asarray(JC.G2_GEN))
    np.testing.assert_array_equal(C._PSI_C[0], np.asarray(JC._PSI_CX_DEV))
    np.testing.assert_array_equal(C._PSI_C[1], np.asarray(JC._PSI_CY_DEV))
    pts = [JCR.g1_generator().mul(k) for k in (3, R - 1)]
    back = C.g1_unpack(torch.as_tensor(C.g1_pack(pts)))
    assert [(p.x.n, p.y.n) for p in back] == [(p.x.n, p.y.n) for p in pts]


# --- the rest of curve.py: add_mixed, on_curve, the windowed ladder ----------

# the edge weights: 0, 1, 2^64 - 1 (the top bit of both words set), then a
# random one; words (hi, lo)
EDGE_SCALARS = np.array(
    [[0, 0], [0, 1], [0xFFFFFFFF, 0xFFFFFFFF], [0x9E3779B9, 0x7F4A7C15]],
    np.uint32,
)


def test_add_mixed_bitexact():
    rng = np.random.default_rng(58)
    for JF, TF, shape in ((JC.FP, C.FP, (3,)), (JC.FP2, C.FP2, (3, 2))):
        p, q = lazy(rng, (3, 3) + shape[1:], maximal_rows=1), lazy(rng, (3, 2) + shape[1:])
        q_inf = np.array([False, True, False])
        assert_same(lambda a, b, i: JC.add_mixed(a, b, i, JF),
                    lambda a, b, i: C.add_mixed(a, b, i, TF), p, q, q_inf)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_on_curve_bitexact_on_and_off_the_curve(group):
    """Points on the curve (one infinity), the same points with Y moved
    off it, and all-maximal limbs: the same verdicts and limbs as JAX."""
    good = np.asarray(_points(3, group, 59))
    bad = good.copy()
    bad[:, 1, ..., 0] += 1
    rng = np.random.default_rng(60)
    maximal = np.full((1,) + good.shape[1:], 1 << 12, np.int32)
    pts = np.concatenate([good, bad, maximal, lazy(rng, (1,) + good.shape[1:-1])])
    j_fn, t_fn = {"g1": (JC.on_curve_g1, C.on_curve_g1),
                  "g2": (JC.on_curve_g2, C.on_curve_g2)}[group]
    assert_same(j_fn, t_fn, pts)
    got = t_fn(torch.as_tensor(pts)).tolist()
    assert got[:6] == [True] * 3 + [False, False, True]  # bad infinity stays inf


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_scalar_mul_u64_windowed_bitexact_window_2(group):
    """The windowed ladder at window 2 (table of 4, 31 steps): digits from
    both words, masked after each shift, the table gather and the
    sequential table adds, limb for limb with JAX, on the edge weights.
    Window 4, the one the switch selects, compiles for minutes in JAX: the
    slow test below and its card twin hold it."""
    _, JF, TF = GROUPS[group]
    p = np.asarray(_points(4, group, 61))
    assert_same(
        lambda a, s: JC.scalar_mul_u64_windowed(a, s, JF, window=2),
        lambda a, s: C.scalar_mul_u64_windowed(a, s.to(torch.int64), TF, window=2),
        p, EDGE_SCALARS,
    )


@pytest.mark.slow
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_scalar_mul_u64_windowed_bitexact_window_4(group):
    """Window 4, as LIGHTHOUSE_TPU_PALLAS=1 selects it; JAX's XLA compile
    of it takes ~30 s (G1) and ~80 s (G2) on a CPU."""
    _, JF, TF = GROUPS[group]
    p = np.asarray(_points(4, group, 62))
    assert_same(
        lambda a, s: JC.scalar_mul_u64_windowed(a, s, JF),
        lambda a, s: C.scalar_mul_u64_windowed(a, s.to(torch.int64), TF),
        p, EDGE_SCALARS,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_scalar_mul_u64_windowed_on_card_bitexact_window_4(group):
    """The slow test's twin: the windowed ladder on the card (through the
    kernels) gives JAX's limbs at window 4, on the edge weights."""
    from torch_port_util import need_card, run_jax

    dev = need_card()
    _, JF, TF = GROUPS[group]
    p = np.asarray(_points(4, group, 62))
    want = run_jax(lambda a, s: JC.scalar_mul_u64_windowed(a, s, JF), p, EDGE_SCALARS)
    got = C.scalar_mul_u64_windowed(
        torch.as_tensor(p).to(dev), torch.as_tensor(EDGE_SCALARS.astype(np.int64)).to(dev), TF)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_windowed_and_bit_ladders_give_one_group_element(group):
    """Window 4 and the bit ladder: other projective limbs, the same
    affine point (canon-equal), on the edge weights."""
    from lighthouse_tpu_torch.crypto.bls.gpu import limbs as L

    _, _, TF = GROUPS[group]
    p = torch.as_tensor(np.array(_points(4, group, 63)))
    s = torch.as_tensor(EDGE_SCALARS.astype(np.int64))
    to_aff = C.to_affine_g1 if group == "g1" else C.to_affine_g2
    aw, iw = to_aff(C.scalar_mul_u64_windowed(p, s, TF))
    ab, ib = to_aff(C._scalar_mul_u64_bit(p, s, TF))
    assert torch.equal(iw, ib) and iw.tolist() == [True, False, False, True]
    assert torch.equal(L.canon(aw), L.canon(ab))


def test_ladder_switch_is_read_at_import():
    """Without LIGHTHOUSE_TPU_PALLAS the bit ladder is bound; with it set at
    import (a fresh process), the windowed one."""
    import os
    import subprocess
    import sys

    assert not C.WINDOWED_LADDER and C.scalar_mul_u64 is C._scalar_mul_u64_bit
    code = ("from lighthouse_tpu_torch.crypto.bls.gpu import curve as C; "
            "print(C.WINDOWED_LADDER, C.scalar_mul_u64 is C._scalar_mul_u64_bit, "
            "C.scalar_mul_u64.__code__.co_names)")
    env = dict(os.environ, LIGHTHOUSE_TPU_PALLAS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.stdout.split()[:2] == ["True", "False"]
    assert "scalar_mul_u64_windowed" in out.stdout

"""Port parity: gpu/pairing.py and the Miller-step kernels' plain versions
against lighthouse_tpu's pairing.py: the fused steps' plain versions equal
the jitted JAX lax composition (the Pallas steps are bit-identical to it
by contract), miller_loop is bit-identical at 4 pairs, and the final
exponentiation gives the cube of the oracle pairing, as
tests/test_tpu_pairing.py checks the JAX side."""

import random

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import curve_ref as JCR
from lighthouse_tpu.crypto.bls import pairing_ref as PR
from lighthouse_tpu.crypto.bls.constants import R
from lighthouse_tpu.crypto.bls.tpu import curve as JC
from lighthouse_tpu.crypto.bls.tpu import pairing as JP
from lighthouse_tpu.crypto.bls.tpu import tower as JT
from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K
from lighthouse_tpu_torch.crypto.bls.gpu import limbs as L
from lighthouse_tpu_torch.crypto.bls.gpu import pairing as TP

from torch_port_util import assert_same, lazy, need_card


def _jax_dbl(f, t, xp, yp):
    t2, line = JP._dbl_step(t, xp, yp)
    return JP.mul_by_line(JT.fp12_sq(f), line), t2


def _jax_add(f, t, q, xp, yp):
    t2, line = JP._add_step(t, q, xp, yp)
    return JP.mul_by_line(f, line), t2


def _step_inputs(seed, rows=3):
    rng = np.random.default_rng(seed)
    return dict(
        f=lazy(rng, (rows, 2, 3, 2), maximal_rows=1),
        t=lazy(rng, (rows, 3, 2), maximal_rows=1),
        q=lazy(rng, (rows, 2, 2), maximal_rows=1),
        xp=lazy(rng, (rows,), maximal_rows=1),
        yp=lazy(rng, (rows,), maximal_rows=1),
    )


def test_miller_dbl_step_plain_matches_jax_composition():
    x = _step_inputs(71)
    assert_same(_jax_dbl, K.miller_dbl_step, x["f"], x["t"], x["xp"], x["yp"])


def test_miller_add_step_plain_matches_jax_composition():
    x = _step_inputs(72)
    assert_same(_jax_add, K.miller_add_step, x["f"], x["t"], x["q"], x["xp"], x["yp"])


def _pairs():
    rng = random.Random(0xBEEF)
    g1, g2 = JCR.g1_generator(), JCR.g2_generator()
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    inf1 = JCR.Point(g1.x, g1.y, True)
    pairs = [(g1, g2), (g1.mul(a), g2.mul(b)), (inf1, g2), (g1, g2.mul(b))]
    g1s = np.asarray(JC.g1_pack([p for p, _ in pairs]))[:, :2]
    g2s = np.asarray(JC.g2_pack([q for _, q in pairs]))[:, :2]
    p_inf = np.array([p.inf for p, _ in pairs])
    q_inf = np.array([q.inf for _, q in pairs])
    return pairs, (g1s, p_inf, g2s, q_inf)


def test_miller_loop_bitexact_and_final_exp_is_oracle_cube():
    pairs, args = _pairs()
    assert_same(JP.miller_loop, TP.miller_loop, *args)
    f = TP.miller_loop(*(torch.as_tensor(np.array(a)) for a in args))
    got = TP.final_exponentiation(f)
    canon = L.canon(got).numpy()
    for i, (p, q) in enumerate(pairs):
        np.testing.assert_array_equal(
            canon[i], JT.fp12_pack_ref(PR.pairing(p, q).pow(3))
        )


def test_miller_loop_counts_one_step_launch_per_bit():
    """The loop drives the step wrappers 63 + 5 times (on CPU tensors the
    plain versions run and nothing launches)."""
    calls = {"dbl": 0, "add": 0}
    real_dbl, real_add = K.miller_dbl_step, K.miller_add_step

    def dbl(*a):
        calls["dbl"] += 1
        return real_dbl(*a)

    def add(*a):
        calls["add"] += 1
        return real_add(*a)

    _, args = _pairs()
    K.miller_dbl_step, K.miller_add_step = dbl, add
    try:
        TP.miller_loop(*(torch.as_tensor(np.array(a))[:1] for a in args))
    finally:
        K.miller_dbl_step, K.miller_add_step = real_dbl, real_add
    assert calls == {"dbl": 63, "add": 5}


def _pairing_is_oracle_cube(got, pairs):
    canon = L.canon(got).cpu().numpy()
    for i, (p, q) in enumerate(pairs):
        np.testing.assert_array_equal(
            canon[i], JT.fp12_pack_ref(PR.pairing(p, q).pow(3)))


def test_pairing_is_the_oracle_cube():
    """`pairing` (Miller loop and final exponentiation per row) on two
    pairs, one with an infinity: the cube of the oracle pairing."""
    pairs, args = _pairs()
    pairs, args = pairs[1:3], [a[1:3] for a in args]
    got = TP.pairing(*(torch.as_tensor(np.array(a)) for a in args))
    _pairing_is_oracle_cube(got, pairs)


@pytest.mark.slow
def test_pairing_bitexact_with_jax():
    """JAX's jitted `pairing` compiles the final exponentiation: minutes on
    a CPU."""
    _, args = _pairs()
    assert_same(JP.pairing, TP.pairing, *args)


@pytest.mark.gpu
def test_pairing_on_card_bitexact_with_cpu_and_oracle_cube():
    """The slow test's twin: `pairing` on the card, through the kernels,
    gives the CPU plain version's limbs and the oracle pairing's cube."""
    dev = need_card()
    pairs, args = _pairs()
    got = TP.pairing(*(torch.as_tensor(np.array(a)).to(dev) for a in args))
    want = TP.pairing(*(torch.as_tensor(np.array(a)) for a in args))
    assert torch.equal(got.cpu(), want)
    _pairing_is_oracle_cube(got, pairs)


def test_fp12_prod_bitexact():
    rng = np.random.default_rng(73)
    assert_same(JP.fp12_prod, TP.fp12_prod, lazy(rng, (3, 2, 3, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lazy", "maximal"])
@pytest.mark.parametrize("rows", [1, 33, 65, 1025])
def test_miller_step_kernels_on_card_equal_plain(rows, kind):
    """Both step kernels equal their plain versions on the card, at one
    pair, the aggregate batch's 33, the gossip batch's 65 and 1025 pairs,
    on seeded lazy limbs (first row all-maximal) and with every limb of
    every operand at 2^12."""
    dev = need_card()
    x = {k: torch.as_tensor(v).to(dev) for k, v in _step_inputs(74, rows).items()}
    if kind == "maximal":
        x = {k: torch.full_like(v, 1 << 12) for k, v in x.items()}
    got = K.miller_dbl_step(x["f"], x["t"], x["xp"], x["yp"])
    want = K.miller_dbl_step_plain(x["f"], x["t"], x["xp"], x["yp"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = K.miller_add_step(x["f"], x["t"], x["q"], x["xp"], x["yp"])
    want = K.miller_add_step_plain(x["f"], x["t"], x["q"], x["xp"], x["yp"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))

"""Port parity: gpu/limbs.py and the fp_mul/fp_sq kernels' plain versions
against lighthouse_tpu's limbs.py and pallas_kernels.fp_mul/fp_sq
(interpret mode), bit for bit on seeded lazy limbs, all-limbs-maximal
rows and broadcast shapes."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.tpu import limbs as JL
from lighthouse_tpu.crypto.bls.tpu import pallas_kernels as PK
from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K
from lighthouse_tpu_torch.crypto.bls.gpu import limbs as L

from torch_port_util import assert_same, lazy, need_card


@pytest.mark.parametrize(
    "name",
    ["FOLD_R", "P_LIMBS", "_P_HI_LIMBS", "_C_SHIFT", "_KP", "ONE", "TOEP_IDX"],
)
def test_constants_equal_jax(name):
    np.testing.assert_array_equal(
        np.asarray(getattr(L, name)), np.asarray(getattr(JL, name))
    )
    assert L._BARRETT_INV == JL._BARRETT_INV


UNARY = {
    "carry3": (JL.carry3, L.carry3),
    "neg": (JL.neg, L.neg),
    "sq": (JL.sq, L.sq),
    "canon": (JL.canon, L.canon),
    "is_zero": (JL.is_zero, L.is_zero),
    "mul_small": (lambda a: JL.mul_small(a, -7), lambda a: L.mul_small(a, -7)),
    "norm": (JL._norm, L._norm),
    "fold": (JL._fold_round, L._fold_round),
}
BINARY = {
    "mul": (JL.mul, L.mul),
    "add": (JL.add, L.add),
    "sub": (JL.sub, L.sub),
    "eq": (JL.eq, L.eq),
    "mul_columns": (JL.mul_columns, L.mul_columns),
    "reduce_mul_columns": (
        lambda a, b: JL.reduce_columns(JL.mul_columns(a, b) - JL.mul_columns(b, b)),
        lambda a, b: L.reduce_columns(L.mul_columns(a, b) - L.mul_columns(b, b)),
    ),
    "lincomb": (
        lambda a, b: JL.lincomb([(a, 3), (b, -5)]),
        lambda a, b: L.lincomb([(a, 3), (b, -5)]),
    ),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops_bitexact(name):
    rng = np.random.default_rng(11)
    assert_same(*UNARY[name], lazy(rng, (6,), maximal_rows=2))


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_bitexact_with_broadcast(name):
    rng = np.random.default_rng(12)
    a = lazy(rng, (2, 5), maximal_rows=1)
    b = lazy(rng, (5,))
    b[0] = -1  # most-negative lazy limbs against the maximal row
    assert_same(*BINARY[name], a, b)


def test_canon_and_eq_on_exact_multiples_of_p():
    """canon lands in [0, p) at the edges: 0, p, 2p, 3p - 1 and their
    negatives all canonicalize like the JAX path."""
    P = JL.P
    vals = [0, P, 2 * P, 3 * P - 1, P - 1, 1]
    a = np.stack([JL.to_limbs(v) for v in vals]).astype(np.int32)
    assert_same(JL.canon, L.canon, a)
    assert_same(lambda x: JL.canon(JL.neg(x)), lambda x: L.canon(L.neg(x)), a)
    assert_same(JL.is_zero, L.is_zero, a)


def test_select_bitexact():
    rng = np.random.default_rng(13)
    a, b = lazy(rng, (4,)), lazy(rng, (4,))
    cond = np.array([True, False, True, False])
    assert_same(JL.select, L.select, cond, a, b)


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 5)])
def test_fp_mul_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(21)
    a, b = lazy(rng, shape, maximal_rows=1), lazy(rng, shape, maximal_rows=1)
    assert_same(PK.fp_mul, K.fp_mul, a, b)


@pytest.mark.parametrize("shape", [(1,), (9,)])
def test_fp_sq_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(22)
    assert_same(PK.fp_sq, K.fp_sq, lazy(rng, shape, maximal_rows=1))


def test_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors: the plain version and no launch; any other device that
    is not CUDA: an error, never a silent fallback."""
    rng = np.random.default_rng(23)
    a = torch.as_tensor(lazy(rng, (3,)))
    before = dict(K.LAUNCHES)
    assert torch.equal(K.fp_mul(a, a), K.fp_mul_plain(a, a))
    assert torch.equal(K.fp_sq(a), K.fp_mul_plain(a, a))
    assert K.LAUNCHES == before
    meta = torch.empty((3, L.W), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.fp_mul(meta, meta)
    with pytest.raises(ValueError):
        K.fp_mul(a, meta)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 7, 128, 1000, 1024, 98304])
def test_fp_kernels_on_card_equal_plain(rows):
    """The warp-per-row fp_mul and fp_sq equal their plain versions on the
    card at the inversions' one row, a ragged 7 (a block of four warps
    part-filled), the sqrt chains' 128 and 1024 rows, a ragged 1000 and
    the aggregate batch's largest fp_mul launch, 98,304 rows, on seeded
    lazy limbs with up to three all-maximal rows and on all-maximal
    operands; each also against its plain version on the CPU."""
    dev = need_card()
    rng = np.random.default_rng(24)
    a = torch.as_tensor(lazy(rng, (rows,), maximal_rows=min(3, rows - 1))).to(dev)
    b = torch.as_tensor(lazy(rng, (rows,), maximal_rows=3)).to(dev)
    n0, s0 = K.LAUNCHES["fp_mul"], K.LAUNCHES["fp_sq"]
    got = K.fp_mul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, K.fp_mul_plain(a, b))
    assert torch.equal(got.cpu(), K.fp_mul_plain(a.cpu(), b.cpu()))
    got = K.fp_sq(a)
    torch.cuda.synchronize()
    assert torch.equal(got, K.fp_sq_plain(a))
    assert torch.equal(got.cpu(), K.fp_sq_plain(a.cpu()))
    full = torch.full_like(a, 1 << 12)
    assert torch.equal(K.fp_mul(full, full), K.fp_mul_plain(full, full))
    assert torch.equal(K.fp_sq(full), K.fp_sq_plain(full))
    assert K.LAUNCHES["fp_mul"] == n0 + 2
    assert K.LAUNCHES["fp_sq"] == s0 + 2

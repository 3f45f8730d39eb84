"""Port parity: gpu/tower.py against lighthouse_tpu's tower.py, bit for
bit -- including the batch inverses, whose prefix products must pair up in
jax.lax.associative_scan's order (lazy limbs are not canonical, so another
order gives other limbs) -- and the tower kernel wrappers (fp6_mul,
fp12_mul, fp12_cyclotomic_sq) on CPU tensors, where they must return their
plain versions exactly."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.tpu import tower as JT
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K
from lighthouse_tpu_torch.crypto.bls.gpu import tower as T

from torch_port_util import assert_same, lazy, need_card

FP2 = {
    "fp2_mul": (JT.fp2_mul, T.fp2_mul, 2),
    "fp2_sq": (JT.fp2_sq, T.fp2_sq, 1),
    "fp2_conj": (JT.fp2_conj, T.fp2_conj, 1),
    "fp2_mul_by_xi": (JT.fp2_mul_by_xi, T.fp2_mul_by_xi, 1),
    "fp2_eq": (JT.fp2_eq, T.fp2_eq, 2),
    "fp2_is_zero": (JT.fp2_is_zero, T.fp2_is_zero, 1),
}


@pytest.mark.parametrize("name", sorted(FP2))
def test_fp2_ops_bitexact(name):
    jf, tf, arity = FP2[name]
    rng = np.random.default_rng(31)
    args = [lazy(rng, (5, 2), maximal_rows=1) for _ in range(arity)]
    assert_same(jf, tf, *args)


def test_fp2_mul_broadcast_and_mul_fp():
    rng = np.random.default_rng(32)
    a, b = lazy(rng, (3, 2)), lazy(rng, (2,))
    assert_same(JT.fp2_mul, T.fp2_mul, a, b)
    s = lazy(rng, (3,), maximal_rows=1)
    assert_same(JT.fp2_mul_fp, T.fp2_mul_fp, a, s)


@pytest.mark.parametrize("e", [5, 15, P - 2])
def test_fp_pow_static_bitexact(e):
    rng = np.random.default_rng(33)
    assert_same(
        lambda a: JT.fp_pow_static(a, e), lambda a: T.fp_pow_static(a, e),
        lazy(rng, (3,), maximal_rows=1),
    )


@pytest.mark.parametrize("n", [1, 3, 8])
def test_fp_batch_inv_keeps_associative_scan_order(n):
    rng = np.random.default_rng(35 + n)
    assert_same(JT.fp_batch_inv, T.fp_batch_inv, lazy(rng, (n,), maximal_rows=1))


def test_fp2_batch_inv_bitexact():
    rng = np.random.default_rng(41)
    assert_same(JT.fp2_batch_inv, T.fp2_batch_inv, lazy(rng, (6, 2)))


FP6 = {
    "fp6_mul": (JT.fp6_mul, T.fp6_mul, 2),
    "fp6_sq": (JT.fp6_sq, T.fp6_sq, 1),
    "fp6_mul_by_v": (JT.fp6_mul_by_v, T.fp6_mul_by_v, 1),
    "fp6_inv": (JT.fp6_inv, T.fp6_inv, 1),
}


@pytest.mark.parametrize("name", sorted(FP6))
def test_fp6_ops_bitexact(name):
    jf, tf, arity = FP6[name]
    rng = np.random.default_rng(42)
    args = [lazy(rng, (3, 3, 2), maximal_rows=1) for _ in range(arity)]
    assert_same(jf, tf, *args)


FP12 = {
    "fp12_sq": (JT.fp12_sq, T.fp12_sq, 1),
    "fp12_cyclotomic_sq": (JT.fp12_cyclotomic_sq, T.fp12_cyclotomic_sq, 1),
    "fp12_conj": (JT.fp12_conj, T.fp12_conj, 1),
    "fp12_inv": (JT.fp12_inv, T.fp12_inv, 1),
    "fp12_frobenius": (JT.fp12_frobenius, T.fp12_frobenius, 1),
    "fp12_is_one": (JT.fp12_is_one, T.fp12_is_one, 1),
}


@pytest.mark.parametrize("name", sorted(FP12))
def test_fp12_ops_bitexact(name):
    jf, tf, arity = FP12[name]
    rng = np.random.default_rng(43)
    args = [lazy(rng, (2, 2, 3, 2), maximal_rows=1) for _ in range(arity)]
    assert_same(jf, tf, *args)


def test_fp12_mul_bitexact_with_broadcast():
    rng = np.random.default_rng(44)
    assert_same(
        JT.fp12_mul, T.fp12_mul,
        lazy(rng, (3, 2, 3, 2), maximal_rows=1), lazy(rng, (2, 3, 2)),
    )


def test_fp_sqrt_bitexact():
    """The root and the is-square flag: squares of random elements, random
    lazy limbs (about half non-squares) and all-maximal limbs."""
    rng = np.random.default_rng(45)
    xs = [int(v) for v in rng.integers(1, 1 << 62, size=2)]
    squares = np.stack([T.fp2_from_ints(x * x, 0)[0] for x in xs])
    a = np.concatenate([squares, lazy(rng, (3,), maximal_rows=1)])
    assert_same(JT.fp_sqrt, T.fp_sqrt, a)
    assert T.fp_sqrt(torch.as_tensor(a))[1][:2].tolist() == [True, True]


@pytest.mark.parametrize("e", [1, 6, (P * P - 9) // 16], ids=["1", "6", "p2"])
def test_fp2_pow_static_bitexact(e):
    rng = np.random.default_rng(46)
    assert_same(
        lambda a: JT.fp2_pow_static(a, e), lambda a: T.fp2_pow_static(a, e),
        lazy(rng, (3, 2), maximal_rows=1),
    )


def test_fp6_mul_fp2_and_tower_helpers_bitexact():
    rng = np.random.default_rng(47)
    assert_same(JT.fp6_mul_fp2, T.fp6_mul_fp2,
                lazy(rng, (3, 3, 2), maximal_rows=1), lazy(rng, (3, 2), maximal_rows=1))
    np.testing.assert_array_equal(
        T.fp6_one((2,), "cpu").numpy(), np.asarray(JT.fp6_one((2,))))
    np.testing.assert_array_equal(
        T.fp6_zero((2,), "cpu").numpy(), np.asarray(JT.fp6_zero((2,))))
    vals = [(3, P - 1), (P + 5, 7)]
    np.testing.assert_array_equal(T.fp2_pack(vals), np.asarray(JT.fp2_pack(vals)))
    assert T.fp2_to_ints(torch.as_tensor(T.fp2_pack(vals)[1])) == (5, 7)
    f = lazy(rng, (2, 3, 2))
    ref = T.fp12_to_ref(torch.as_tensor(f))
    jref = JT.fp12_to_ref(f)
    np.testing.assert_array_equal(T.fp12_pack_ref(ref), JT.fp12_pack_ref(jref))


def test_frobenius_constants_equal_jax():
    np.testing.assert_array_equal(T._GAMMA_J, np.asarray(JT._GAMMA_J))


# --- the tower kernel wrappers on CPU tensors ---------------------------------

TOWER_WRAPPERS = {
    # name: (wrapper, plain version, operand tail shape, arity)
    "fp6_mul": (K.fp6_mul, K.fp6_mul_plain, (3, 2), 2),
    "fp12_mul": (K.fp12_mul, K.fp12_mul_plain, (2, 3, 2), 2),
    "fp12_cyclotomic_sq": (
        K.fp12_cyclotomic_sq, K.fp12_cyclotomic_sq_plain, (2, 3, 2), 1),
}


@pytest.mark.parametrize("name", sorted(TOWER_WRAPPERS))
def test_tower_wrappers_on_cpu_return_the_plain_version(name):
    """On CPU tensors each wrapper returns exactly its plain version, on
    plain, broadcast and strided operands (fp12_prod hands fp12_mul the
    halves f[0::2], f[1::2]; fp12_inv broadcasts one Fp6 inverse), and
    counts no launch."""
    wrap, plain, tail, arity = TOWER_WRAPPERS[name]
    rng = np.random.default_rng(45)
    x = torch.as_tensor(lazy(rng, (6,) + tail, maximal_rows=1))
    cases = [(x[:3], x[3:])[:arity], (x[0::2], x[1::2])[:arity],
             (x[:1, None], x[1:3])[:arity], (x[2],)]
    if arity == 2:
        cases[-1] = (x[:4], x[5])
    K.reset_launches()
    for args in cases:
        got, want = wrap(*args), plain(*args)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want)
    assert K.LAUNCHES[name] == 0


def test_tower_dispatch_goes_through_the_wrappers():
    """gpu/tower.py's names route to the kernel wrappers, whose plain
    versions are the op compositions (no recursion through tower)."""
    rng = np.random.default_rng(46)
    a = torch.as_tensor(lazy(rng, (2, 2, 3, 2)))
    b = torch.as_tensor(lazy(rng, (2, 2, 3, 2)))
    assert torch.equal(T.fp12_mul(a, b), K.fp12_mul_plain(a, b))
    assert torch.equal(T.fp12_cyclotomic_sq(a), K.fp12_cyclotomic_sq_plain(a))
    assert torch.equal(T.fp6_mul(a[:, 0], b[:, 1]), K.fp6_mul_plain(a[:, 0], b[:, 1]))


@pytest.mark.parametrize("name", sorted(TOWER_WRAPPERS))
def test_tower_wrappers_refuse_wrong_dtype_and_shape(name):
    wrap, _, tail, arity = TOWER_WRAPPERS[name]
    rng = np.random.default_rng(47)
    x = torch.as_tensor(lazy(rng, (2,) + tail))
    with pytest.raises(TypeError, match="int32"):
        wrap(*[x.long()] * arity)
    with pytest.raises(ValueError, match=name):
        wrap(*[x[..., :34]] * arity)
    with pytest.raises(ValueError, match=name):
        wrap(*[x[..., 0, :, :]] * arity)
    if arity == 2:
        with pytest.raises(RuntimeError):  # leading shapes do not broadcast
            wrap(x, torch.cat([x, x, x]))


@pytest.mark.parametrize("name", sorted(TOWER_WRAPPERS))
def test_tower_plain_versions_bitexact_with_jax_all_maximal(name):
    """The plain versions against the JAX lax functions (which the Pallas
    kernels equal by contract), every operand limb at 2^12 in the first
    row."""
    jf = {"fp6_mul": JT.fp6_mul, "fp12_mul": JT.fp12_mul,
          "fp12_cyclotomic_sq": JT.fp12_cyclotomic_sq}[name]
    _, plain, tail, arity = TOWER_WRAPPERS[name]
    rng = np.random.default_rng(48)
    args = [lazy(rng, (3,) + tail, maximal_rows=1) for _ in range(arity)]
    assert_same(jf, plain, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lazy", "maximal"])
@pytest.mark.parametrize("rows", [1, 1025])
def test_fp12_cyclotomic_sq_kernel_on_card_equals_plain(rows, kind):
    """The block-per-row cyclotomic square equals its plain version on the
    card at the final exponentiation's one row and at 1025 rows, on seeded
    lazy limbs and with every limb at 2^12; the launch is counted."""
    dev = need_card()
    rng = np.random.default_rng(49)
    a = torch.as_tensor(lazy(rng, (rows, 2, 3, 2))).to(dev)
    if kind == "maximal":
        a = torch.full_like(a, 1 << 12)
    before = K.LAUNCHES["fp12_cyclotomic_sq"]
    got = K.fp12_cyclotomic_sq(a)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fp12_cyclotomic_sq"] == before + 1
    assert torch.equal(got, K.fp12_cyclotomic_sq_plain(a))
    assert torch.equal(got.cpu(), K.fp12_cyclotomic_sq_plain(a.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lazy", "maximal", "strided"])
@pytest.mark.parametrize("rows", [1, 2, 64, 1025])
def test_fp12_mul_kernel_on_card_equals_plain(rows, kind):
    """The block-per-row Fp12 product equals its plain version on the card
    at the final exponentiation's one row, the halving product's 2 and 64
    rows and a ragged 1025: on seeded lazy limbs, with every limb at 2^12,
    and on fp12_prod's strided halves (every other row of one tensor, which
    the wrapper copies to rows); the launch is counted."""
    dev = need_card()
    rng = np.random.default_rng(50)
    f = torch.as_tensor(lazy(rng, (2 * rows, 2, 3, 2))).to(dev)
    a, b = f[:rows], f[rows:]
    if kind == "maximal":
        a, b = torch.full_like(a, 1 << 12), torch.full_like(b, 1 << 12)
    elif kind == "strided":
        a, b = f[0::2], f[1::2]
    before = K.LAUNCHES["fp12_mul"]
    got = K.fp12_mul(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fp12_mul"] == before + 1
    assert torch.equal(got, K.fp12_mul_plain(a, b))
    assert torch.equal(got.cpu(), K.fp12_mul_plain(a.cpu(), b.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lazy", "maximal", "broadcast"])
@pytest.mark.parametrize("rows", [1, 2, 3, 1025])
def test_fp6_mul_kernel_on_card_equals_plain(rows, kind):
    """The block-per-row Fp6 product equals its plain version on the card
    at fp12_inv's 2 rows, at 1 and 3 and at a ragged 1025: on seeded lazy
    limbs, with every limb at 2^12, and with one row of b broadcast over
    every row of a (fp12_inv's stacked call); the launch is counted."""
    dev = need_card()
    rng = np.random.default_rng(51)
    a = torch.as_tensor(lazy(rng, (rows, 3, 2))).to(dev)
    b = torch.as_tensor(lazy(rng, (rows, 3, 2))).to(dev)
    if kind == "maximal":
        a, b = torch.full_like(a, 1 << 12), torch.full_like(b, 1 << 12)
    elif kind == "broadcast":
        b = b[:1]
    before = K.LAUNCHES["fp6_mul"]
    got = K.fp6_mul(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fp6_mul"] == before + 1
    assert got.shape == a.shape
    assert torch.equal(got, K.fp6_mul_plain(a, b))
    assert torch.equal(got.cpu(), K.fp6_mul_plain(a.cpu(), b.cpu()))


def test_c_entry_points_match_the_bindings():
    """Every C entry point bound in kernels.ENTRY is defined in its
    library's source with that many pointer arguments before `int n,
    void* stream` (a mismatch would pass garbage pointers on the card)."""
    import re

    for lib, src in K.LIBS.items():
        text = (K.CSRC / src).read_text()
        for fn, n_ptr in K.ENTRY[lib].items():
            m = re.search(r'extern "C" int %s\(([^)]*)\)' % fn, text)
            assert m, (src, fn)
            args = [a.strip() for a in m.group(1).split(",")]
            assert args[-2:] == ["int n", "void* stream"], (fn, args)
            assert len(args) - 2 == n_ptr, (fn, args)
            assert all(a.endswith("*") or "* " in a for a in args[:-2]), args
    assert set(K.ENTRY) == set(K.LIBS)

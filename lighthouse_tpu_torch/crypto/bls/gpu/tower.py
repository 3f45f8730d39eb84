"""Extension-field towers Fp2/Fp6/Fp12 on the limb representation, in PyTorch.

Port of lighthouse_tpu/crypto/bls/tpu/tower.py. Layouts (limbs last, batch
axes lead):
    Fp2  : (..., 2, W)           c0 + c1*u,          u^2 = -1
    Fp6  : (..., 3, 2, W)        c0 + c1*v + c2*v^2, v^3 = 1+u
    Fp12 : (..., 2, 3, 2, W)     c0 + c1*w,          w^2 = v

Every function returns the same int32 tensor as its JAX counterpart. Where
the JAX text computes independent values with separate calls, this port
often stacks them into one call on a new axis: each row still goes through
the same formula, so the limbs are the same, and the GPU runs a few large
ops instead of many tiny ones (the plain layers are launch-bound).

`fp6_mul`, `fp12_mul` and `fp12_cyclotomic_sq` go through the wrappers in
kernels.py: a hand-written CUDA kernel for a CUDA tensor, the op
composition (`kernels.*_plain`) for a CPU one.

Static-exponent powers run as Python loops over the host bit table, and a
`lax.cond` on such a bit becomes a Python `if`. The batch inverses keep
`jax.lax.associative_scan`'s pairing order (`_assoc_scan`): lazy limbs are
not canonical, so another product order gives other limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import P
from ..fields_ref import FROB_GAMMA as _REF_GAMMA
from ..fields_ref import Fp2 as RefFp2
from . import limbs as L

W = L.W


# --- host <-> device conversion -------------------------------------------


def fp2_from_ints(c0: int, c1: int) -> np.ndarray:
    return np.stack([L.to_limbs(c0 % P), L.to_limbs(c1 % P)])


def fp2_pack(vals) -> np.ndarray:
    """[(c0, c1), ...] -> (n, 2, W) host array."""
    return np.stack([fp2_from_ints(a, b) for a, b in vals]).astype(np.int32)


def fp2_to_ints(a) -> tuple[int, int]:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return L.to_fp_int(a[0]), L.to_fp_int(a[1])


def fp12_pack_ref(x) -> np.ndarray:
    """Oracle Fp12 -> (2, 3, 2, W) host array."""
    out = np.zeros((2, 3, 2, W), np.int32)
    for i, c6 in enumerate((x.c0, x.c1)):
        for j, c2 in enumerate((c6.c0, c6.c1, c6.c2)):
            out[i, j, 0] = L.to_limbs(c2.c0.n)
            out[i, j, 1] = L.to_limbs(c2.c1.n)
    return out


def fp12_to_ref(a):
    """(2, 3, 2, W) -> oracle Fp12 (host)."""
    from ..fields_ref import Fp12 as RefFp12, Fp6 as RefFp6

    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)

    def f2(x):
        return RefFp2(L.to_fp_int(x[0]), L.to_fp_int(x[1]))

    def f6(x):
        return RefFp6(f2(x[0]), f2(x[1]), f2(x[2]))

    return RefFp12(f6(a[0]), f6(a[1]))


# --- Fp2 -------------------------------------------------------------------

fp2_add = L.add
fp2_sub = L.sub
fp2_neg = L.neg


def fp2_mul(a, b):
    """Karatsuba with column-domain sharing: 3 column products (one stacked
    call), combined before TWO shared reductions (one stacked call)."""
    a, b = torch.broadcast_tensors(a, b)
    s = L.add(  # [a0 + a1, b0 + b1]
        torch.stack([a[..., 0, :], b[..., 0, :]]),
        torch.stack([a[..., 1, :], b[..., 1, :]]),
    )
    cols = L.mul_columns(
        torch.cat([a, s[0].unsqueeze(-2)], dim=-2),
        torch.cat([b, s[1].unsqueeze(-2)], dim=-2),
    )
    t0c, t1c, tkc = cols[..., 0, :], cols[..., 1, :], cols[..., 2, :]
    return L.reduce_columns(torch.stack([t0c - t1c, tkc - t0c - t1c], dim=-2))


def fp2_sq(a):
    """(a0+a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u: 2 column products, 2
    shared reductions."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    s = L._fold_round(torch.stack([a0 + a1, a0 - a1], dim=-2))  # add, sub
    cols = L.mul_columns(
        torch.stack([a0, s[..., 0, :]], dim=-2),
        torch.stack([a1, s[..., 1, :]], dim=-2),
    )
    tc = cols[..., 0, :]
    return L.reduce_columns(torch.stack([cols[..., 1, :], tc + tc], dim=-2))


def fp2_conj(a):
    return torch.stack([a[..., 0, :], L.neg(a[..., 1, :])], dim=-2)


def fp2_mul_by_xi(a):
    """Multiply by xi = 1 + u: (c0 - c1) + (c0 + c1) u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return L._fold_round(torch.stack([a0 - a1, a0 + a1], dim=-2))


def fp2_mul_small(a, k: int):
    return L.mul_small(a, k)


def fp2_mul_fp(a, s):
    """Fp2 x Fp scalar (s: (..., W)): both halves in one Fp multiply."""
    return L.mul(a, s.unsqueeze(-2))


def fp2_select(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


def fp2_eq(a, b):
    return torch.all(L.canon(L.sub(a, b)) == 0, dim=(-1, -2))


def fp2_is_zero(a):
    return torch.all(L.canon(a) == 0, dim=(-1, -2))


def fp2_zero(shape, device):
    return torch.zeros(tuple(shape) + (2, W), dtype=torch.int32, device=device)


def fp2_one(shape, device):
    o = fp2_zero(shape, device)
    o[..., 0, :] = L.on(L.ONE, device)
    return o


# --- static-exponent Fp power (loops over host bits) -----------------------


def _bits_msb_first(e: int) -> list:
    return [b == "1" for b in bin(e)[2:]]


_POW_WINDOW = 4  # fixed 4-bit windows: 4 sq + 1 table mul per digit


def _digits_msb_first(e: int, window: int) -> list:
    nbits = max(e.bit_length(), 1)
    ndigits = -(-nbits // window)
    return [
        (e >> (window * (ndigits - 1 - i))) & ((1 << window) - 1)
        for i in range(ndigits)
    ]


def fp_pow_static(a, e: int):
    """a^e for a host exponent e >= 1: fixed 4-bit windows, 4 squarings and
    one table multiply per digit (tiny exponents: square-and-multiply)."""
    digits = _digits_msb_first(e, _POW_WINDOW)
    if len(digits) == 1:
        acc = L.one(a.shape[:-1], a.device)
        for bit in _bits_msb_first(e):
            acc = L.sq(acc)
            if bit:
                acc = L.mul(acc, a)
        return acc
    table = [L.one(a.shape[:-1], a.device), a]
    for _ in range(2, 1 << _POW_WINDOW):
        table.append(L.mul(table[-1], a))
    acc = table[digits[0]]
    for digit in digits[1:]:
        for _ in range(_POW_WINDOW):
            acc = L.sq(acc)
        acc = L.mul(acc, table[digit])
    return acc


def fp_inv(a):
    """Fermat inversion a^(p-2); a == 0 maps to 0 (callers gate zeros)."""
    return fp_pow_static(a, P - 2)


def fp_sqrt(a):
    """Candidate sqrt a^((p+1)/4) (p = 3 mod 4); returns (root, is_square)."""
    r = fp_pow_static(a, (P + 1) // 4)
    return r, L.eq(L.sq(r), a)


def _assoc_scan(fn, x):
    """Inclusive scan along axis 0 in `jax.lax.associative_scan`'s order:
    combine adjacent pairs, recurse on the half, fill the even slots."""
    n = x.shape[0]
    if n < 2:
        return x
    odd = _assoc_scan(fn, fn(x[0 : n - 1 : 2], x[1::2]))
    rest = x[2::2]
    if rest.shape[0]:
        even = fn(odd[:-1] if n % 2 == 0 else odd, rest)
        even = torch.cat([x[:1], even], dim=0)
    else:
        even = x[:1]
    out = torch.empty_like(x)
    out[0::2] = even
    out[1::2] = odd
    return out


def fp_batch_inv(x, axis: int = 0):
    """Montgomery batch inversion along `axis`: one Fermat inversion total,
    the forward and reversed scans stacked into one. Zero entries map to
    garbage; callers gate them."""
    x = torch.movedim(x, axis, 0)
    both = _assoc_scan(L.mul, torch.stack([x, torch.flip(x, [0])], dim=1))
    prefix_incl = both[:, 0]
    suffix_incl = torch.flip(both[:, 1], [0])
    total_inv = fp_inv(prefix_incl[-1])
    ones = L.one((1,) + tuple(x.shape[1:-1]), x.device)
    prefix_excl = torch.cat([ones, prefix_incl[:-1]], dim=0)
    suffix_excl = torch.cat([suffix_incl[1:], ones], dim=0)
    inv = L.mul(L.mul(prefix_excl, total_inv), suffix_excl)
    return torch.movedim(inv, 0, axis)


def _fp2_norm(a):
    """a0^2 + a1^2 (both squares in one call)."""
    s = L.sq(a)
    return L.add(s[..., 0, :], s[..., 1, :])


def _fp2_scale_conj(a, ninv):
    """(a0 * ninv, -(a1 * ninv))."""
    m = L.mul(a, ninv.unsqueeze(-2))
    return torch.stack([m[..., 0, :], L.neg(m[..., 1, :])], dim=-2)


def fp2_inv(a):
    """1/(a0 + a1 u) = conj(a) / (a0^2 + a1^2)."""
    return _fp2_scale_conj(a, fp_inv(_fp2_norm(a)))


def fp2_batch_inv(a, axis: int = 0):
    return _fp2_scale_conj(a, fp_batch_inv(_fp2_norm(a), axis=axis))


def fp2_pow_static(a, e: int):
    """a^e for a host exponent: square-and-multiply from one, MSB first
    (the JAX scan's select on a host bit becomes an `if`)."""
    acc = fp2_one(a.shape[:-2], a.device)
    for bit in _bits_msb_first(e):
        acc = fp2_sq(acc)
        if bit:
            acc = fp2_mul(acc, a)
    return acc


# --- Fp6 -------------------------------------------------------------------


def _c(a, i):
    return a[..., i, :, :]


fp6_add = L.add
fp6_sub = L.sub
fp6_neg = L.neg


def fp6_mul(a, b):
    """Fp6 Karatsuba product: the fp6_mul kernel on CUDA tensors, the op
    composition kernels.fp6_mul_plain on CPU ones."""
    return _K.fp6_mul(a, b)


def fp6_sq(a):
    """CH-SQR2 squaring: 2 fp2_sq + 3 fp2_mul (vs 6 muls for generic)."""
    a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
    s2in = fp2_add(fp2_sub(a0, a1), a2)
    sq = fp2_sq(torch.stack([a0, s2in, a2], dim=-3))
    s0, s2, s4 = _c(sq, 0), _c(sq, 1), _c(sq, 2)
    m = fp2_mul(torch.stack([a0, a1], dim=-3), torch.stack([a1, a2], dim=-3))
    d = fp2_add(m, m)  # s1 = 2 a0 a1, s3 = 2 a1 a2
    s1, s3 = _c(d, 0), _c(d, 1)
    xi = fp2_mul_by_xi(torch.stack([s3, s4], dim=-3))
    c01 = fp2_add(xi, torch.stack([s0, s1], dim=-3))
    c2 = fp2_sub(fp2_add(fp2_add(s1, s2), s3), fp2_add(s0, s4))
    return torch.cat([c01, c2.unsqueeze(-3)], dim=-3)


def fp6_mul_by_v(a):
    return torch.stack([fp2_mul_by_xi(_c(a, 2)), _c(a, 0), _c(a, 1)], dim=-3)


def fp6_mul_fp2(a, s):
    """Fp6 x Fp2 scalar: the three coefficient products in one call."""
    return fp2_mul(a, s.unsqueeze(-3))


def fp6_inv(a):
    a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
    sq = fp2_sq(torch.stack([a0, a2, a1], dim=-3))
    m = fp2_mul(torch.stack([a1, a0, a0], dim=-3), torch.stack([a2, a1, a2], dim=-3))
    t0 = fp2_sub(_c(sq, 0), fp2_mul_by_xi(_c(m, 0)))
    t1 = fp2_sub(fp2_mul_by_xi(_c(sq, 1)), _c(m, 1))
    t2 = fp2_sub(_c(sq, 2), _c(m, 2))
    p = fp2_mul(torch.stack([a0, a2, a1], dim=-3), torch.stack([t0, t1, t2], dim=-3))
    d = fp2_add(_c(p, 0), fp2_mul_by_xi(fp2_add(_c(p, 1), _c(p, 2))))
    dinv = fp2_inv(d)
    return fp2_mul(torch.stack([t0, t1, t2], dim=-3), dinv.unsqueeze(-3))


def fp6_zero(shape, device):
    return torch.zeros(tuple(shape) + (3, 2, W), dtype=torch.int32, device=device)


def fp6_one(shape, device):
    o = fp6_zero(shape, device)
    o[..., 0, 0, :] = L.on(L.ONE, device)
    return o


# --- Fp12 ------------------------------------------------------------------


def _h(a, i):
    return a[..., i, :, :, :]


def fp12_mul(a, b):
    """Fp12 Karatsuba product over three Fp6 products: the fp12_mul kernel
    on CUDA tensors, kernels.fp12_mul_plain on CPU ones."""
    return _K.fp12_mul(a, b)


def fp12_sq(a):
    a0, a1 = _h(a, 0), _h(a, 1)
    s = fp6_add(torch.stack([a0, a0]), torch.stack([a1, fp6_mul_by_v(a1)]))
    prod = fp6_mul(
        torch.stack([a0, s[0]], dim=-4), torch.stack([a1, s[1]], dim=-4)
    )
    t, m = _h(prod, 0), _h(prod, 1)
    c0 = fp6_sub(fp6_sub(m, t), fp6_mul_by_v(t))
    return torch.stack([c0, fp6_add(t, t)], dim=-4)


def fp12_cyclotomic_sq(a):
    """Granger-Scott squaring, valid only in the cyclotomic subgroup: the
    fp12_cyclotomic_sq kernel on CUDA tensors,
    kernels.fp12_cyclotomic_sq_plain on CPU ones."""
    return _K.fp12_cyclotomic_sq(a)


def fp12_conj(a):
    return torch.stack([_h(a, 0), fp6_neg(_h(a, 1))], dim=-4)


def fp12_inv(a):
    a0, a1 = _h(a, 0), _h(a, 1)
    sq = fp6_sq(torch.stack([a0, a1]))
    d = fp6_sub(sq[0], fp6_mul_by_v(sq[1]))
    dinv = fp6_inv(d)
    m = fp6_mul(torch.stack([a0, a1], dim=-4), dinv.unsqueeze(-4))
    return torch.stack([_h(m, 0), fp6_neg(_h(m, 1))], dim=-4)


def fp12_select(cond, a, b):
    return torch.where(cond[..., None, None, None, None], a, b)


def fp12_eq(a, b):
    d = L.canon(L.sub(a, b))
    return torch.all(d == 0, dim=-1).all(-1).all(-1).all(-1)


def fp12_zero(shape, device):
    return torch.zeros(tuple(shape) + (2, 3, 2, W), dtype=torch.int32, device=device)


def fp12_one(shape, device):
    o = fp12_zero(shape, device)
    o[..., 0, 0, 0, :] = L.on(L.ONE, device)
    return o


def fp12_is_one(a):
    return fp12_eq(a, fp12_one(a.shape[:-4], a.device))


# Frobenius gamma constants from the oracle's single source of truth.
_GAMMA_J = np.stack([fp2_from_ints(g.c0.n, g.c1.n) for g in _REF_GAMMA])  # (6, 2, W)
# gamma for each (w-slot i, v-slot j), laid out as Fp12; slot (0, 0) is
# never multiplied (idx 0), the rest multiply by gamma_{2j+i}
_GAMMA_12 = np.stack(
    [np.stack([_GAMMA_J[2 * j + i] for j in range(3)]) for i in range(2)]
)  # (2, 3, 2, W)


def fp12_frobenius(a):
    """x -> x^p: conjugate every Fp2 coefficient, multiply by gamma_{2j+i}
    (the five nontrivial products in one stacked fp2_mul)."""
    c = fp2_conj(a)
    g = L.on(_GAMMA_12, a.device)
    flat_c = c.reshape(c.shape[:-4] + (6, 2, W))
    flat_g = g.reshape(6, 2, W)
    prod = fp2_mul(flat_c[..., 1:, :, :], flat_g[1:])
    out = torch.cat([flat_c[..., :1, :, :], prod], dim=-3)
    return out.reshape(a.shape)


def fp12_frobenius_n(a, n: int):
    for _ in range(n):
        a = fp12_frobenius(a)
    return a


from . import kernels as _K  # noqa: E402  (kernels imports this module)

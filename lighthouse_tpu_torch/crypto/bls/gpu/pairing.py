"""Batched optimal-ate pairing for BLS12-381, in PyTorch.

Port of lighthouse_tpu/crypto/bls/tpu/pairing.py, limb for limb:

  * The Miller accumulator T is Jacobian with exception-free step formulas
    (T = [j]Q with 2 <= j < |x| << r never meets the exceptional cases;
    infinite inputs are masked to f = 1 by the final select).
  * Lines are denominator-cleared sparse Fp12 elements (c0, cv, cvw);
    f <- f^2 * line uses the 15-Fp2-mul Karatsuba sparse multiply.
  * The loop over |x| = 0xd201000000010000 is a Python loop over the 63
    post-leading bits: every step runs the fused `miller_dbl_step` kernel,
    the 5 one-bits also `miller_add_step` (kernels.py; on CPU tensors their
    plain versions, the `_dbl_step`/`_add_step` + `mul_by_line` below).
  * Final exponentiation: easy part by conjugate/inverse/Frobenius, hard
    part by the x-chain 3(p^4 - p^2 + 1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3
    (f^(3h) == 1 iff f^h == 1 since gcd(3, r) = 1).
"""

from __future__ import annotations

import torch

from ..constants import BLS_X, P, R
from . import kernels as K
from . import limbs as L
from . import tower as T

W = L.W
_X_ABS = -BLS_X
_X_BITS = bin(_X_ABS)[2:]  # MSB first, leading '1'
BIT_TABLE = [b == "1" for b in _X_BITS[1:]]  # 63 post-leading bits, 5 ones

_HARD = (P**4 - P**2 + 1) // R
assert (
    3 * _HARD == (BLS_X - 1) ** 2 * (BLS_X + P) * (BLS_X**2 + P**2 - 1) + 3
), "BLS12-381 final-exponentiation chain identity failed"


# --- sparse line representation & multiply ---------------------------------
# A line is (c0, cv, cvw): Fp12 value c0 + cv*v + cvw*v*w with each slot Fp2.


def _c3(a, i):
    return a[..., i, :, :]


def _fp6_mul_s2(f6, a, b):
    """Fp6 * (a + b v), a/b in Fp2: 6 Fp2 muls (one stacked call)."""
    d0, d1, d2 = _c3(f6, 0), _c3(f6, 1), _c3(f6, 2)
    m = T.fp2_mul(
        torch.stack([d0, d2, d1, d0, d2, d1], dim=-3),
        torch.stack(torch.broadcast_tensors(a, b, a, b, a, b), dim=-3),
    )
    r0 = T.fp2_add(_c3(m, 0), T.fp2_mul_by_xi(_c3(m, 1)))
    r12 = T.fp2_add(m[..., 2:6:2, :, :], m[..., 3:6:2, :, :])
    return torch.cat([r0.unsqueeze(-3), r12], dim=-3)


def _fp6_mul_s1(f6, c):
    """Fp6 * (c v): 3 Fp2 muls (one call)."""
    m = T.fp2_mul(f6, c.unsqueeze(-3))  # d0 c, d1 c, d2 c
    return torch.stack(
        [T.fp2_mul_by_xi(_c3(m, 2)), _c3(m, 0), _c3(m, 1)], dim=-3
    )


def mul_by_line(f, line):
    """f * (c0 + cv v + cvw v w): Karatsuba on the w split, 15 Fp2 muls."""
    c0, cv, cvw = line
    f0, f1 = f[..., 0, :, :, :], f[..., 1, :, :, :]
    f0, f1 = torch.broadcast_tensors(f0, f1)
    c0, cv, cvw = torch.broadcast_tensors(c0, cv, cvw)
    # t0 = f0 * (c0 + cv v) and s = (f0 + f1) * (c0 + (cv + cvw) v) share
    # one stacked _fp6_mul_s2
    s6 = T.fp6_add(f0, f1)
    cs = T.fp2_add(cv, cvw)
    ts = _fp6_mul_s2(
        torch.stack([f0, s6]), torch.stack([c0, c0]), torch.stack([cv, cs])
    )
    t0, s = ts[0], ts[1]
    t1 = _fp6_mul_s1(f1, cvw)
    r0 = T.fp6_add(t0, T.fp6_mul_by_v(t1))
    r1 = T.fp6_sub(T.fp6_sub(s, t0), t1)
    return torch.stack([r0, r1], dim=-4)


# --- Jacobian accumulator steps (private, exception-free) -------------------


def _jac_double(t):
    """dbl-2009-l on Fp2 Jacobian coords; exception-free for a = 0."""
    x, y, z = _c3(t, 0), _c3(t, 1), _c3(t, 2)
    ab = T.fp2_sq(torch.stack([x, y], dim=-3))
    a, b = _c3(ab, 0), _c3(ab, 1)
    cs = T.fp2_sq(torch.stack([b, T.fp2_add(x, b)], dim=-3))
    c = _c3(cs, 0)
    d = T.fp2_mul_small(T.fp2_sub(T.fp2_sub(_c3(cs, 1), a), c), 2)
    e = T.fp2_mul_small(a, 3)
    f = T.fp2_sq(e)
    x3 = T.fp2_sub(f, T.fp2_mul_small(d, 2))
    m = T.fp2_mul(
        torch.stack([e, T.fp2_mul_small(y, 2)], dim=-3),
        torch.stack([T.fp2_sub(d, x3), z], dim=-3),
    )
    y3 = T.fp2_sub(_c3(m, 0), T.fp2_mul_small(c, 8))
    return torch.stack([x3, y3, _c3(m, 1)], dim=-3)


def _jac_madd(t, q_aff):
    """madd-2007-bl (Jacobian += affine) without exceptional-case handling:
    sound in the Miller ladder where T = [j]Q, 2 <= j, j -+ 1 != 0 mod r."""
    x1, y1, z1 = _c3(t, 0), _c3(t, 1), _c3(t, 2)
    x2, y2 = _c3(q_aff, 0), _c3(q_aff, 1)
    z1z1 = T.fp2_sq(z1)
    m = T.fp2_mul(torch.stack([x2, y2], dim=-3), torch.stack([z1z1, z1], dim=-3))
    u2 = _c3(m, 0)
    s2 = T.fp2_mul(_c3(m, 1), z1z1)
    h = T.fp2_sub(u2, x1)
    hh = T.fp2_sq(h)
    i = T.fp2_mul_small(hh, 4)
    r = T.fp2_mul_small(T.fp2_sub(s2, y1), 2)
    m = T.fp2_mul(torch.stack([h, x1], dim=-3), i.unsqueeze(-3))
    j, v = _c3(m, 0), _c3(m, 1)
    x3 = T.fp2_sub(T.fp2_sub(T.fp2_sq(r), j), T.fp2_mul_small(v, 2))
    m = T.fp2_mul(
        torch.stack([r, y1], dim=-3), torch.stack([T.fp2_sub(v, x3), j], dim=-3)
    )
    y3 = T.fp2_sub(_c3(m, 0), T.fp2_mul_small(_c3(m, 1), 2))
    z3 = T.fp2_sub(T.fp2_sub(T.fp2_sq(T.fp2_add(z1, h)), z1z1), hh)
    return torch.stack([x3, y3, z3], dim=-3)


# --- Miller loop steps ------------------------------------------------------


def _dbl_step(t, xp, yp):
    """Doubling step: T -> 2T plus the tangent line at T evaluated at
    P = (xp, yp) (Fp affine), scaled by 2*Y*Z^3 in Fp2."""
    x, y, z = _c3(t, 0), _c3(t, 1), _c3(t, 2)
    s = T.fp2_sq(t)  # x2, y2, z2
    x2, y2, z2 = _c3(s, 0), _c3(s, 1), _c3(s, 2)
    m = T.fp2_mul(torch.stack([x2, z2], dim=-3), torch.stack([x, z], dim=-3))
    x3, z3 = _c3(m, 0), _c3(m, 1)
    c0 = T.fp2_sub(T.fp2_mul_small(x3, 3), T.fp2_mul_small(y2, 2))
    m = T.fp2_mul(torch.stack([x2, y], dim=-3), torch.stack([z2, z3], dim=-3))
    cv = T.fp2_mul_fp(T.fp2_mul_small(_c3(m, 0), -3), xp)
    cvw = T.fp2_mul_fp(T.fp2_mul_small(_c3(m, 1), 2), yp)
    return _jac_double(t), (c0, cv, cvw)


def _add_step(t, q_aff, xp, yp):
    """Addition step: T -> T + Q plus the chord line through T, Q evaluated
    at P, scaled by D = Z*(X - xq*Z^2) in Fp2."""
    x, y, z = _c3(t, 0), _c3(t, 1), _c3(t, 2)
    xq, yq = _c3(q_aff, 0), _c3(q_aff, 1)
    z2 = T.fp2_sq(z)
    z3 = T.fp2_mul(z2, z)
    m = T.fp2_mul(torch.stack([yq, xq], dim=-3), torch.stack([z3, z2], dim=-3))
    n = T.fp2_sub(y, _c3(m, 0))
    d = T.fp2_mul(z, T.fp2_sub(x, _c3(m, 1)))
    m = T.fp2_mul(torch.stack([n, d], dim=-3), torch.stack([xq, yq], dim=-3))
    c0 = T.fp2_sub(_c3(m, 0), _c3(m, 1))
    cv = T.fp2_neg(T.fp2_mul_fp(n, xp))
    cvw = T.fp2_mul_fp(d, yp)
    return _jac_madd(t, q_aff), (c0, cv, cvw)


def miller_loop(p_aff, p_inf, q_aff, q_inf):
    """Batched optimal-ate Miller loop f_{|x|,Q}(P), conjugated for x < 0.

    p_aff: (..., 2, W) affine G1; q_aff: (..., 2, 2, W) affine G2; *_inf are
    (...,) bool masks. Infinite inputs yield the neutral one."""
    dev = p_aff.device
    xp, yp = p_aff[..., 0, :], p_aff[..., 1, :]
    batch = p_inf.shape
    z0 = T.fp2_one(batch, dev).expand(q_aff[..., 0, :, :].shape)
    t = torch.stack([q_aff[..., 0, :, :], q_aff[..., 1, :, :], z0], dim=-3)
    f = T.fp12_one(batch, dev)
    for bit in BIT_TABLE:
        f, t = K.miller_dbl_step(f, t, xp, yp)
        if bit:
            f, t = K.miller_add_step(f, t, q_aff, xp, yp)
    f = T.fp12_conj(f)  # x < 0
    return T.fp12_select(p_inf | q_inf, T.fp12_one(batch, dev), f)


# --- final exponentiation ---------------------------------------------------


def _pow_x_abs(f):
    """f^|x| in the cyclotomic subgroup: Granger-Scott squarings, and the
    multiply only on the 5 one-bits."""
    acc = f
    for bit in BIT_TABLE:
        acc = T.fp12_cyclotomic_sq(acc)
        if bit:
            acc = T.fp12_mul(acc, f)
    return acc


def final_exponentiation(f):
    """f^(3 * (p^12-1)/r): easy part exactly, hard part via the x-chain.
    With s_0 = f, s_{i+1} = s_i^x * m_i, m_i = conj(s_i) (i = 0, 1),
    frobenius(s_i) (i = 2), one (i = 3, 4); a = s_3; the result is
    s_5 * frob^2(a) * conj(a) * f^2 * f."""
    f = T.fp12_mul(T.fp12_conj(f), T.fp12_inv(f))
    f = T.fp12_mul(T.fp12_frobenius_n(f, 2), f)
    one = T.fp12_one(f.shape[:-4], f.device)
    s, a = f, f
    for i in range(5):
        t = T.fp12_conj(_pow_x_abs(s))  # s^x (x < 0)
        if i < 2:
            m = T.fp12_conj(s)
        elif i == 2:
            m = T.fp12_frobenius(s)
        else:
            m = one
        s = T.fp12_mul(t, m)
        if i == 2:
            a = s
    factors = torch.stack(
        [s, T.fp12_frobenius_n(a, 2), T.fp12_conj(a), T.fp12_cyclotomic_sq(f), f],
        dim=0,
    )
    return fp12_prod(factors, axis=0)


# --- products & pairings ----------------------------------------------------


def fp12_prod(f, axis: int = 0):
    """Product along `axis`: pad to a power of two with ones, then a
    halving reduction of adjacent pairs (the JAX scanned body's front
    half, which is all that reaches the result)."""
    f = torch.movedim(f, axis, 0)
    n = f.shape[0]
    if n == 1:
        return f[0]
    m = 1
    while m < n:
        m *= 2
    if m > n:
        ones = T.fp12_one((m - n,) + tuple(f.shape[1:-4]), f.device)
        f = torch.cat([f, ones], dim=0)
    while f.shape[0] > 1:
        f = T.fp12_mul(f[0::2], f[1::2])
    return f[0]


def pairing(p_aff, p_inf, q_aff, q_inf):
    """Single (batched) pairing e(P, Q)^3: the verifier's Miller loop and
    final exponentiation per row; equal to the cube of the oracle
    pairing."""
    return final_exponentiation(miller_loop(p_aff, p_inf, q_aff, q_inf))


def multi_pairing(p_aff, p_inf, q_aff, q_inf):
    """prod_i e(P_i, Q_i)^3 over the leading axis: batched Miller loops,
    halving product, ONE final exponentiation."""
    f = miller_loop(p_aff, p_inf, q_aff, q_inf)
    return final_exponentiation(fp12_prod(f, axis=0))


def multi_pairing_is_one(p_aff, p_inf, q_aff, q_inf):
    return T.fp12_is_one(multi_pairing(p_aff, p_inf, q_aff, q_inf))

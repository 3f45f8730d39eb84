"""Batched G1/G2 point arithmetic on the limb representation, in PyTorch.

Port of lighthouse_tpu/crypto/bls/tpu/curve.py, limb for limb:

  * Points are stacked homogeneous projective coordinates -- G1 (..., 3, W),
    G2 (..., 3, 2, W); infinity is (0, 1, 0).
  * The group law is the Renes-Costello-Batina complete addition and
    doubling for a = 0 (eprint 2015/1060, algorithms 7 and 9): no
    exceptional cases on these odd-order curves. The independent field
    products of each formula run as one stacked call, the same products
    row for row.
  * `scalar_mul_static` walks a host exponent's bits in Python (the JAX
    `lax.cond` becomes an `if`). The runtime 64-bit weights have two
    ladders: `_scalar_mul_u64_bit`, 64 doublings and 64 selected adds,
    and `scalar_mul_u64_windowed`, a 16-entry table (14 adds) and 15
    steps of 4 doublings and one gathered add. `scalar_mul_u64` is the
    bit ladder, or the windowed one when LIGHTHOUSE_TPU_PALLAS=1 at
    import. The JAX package reads that switch at import to turn on its
    Pallas kernels and the windowed ladder with them; the port's kernels
    are always on (on the card), so here it selects the ladder only. It
    is read once: the stage graphs are keyed on shapes alone, and a
    ladder chosen per call would replay a graph captured with the other.
  * psi(X:Y:Z) = (cx conj(X) : cy conj(Y) : conj(Z)) feeds the G2 subgroup
    check psi(P) == [x]P.
"""

from __future__ import annotations

import os as _os

import numpy as np
import torch

from ..constants import BLS_X, G1_X, G1_Y, G2_X, G2_Y, R
from ..curve_ref import _PSI_CX, _PSI_CY, Point
from ..fields_ref import Fp, Fp2
from . import limbs as L
from . import tower as T

W = L.W


# --- field-ops namespaces ---------------------------------------------------


class FP:
    """Fp coordinate ops for stacked G1 points (..., 3, W)."""

    coord_ndim = 1

    mul = staticmethod(L.mul)
    sq = staticmethod(L.sq)
    is_zero = staticmethod(L.is_zero)

    @staticmethod
    def eq(a, b):
        return torch.all(L.canon(L.sub(a, b)) == 0, dim=-1)

    @staticmethod
    def b3(a):
        """b3 = 3b = 12 for E: y^2 = x^3 + 4 (already normalized input)."""
        return a

    @staticmethod
    def one(shape, device):
        return L.one(shape, device)

    @staticmethod
    def zero(shape, device):
        return L.zeros(shape, device)


class FP2:
    """Fp2 coordinate ops for stacked G2 points (..., 3, 2, W)."""

    coord_ndim = 2

    mul = staticmethod(T.fp2_mul)
    sq = staticmethod(T.fp2_sq)
    is_zero = staticmethod(T.fp2_is_zero)
    eq = staticmethod(T.fp2_eq)
    one = staticmethod(T.fp2_one)
    zero = staticmethod(T.fp2_zero)

    @staticmethod
    def b3(a):
        """b3 = 12(1 + u) for E': the xi factor after mul_small(a, 12)."""
        return T.fp2_mul_by_xi(a)


def _coord(p, i, F):
    return p[(Ellipsis, i) + (slice(None),) * F.coord_ndim]


def _stk(xs, F):
    """Stack field elements on a new coordinate axis."""
    return torch.stack(xs, dim=-(F.coord_ndim + 1))


def _batch(p, F):
    return p.shape[: p.ndim - F.coord_ndim - 1]


def point_select(cond, a, b, F):
    return torch.where(cond[(Ellipsis,) + (None,) * (F.coord_ndim + 1)], a, b)


def is_infinity(p, F):
    return F.is_zero(_coord(p, 2, F))


def infinity(F, shape, device):
    """Projective infinity (0, 1, 0)."""
    return _stk(
        [F.zero(shape, device), F.one(shape, device), F.zero(shape, device)], F
    )


# --- complete group law (RCB 2015, a = 0) ----------------------------------


def add(p, q, F):
    """Complete projective addition (RCB algorithm 7, a = 0): 12M + 2
    b3-mults as three stacked multiplies."""
    p, q = torch.broadcast_tensors(p, q)
    x1, y1, z1 = _coord(p, 0, F), _coord(p, 1, F), _coord(p, 2, F)
    x2, y2, z2 = _coord(q, 0, F), _coord(q, 1, F), _coord(q, 2, F)
    m0 = F.mul(p, q)  # t0 = x1 x2, t1 = y1 y2, t2 = z1 z2
    t0, t1, t2 = _coord(m0, 0, F), _coord(m0, 1, F), _coord(m0, 2, F)
    s = L.add(  # x1+y1, y1+z1, x1+z1 and the same for q
        torch.stack([_stk([x1, y1, x1], F), _stk([x2, y2, x2], F)]),
        torch.stack([_stk([y1, z1, z1], F), _stk([y2, z2, z2], F)]),
    )
    m1 = F.mul(s[0], s[1])
    # t3 = x1 y2 + x2 y1, t4 = y1 z2 + y2 z1, y3 = x1 z2 + x2 z1
    v = L.sub(m1, L.add(_stk([t0, t1, t0], F), _stk([t1, t2, t2], F)))
    t3, t4, y3 = _coord(v, 0, F), _coord(v, 1, F), _coord(v, 2, F)
    # x3 = 3 t0; t2 = b3 t2; y3 = b3 y3 (mul_small then the xi factor)
    n = L._norm(_stk([t0 * 3, t2 * 12, y3 * 12], F))
    x3 = _coord(n, 0, F)
    b = F.b3(torch.stack([_coord(n, 1, F), _coord(n, 2, F)]))
    t2, y3 = b[0], b[1]
    zt = L.add(torch.stack([t1, t1]), torch.stack([t2, -t2]))
    z3, t1 = zt[0], zt[1]
    m2 = F.mul(_stk([t3, t4, y3, t1, z3, x3], F), _stk([t1, y3, x3, z3, t4, t3], F))
    mm = [_coord(m2, i, F) for i in range(6)]
    return L.add(_stk([mm[0], mm[2], mm[4]], F), _stk([-mm[1], mm[3], mm[5]], F))


def double(p, F):
    """Complete projective doubling (RCB algorithm 9, a = 0): 6M + 2S + 1
    b3-mult."""
    x, y, z = _coord(p, 0, F), _coord(p, 1, F), _coord(p, 2, F)
    sq = F.sq(_stk([y, z], F))
    t0, zz = _coord(sq, 0, F), _coord(sq, 1, F)
    m = F.mul(_stk([y, x], F), _stk([z, y], F))
    t1, xy = _coord(m, 0, F), _coord(m, 1, F)
    n = L._norm(_stk([t0 * 8, zz * 12], F))
    z3 = _coord(n, 0, F)
    t2 = F.b3(_coord(n, 1, F))
    m = F.mul(_stk([t2, t1], F), _stk([z3, z3], F))
    x3, z3 = _coord(m, 0, F), _coord(m, 1, F)
    y3 = L.add(t0, t2)
    t0 = L.sub(t0, L.mul_small(t2, 3))
    m = F.mul(_stk([t0, t0], F), _stk([y3, xy], F))
    out = L.add(_stk([_coord(m, 1, F), _coord(m, 0, F)], F),
                _stk([_coord(m, 1, F), x3], F))
    return _stk([_coord(out, 0, F), _coord(out, 1, F), z3], F)


def add_mixed(p, q_aff, q_inf, F):
    """Projective + affine: q_aff = (x2, y2) stacked (..., 2, ...), q_inf a
    bool mask; q lifted to projective, then the complete law."""
    return add(p, from_affine(q_aff, q_inf, F), F)


def neg(p, F):
    x, y, z = _coord(p, 0, F), _coord(p, 1, F), _coord(p, 2, F)
    return _stk([x, L.neg(y), z], F)


def eq(p, q, F):
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1, with
    infinity equal only to infinity."""
    p, q = torch.broadcast_tensors(p, q)
    x1, y1, z1 = _coord(p, 0, F), _coord(p, 1, F), _coord(p, 2, F)
    x2, y2, z2 = _coord(q, 0, F), _coord(q, 1, F), _coord(q, 2, F)
    m = F.mul(_stk([x1, x2, y1, y2], F), _stk([z2, z1, z2, z1], F))
    same = F.eq(_stk([_coord(m, 0, F), _coord(m, 2, F)], F),
                _stk([_coord(m, 1, F), _coord(m, 3, F)], F))
    same_x, same_y = same[..., 0], same[..., 1]
    p_inf, q_inf = is_infinity(p, F), is_infinity(q, F)
    return (p_inf & q_inf) | (~p_inf & ~q_inf & same_x & same_y)


# --- scalar multiplication --------------------------------------------------


def scalar_mul_static(p, e: int, F):
    """[e]P for a host e >= 0: MSB-first double-and-add, the add only on
    one-bits (a Python branch on the host bit)."""
    if e == 0:
        return infinity(F, _batch(p, F), p.device)
    acc = p
    for b in bin(e)[3:]:
        acc = double(acc, F)
        if b == "1":
            acc = add(acc, p, F)
    return acc


def scalar_bits(scalars) -> torch.Tensor:
    """(..., 2) weights (column 0 the high word, each in [0, 2^32), int64)
    -> (64, ...) bool, MSB first."""
    s = scalars.to(torch.int64)
    shifts = torch.arange(31, -1, -1, device=s.device, dtype=torch.int64)
    bits = (s.unsqueeze(-1) >> shifts) & 1  # (..., 2, 32)
    bits = bits.reshape(s.shape[:-1] + (64,))
    return torch.movedim(bits, -1, 0) != 0


def scalar_mul_u64(p, scalars, F):
    """[s]P for runtime 64-bit scalars given as (..., 2) words (hi, lo):
    a 64-iteration MSB-first double-and-add ladder with a per-row select."""
    bits = scalar_bits(scalars)
    acc = infinity(F, _batch(p, F), p.device)
    for k in range(64):
        acc = double(acc, F)
        acc = point_select(bits[k], add(acc, p, F), acc, F)
    return acc


def scalar_digits(scalars, window: int = 4) -> torch.Tensor:
    """(..., 2) weights (column 0 the high word, each in [0, 2^32), int64)
    -> (64 / window, ...) int64 digits, MSB first; masked after the
    shift, so no bit of another digit leaks in."""
    assert 64 % window == 0 and 32 % window == 0
    s = scalars.to(torch.int64)
    shifts = torch.arange(32 - window, -1, -window, device=s.device,
                          dtype=torch.int64)
    digits = (s.unsqueeze(-1) >> shifts) & ((1 << window) - 1)  # (..., 2, 32/w)
    digits = digits.reshape(s.shape[:-1] + (64 // window,))
    return torch.movedim(digits, -1, 0)


def scalar_mul_u64_windowed(p, scalars, F, window: int = 4):
    """[s]P via a fixed-window ladder, as the JAX one computes it: the
    table [0]P .. [2^window - 1]P built by sequential complete adds, then
    per digit after the first `window` doublings and one add of the
    gathered entry. The complete group law makes the infinity entry and
    zero digits exception-free, so no select is needed."""
    digits = scalar_digits(scalars, window)
    batch = _batch(p, F)
    tbl = [infinity(F, batch, p.device), p]
    for _ in range(2, 1 << window):
        tbl.append(add(tbl[-1], p, F))
    table = torch.stack(tbl, dim=0)  # (2^window,) + batch + point dims
    tail = (1,) * (F.coord_ndim + 1)

    def gather(digit):
        idx = digit.reshape((1,) + tuple(digit.shape) + tail)
        return torch.gather(table, 0, idx.expand((1,) + tuple(table.shape[1:])))[0]

    acc = gather(digits[0])
    for digit in digits[1:]:
        for _ in range(window):
            acc = double(acc, F)
        acc = add(acc, gather(digit), F)
    return acc


# LIGHTHOUSE_TPU_PALLAS=1 at import selects the windowed ladder (the JAX
# package's switch, which also turns its Pallas kernels on); the bit
# ladder stays reachable as `_scalar_mul_u64_bit` either way.
_scalar_mul_u64_bit = scalar_mul_u64
WINDOWED_LADDER = _os.environ.get("LIGHTHOUSE_TPU_PALLAS") == "1"
if WINDOWED_LADDER:
    def scalar_mul_u64(p, scalars, F):  # noqa: F811
        return scalar_mul_u64_windowed(p, scalars, F)


# --- cross-set reductions ---------------------------------------------------


def sum_points(p, F):
    """EC sum over axis 0: pad to a power of two with infinity, then add
    adjacent pairs until one is left (the JAX halving body's front half)."""
    n = p.shape[0]
    m = 1
    while m < n:
        m *= 2
    batch = tuple(p.shape[1 : p.ndim - F.coord_ndim - 1])
    if m > n:
        p = torch.cat([p, infinity(F, (m - n,) + batch, p.device)], dim=0)
    while p.shape[0] > 1:
        p = add(p[0::2], p[1::2], F)
    return p[0]


# --- affine conversion ------------------------------------------------------


def to_affine_g1(p):
    """Batched projective -> affine for G1 (one Fermat inversion total).
    Infinity maps to (0, 0) + mask."""
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    inf = L.is_zero(z)
    z_safe = L.select(inf, L.one(z.shape[:-1], z.device), z)
    zinv = T.fp_batch_inv(z_safe.reshape(-1, W), axis=0).reshape(z.shape)
    a = L.mul(p[..., :2, :], zinv.unsqueeze(-2))
    return torch.where(inf[..., None, None], torch.zeros_like(a), a), inf


def to_affine_g2(p):
    z = p[..., 2, :, :]
    inf = T.fp2_is_zero(z)
    z_safe = T.fp2_select(inf, T.fp2_one(z.shape[:-2], z.device), z)
    zinv = T.fp2_batch_inv(z_safe.reshape(-1, 2, W), axis=0).reshape(z.shape)
    a = T.fp2_mul(p[..., :2, :, :], zinv.unsqueeze(-3))
    return torch.where(inf[..., None, None, None], torch.zeros_like(a), a), inf


def from_affine(aff, inf, F):
    """(..., 2, coord) affine + inf mask -> projective; infinity -> (0, 1, 0)."""
    shape, dev = inf.shape, aff.device
    proj = _stk([_coord(aff, 0, F), _coord(aff, 1, F), F.one(shape, dev)], F)
    return point_select(inf, infinity(F, shape, dev), proj, F)


# --- host <-> device --------------------------------------------------------


def g1_pack(points) -> np.ndarray:
    """Oracle affine G1 points -> (n, 3, W) projective host array."""
    out = np.zeros((len(points), 3, W), np.int32)
    for i, pt in enumerate(points):
        if pt.inf:
            out[i, 1] = L.to_limbs(1)
        else:
            out[i, 0] = L.to_limbs(pt.x.n)
            out[i, 1] = L.to_limbs(pt.y.n)
            out[i, 2] = L.to_limbs(1)
    return out


def g2_pack(points) -> np.ndarray:
    """Oracle affine G2 points -> (n, 3, 2, W) projective host array."""
    out = np.zeros((len(points), 3, 2, W), np.int32)
    for i, pt in enumerate(points):
        if pt.inf:
            out[i, 1, 0] = L.to_limbs(1)
        else:
            out[i, 0, 0] = L.to_limbs(pt.x.c0.n)
            out[i, 0, 1] = L.to_limbs(pt.x.c1.n)
            out[i, 1, 0] = L.to_limbs(pt.y.c0.n)
            out[i, 1, 1] = L.to_limbs(pt.y.c1.n)
            out[i, 2, 0] = L.to_limbs(1)
    return out


def g1_unpack(p) -> list:
    """(n, 3, W) projective tensor -> oracle affine points (host)."""
    aff, inf = to_affine_g1(p)
    aff, inf = aff.cpu().numpy(), inf.cpu().numpy()
    return [
        Point(Fp(0), Fp(0), True) if inf[i]
        else Point(Fp(L.to_fp_int(aff[i, 0])), Fp(L.to_fp_int(aff[i, 1])))
        for i in range(aff.shape[0])
    ]


def g2_unpack(p) -> list:
    aff, inf = to_affine_g2(p)
    aff, inf = aff.cpu().numpy(), inf.cpu().numpy()
    out = []
    for i in range(aff.shape[0]):
        if inf[i]:
            out.append(Point(Fp2.zero(), Fp2.zero(), True))
        else:
            x = Fp2(L.to_fp_int(aff[i, 0, 0]), L.to_fp_int(aff[i, 0, 1]))
            y = Fp2(L.to_fp_int(aff[i, 1, 0]), L.to_fp_int(aff[i, 1, 1]))
            out.append(Point(x, y))
    return out


# --- psi endomorphism & subgroup checks ------------------------------------

_PSI_C = np.stack(
    [T.fp2_from_ints(_PSI_CX.c0.n, _PSI_CX.c1.n),
     T.fp2_from_ints(_PSI_CY.c0.n, _PSI_CY.c1.n)]
)  # (2, 2, W): cx, cy

_X_ABS = -BLS_X


def psi(p):
    """Projective psi: (cx conj(X), cy conj(Y), conj(Z))."""
    c = T.fp2_conj(p)
    xy = T.fp2_mul(c[..., :2, :, :], L.on(_PSI_C, p.device))
    return torch.cat([xy, c[..., 2:, :, :]], dim=-3)


def g2_subgroup_check(p) -> torch.Tensor:
    """P in G2 iff psi(P) == [x]P (x < 0: [x]P = -[|x|]P)."""
    xp = neg(scalar_mul_static(p, _X_ABS, FP2), FP2)
    return eq(psi(p), xp, FP2) | is_infinity(p, FP2)


def g1_subgroup_check(p) -> torch.Tensor:
    """Definitional [r]P == O."""
    return is_infinity(scalar_mul_static(p, R, FP), FP)


def on_curve_g1(p) -> torch.Tensor:
    """Y^2 Z == X^3 + 4 Z^3 (projective form); infinity passes. The three
    squares, then the three products, each in one call."""
    sq = L.sq(p)  # X^2, Y^2, Z^2
    m = L.mul(torch.stack([sq[..., 1, :], sq[..., 0, :], sq[..., 2, :]], dim=-2),
              torch.stack([p[..., 2, :], p[..., 0, :], p[..., 2, :]], dim=-2))
    lhs, x3, z3 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return L.eq(lhs, L.add(x3, L.mul_small(z3, 4))) | is_infinity(p, FP)


def on_curve_g2(p) -> torch.Tensor:
    """Y^2 Z == X^3 + (4 + 4u) Z^3; infinity passes."""
    sq = T.fp2_sq(p)  # X^2, Y^2, Z^2
    z = p[..., 2, :, :]
    m = T.fp2_mul(
        torch.stack([sq[..., 2, :, :], sq[..., 1, :, :], sq[..., 0, :, :]], dim=-3),
        torch.stack([z, z, p[..., 0, :, :]], dim=-3),
    )
    b = T.fp2_mul_by_xi(T.fp2_mul_small(m[..., 0, :, :], 4))
    rhs = T.fp2_add(m[..., 2, :, :], b)
    return T.fp2_eq(m[..., 1, :, :], rhs) | is_infinity(p, FP2)


# --- generators (host arrays) -----------------------------------------------

G1_GEN = np.stack([L.to_limbs(G1_X), L.to_limbs(G1_Y), L.to_limbs(1)])  # (3, W)
G2_GEN = np.stack(
    [T.fp2_from_ints(*G2_X), T.fp2_from_ints(*G2_Y), T.fp2_from_ints(1, 0)]
)  # (3, 2, W)

"""Pure-Python optimal-ate pairing for BLS12-381.

Oracle for the GPU pairing (lighthouse_tpu_torch/crypto/bls/gpu/pairing.py);
a copy of lighthouse_tpu/crypto/bls/pairing_ref.py.
Reproduces the semantics of blst's pairing as used by
crypto/bls/src/impls/blst.rs:114-116 (`verify_multiple_aggregate_signatures`):
a product of Miller loops followed by ONE shared final exponentiation.

The Miller loop runs over the M-twist E2'(Fp2); line evaluations are kept in
their sparse Fp12 form (three non-zero Fp2 slots), the same layout the device
kernels use. Lines are scaled by w^3 — a constant in a proper subfield, which
the easy part of the final exponentiation annihilates.
"""

from __future__ import annotations

from .constants import BLS_X, P, R
from .curve_ref import Point
from .fields_ref import Fp, Fp2, Fp6, Fp12

_X_ABS = -BLS_X  # 0xd201000000010000, x is negative for BLS12-381
_X_BITS = bin(_X_ABS)[2:]


def _line(lam: Fp2, px_neg_lam: Fp2, a: Fp2, py: Fp) -> Fp12:
    """Sparse line  (lam*x_T - y_T)  +  (-lam*x_P) v  +  y_P v w.

    `a` = lam*x_T - y_T, `px_neg_lam` = -lam * x_P (x_P lifted to Fp2),
    `py` = y_P embedded into the v*w slot.
    """
    c0 = Fp6(a, px_neg_lam, Fp2.zero())
    c1 = Fp6(Fp2.zero(), Fp2(py, Fp.zero()), Fp2.zero())
    return Fp12(c0, c1)


def miller_loop(p: Point, q: Point) -> Fp12:
    """Optimal ate Miller loop f_{|x|,Q}(P), conjugated for x < 0.

    p: affine G1 point (coords in Fp), q: affine G2 point (coords in Fp2).
    Either at infinity yields the neutral Fp12 one (so it contributes
    nothing to a pairing product — matching blst's aggregate semantics).
    """
    if p.inf or q.inf:
        return Fp12.one()
    px2 = Fp2(p.x, Fp.zero())
    f = Fp12.one()
    t = q
    for bit in _X_BITS[1:]:
        # doubling step
        lam = (t.x * t.x) * 3 * (t.y + t.y).inv()
        a = lam * t.x - t.y
        f = f.sq() * _line(lam, -(lam * px2), a, p.y)
        t = t.double()
        if bit == "1":
            lam = (q.y - t.y) * (q.x - t.x).inv()
            a = lam * q.x - q.y
            f = f * _line(lam, -(lam * px2), a, p.y)
            t = t + q
    return f.conj()  # x < 0


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12 - 1) / r). Easy part by Frobenius; hard part by integer pow
    (oracle clarity — the device path uses the x-based addition chain and is
    differentially tested against this)."""
    # easy: f^(p^6 - 1) then ^(p^2 + 1)
    f = f.conj() * f.inv()
    f = f.frobenius(2) * f
    # hard: ^((p^4 - p^2 + 1) / r)
    e = (P**4 - P**2 + 1) // R
    return f.pow(e)


def pairing(p: Point, q: Point) -> Fp12:
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: list[tuple[Point, Point]]) -> Fp12:
    """prod_i e(P_i, Q_i) with one shared final exponentiation — the
    random-linear-combination batch-verify core (blst.rs:114-116)."""
    f = Fp12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)

"""Pure-Python BLS12-381 field towers: Fp, Fp2, Fp6, Fp12.

This is the *oracle* implementation: slow, obviously-correct big-int
arithmetic used (a) as the CPU fallback backend and (b) as the differential
test target for the GPU limb code in lighthouse_tpu_torch/crypto/bls/gpu/.

Tower construction (matching blst / the pairing-friendly-curves draft):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

Reference behavior being reproduced: the arithmetic underneath
crypto/bls/src/impls/blst.rs (the blst C/assembly library).
"""

from __future__ import annotations

from .constants import P


class Fp:
    __slots__ = ("n",)
    degree = 1

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return Fp(self.n + o.n)

    def __sub__(self, o):
        return Fp(self.n - o.n)

    def __mul__(self, o):
        return Fp(self.n * o.n)

    def __neg__(self):
        return Fp(-self.n)

    def __eq__(self, o):
        return isinstance(o, Fp) and self.n == o.n

    def __hash__(self):
        return hash(("Fp", self.n))

    def __repr__(self):
        return f"Fp(0x{self.n:x})"

    def inv(self) -> "Fp":
        if self.n == 0:
            raise ZeroDivisionError("Fp inverse of zero")
        return Fp(pow(self.n, -1, P))  # the inverse a^(p-2), by Euclid

    def pow(self, e: int) -> "Fp":
        return Fp(pow(self.n, e, P))

    def sqrt(self):
        """Square root for p = 3 mod 4; returns None if not a QR."""
        c = pow(self.n, (P + 1) // 4, P)
        return Fp(c) if c * c % P == self.n else None

    def is_zero(self) -> bool:
        return self.n == 0

    def sgn0(self) -> int:
        return self.n & 1

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)


class Fp2:
    """c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")
    degree = 2

    def __init__(self, c0: int | Fp, c1: int | Fp):
        self.c0 = c0 if isinstance(c0, Fp) else Fp(c0)
        self.c1 = c1 if isinstance(c1, Fp) else Fp(c1)

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp2(Fp(self.c0.n * o), Fp(self.c1.n * o))
        # Karatsuba: (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + ((a0+a1)(b0+b1) - a0b0 - a1b1) u
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(t0 - t1, t2 - t0 - t1)

    def sq(self):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        t = self.c0 * self.c1
        return Fp2((self.c0 + self.c1) * (self.c0 - self.c1), t + t)

    def __eq__(self, o):
        return isinstance(o, Fp2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fp2", self.c0.n, self.c1.n))

    def __repr__(self):
        return f"Fp2(0x{self.c0.n:x}, 0x{self.c1.n:x})"

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def inv(self):
        # 1/(a0 + a1 u) = conj / (a0^2 + a1^2)
        t = (self.c0 * self.c0 + self.c1 * self.c1).inv()
        return Fp2(self.c0 * t, -self.c1 * t)

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        out, base = Fp2.one(), self
        while e:
            if e & 1:
                out = out * base
            base = base.sq()
            e >>= 1
        return out

    def mul_by_u(self):
        return Fp2(-self.c1, self.c0)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def sgn0(self) -> int:
        # RFC 9380 sgn0 for m = 2.
        sign_0 = self.c0.n & 1
        zero_0 = self.c0.n == 0
        sign_1 = self.c1.n & 1
        return sign_0 | (zero_0 & sign_1)

    def sqrt(self):
        """Square root in Fp2 via the complex method (p = 3 mod 4)."""
        if self.c1.is_zero():
            s = self.c0.sqrt()
            if s is not None:
                return Fp2(s, Fp.zero())
            # sqrt(c0) = sqrt(-c0) * u since u^2 = -1
            s = (-self.c0).sqrt()
            return Fp2(Fp.zero(), s) if s is not None else None
        # norm = c0^2 + c1^2; alpha = sqrt(norm); delta = (c0 + alpha)/2
        alpha = (self.c0 * self.c0 + self.c1 * self.c1).sqrt()
        if alpha is None:
            return None
        inv2 = Fp((P + 1) // 2)
        delta = (self.c0 + alpha) * inv2
        x0 = delta.sqrt()
        if x0 is None:
            delta = (self.c0 - alpha) * inv2
            x0 = delta.sqrt()
            if x0 is None:
                return None
        x1 = self.c1 * inv2 * x0.inv()
        cand = Fp2(x0, x1)
        return cand if cand.sq() == self else None

    @classmethod
    def zero(cls):
        return cls(0, 0)

    @classmethod
    def one(cls):
        return cls(1, 0)


XI = Fp2(1, 1)  # the Fp6 non-residue


def _mul_by_xi(a: Fp2) -> Fp2:
    # (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
    return Fp2(a.c0 - a.c1, a.c0 + a.c1)


class Fp6:
    """c0 + c1 v + c2 v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = _mul_by_xi((a1 + a2) * (b1 + b2) - t1 - t2) + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + _mul_by_xi(t2)
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def sq(self):
        return self * self

    def __eq__(self, o):
        if not isinstance(o, Fp6):
            return NotImplemented
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash(("Fp6", self.c0, self.c1, self.c2))

    def __repr__(self):
        return f"Fp6({self.c0}, {self.c1}, {self.c2})"

    def mul_by_v(self):
        return Fp6(_mul_by_xi(self.c2), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.sq() - _mul_by_xi(a1 * a2)
        t1 = _mul_by_xi(a2.sq()) - a0 * a1
        t2 = a1.sq() - a0 * a2
        d = (a0 * t0 + _mul_by_xi(a2 * t1) + _mul_by_xi(a1 * t2)).inv()
        return Fp6(t0 * d, t1 * d, t2 * d)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    @classmethod
    def zero(cls):
        return cls(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @classmethod
    def one(cls):
        return cls(Fp2.one(), Fp2.zero(), Fp2.zero())


class Fp12:
    """c0 + c1 w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
        return Fp12(t0 + t1.mul_by_v(), c1)

    def sq(self):
        # (c0 + c1 w)^2 = c0^2 + v c1^2 + 2 c0 c1 w
        t = self.c0 * self.c1
        c0 = (self.c0 + self.c1) * (self.c0 + self.c1.mul_by_v()) - t - t.mul_by_v()
        return Fp12(c0, t + t)

    def __eq__(self, o):
        if not isinstance(o, Fp12):
            return NotImplemented
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fp12", self.c0, self.c1))

    def __repr__(self):
        return f"Fp12({self.c0}, {self.c1})"

    def conj(self):
        """Conjugation = Frobenius^6 (inverse for cyclotomic elements)."""
        return Fp12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0.sq() - self.c1.sq().mul_by_v()).inv()
        return Fp12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        out, base = Fp12.one(), self
        while e:
            if e & 1:
                out = out * base
            base = base.sq()
            e >>= 1
        return out

    def frobenius(self, n: int = 1):
        """x -> x^(p^n)."""
        out = self
        for _ in range(n):
            out = _frobenius_once(out)
        return out

    def is_one(self):
        return self == Fp12.one()

    @classmethod
    def one(cls):
        return cls(Fp6.one(), Fp6.zero())

    @classmethod
    def zero(cls):
        return cls(Fp6.zero(), Fp6.zero())


# Frobenius coefficients: gamma_{1,j} = xi^(j (p-1)/6) for j = 1..5, computed
# at import time from the primary parameters (no hard-coded magic numbers).
# Single source of truth -- the GPU tower imports these (FROB_GAMMA).
FROB_GAMMA = [XI.pow(j * (P - 1) // 6) for j in range(6)]
_FROB_GAMMA = FROB_GAMMA


def _frobenius_once(x: Fp12) -> Fp12:
    g = _FROB_GAMMA

    def f2(a: Fp2, j: int) -> Fp2:
        return a.conj() * g[j]

    c0 = Fp6(x.c0.c0.conj(), f2(x.c0.c1, 2), f2(x.c0.c2, 4))
    c1 = Fp6(f2(x.c1.c0, 1), f2(x.c1.c1, 3), f2(x.c1.c2, 5))
    return Fp12(c0, c1)

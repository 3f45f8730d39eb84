"""Fp arithmetic for BLS12-381 on 12-bit signed int32 limbs, in PyTorch.

Port of lighthouse_tpu/crypto/bls/tpu/limbs.py. The representation is the
same, limb for limb, so every function here returns the same int32 tensor
as its JAX counterpart on the same input:

  * 12-bit limbs in int32 lanes; a schoolbook column sum (35 products of
    <= 2^24 each < 2^29.2) never overflows, and up to three raw column
    vectors may be combined before one shared reduction (the Fp2 Karatsuba
    in tower.py relies on that).
  * Lazy carries: three data-parallel shift/add rounds bring any int32
    column vector to limbs in [-1, 2^12].
  * Reduction folds the limbs above position 32 with the constant matrix
    FOLD_R[j] = limbs(2^(12*(32+j)) mod p).
  * Working width W = 35; the lazy form is limbs in [-1, 2^12],
    |value| < 2^397, congruent mod p. `canon` gives the exact residue.

Two things differ from the JAX text, neither in the result:

  * Integer contractions are written as broadcast multiply + int32 sum:
    CUDA has no int32 matmul, and `torch.sum` of int32 returns int64 unless
    told otherwise. Column sums are exact integers, so order is free.
  * `mul` and `sq` go through the wrappers in kernels.py: a hand-written
    CUDA kernel for a CUDA tensor, the plain version below for a CPU one.

Functions broadcast over leading batch axes (limbs last) and allocate on
the device of their inputs. Constant tables live on the host as numpy and
are copied once per device (`on`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import P

BITS = 12
NLIMBS = 32  # canonical width: 384 bits >= 381
W = NLIMBS + 3  # working width == carry3-output width of a fold round
BASE = 1 << BITS
MASK = BASE - 1


def to_limbs(x: int, width: int = W) -> np.ndarray:
    """Host: python int in [0, 2^(BITS*width)) -> int32[width]."""
    assert 0 <= x < (1 << (BITS * width))
    out = np.empty(width, np.int32)
    for i in range(width):
        out[i] = x & MASK
        x >>= BITS
    return out


def to_int(a) -> int:
    """Host: limb vector (lazy/signed ok) -> exact python int value."""
    a = np.asarray(a)
    val = 0
    for i in reversed(range(a.shape[-1])):
        val = (val << BITS) + int(a[i])
    return val


# --- host constant tables (numpy; `on` copies them to a device) ------------

_N_FOLD_ROWS = 2 * W + 6 - NLIMBS  # 44: the widest fold input
FOLD_R = np.stack(
    [to_limbs(pow(2, BITS * (NLIMBS + j), P)) for j in range(_N_FOLD_ROWS)]
).astype(np.int32)  # (44, W); entries in [0, 2^12)
_FOLD_LO = np.ascontiguousarray(FOLD_R[:, :NLIMBS])  # (44, 32), what folds read
P_LIMBS = to_limbs(P)
_P_HI_LIMBS = to_limbs(P << BITS)  # p * 2^BITS, canon's split quotient
_C_SHIFT = to_limbs(P << 14)  # canon's positivity shift, p * 2^14
_KP = np.stack([to_limbs(k * P) for k in range(3)]).astype(np.int32)
ZERO = np.zeros((W,), np.int32)
ONE = to_limbs(1)
# Toeplitz gather: TOEP_IDX[k, i] selects a_pad[k - i + W], so that the
# product columns are one gather and one multiply-sum.
TOEP_IDX = (np.add.outer(np.arange(2 * W - 1), -np.arange(W)) + W).astype(
    np.int64
)

_DEV_CACHE: dict = {}


def on(arr: np.ndarray, device) -> torch.Tensor:
    """The module constant `arr` as a tensor on `device`, copied once."""
    key = (id(arr), str(device))
    t = _DEV_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(arr).to(device)
        _DEV_CACHE[key] = t
    return t


def one(shape, device) -> torch.Tensor:
    return on(ONE, device).expand(tuple(shape) + (W,))


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (W,), dtype=torch.int32, device=device)


# --- carries, folds, reduction ---------------------------------------------


def carry_round(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry round; output one limb wider. x & MASK equals
    x - ((x >> 12) << 12) for two's complement, so signed limbs are exact."""
    out = F.pad(x & MASK, (0, 1))
    out[..., 1:] += x >> BITS
    return out


def carry3(x: torch.Tensor) -> torch.Tensor:
    """Three parallel rounds: |entries| < 2^31 -> limbs in [-1, 2^12]."""
    return carry_round(carry_round(carry_round(x)))


def _fold_round(x: torch.Tensor) -> torch.Tensor:
    """Contract limbs above NLIMBS with FOLD_R and carry. Output width W."""
    hi = x[..., NLIMBS:]
    k = hi.shape[-1]
    assert k <= _N_FOLD_ROWS
    fold = on(_FOLD_LO, x.device)[:k]
    acc = x[..., :NLIMBS] + (hi.unsqueeze(-1) * fold).sum(-2, dtype=torch.int32)
    return carry3(acc)


def _truncate(x: torch.Tensor) -> torch.Tensor:
    return x[..., :W]


def reduce_columns(cols: torch.Tensor) -> torch.Tensor:
    """Signed product columns (width <= 2W-1, |entries| < 2^31) -> lazy
    limbs (..., W), congruent mod p."""
    x = carry3(cols)
    x = _fold_round(x)
    x = _fold_round(x)
    return _truncate(x)


def mul_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns (..., W) x (..., W) -> (..., 2W-1) as a
    Toeplitz gather and a multiply-sum. Up to three column vectors may be
    combined additively before one shared `reduce_columns`."""
    a, b = torch.broadcast_tensors(a, b)
    a_pad = F.pad(a, (W, W - 1))
    t = a_pad[..., on(TOEP_IDX, a.device)]  # (..., 2W-1, W)
    return (t * b.unsqueeze(-2)).sum(-1, dtype=torch.int32)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fp multiply: lazy in, lazy out (the fp_mul kernel on CUDA)."""
    return _K.fp_mul(a, b)


def sq(a: torch.Tensor) -> torch.Tensor:
    """Fp square, bit-identical to mul(a, a) (the fp_sq kernel on CUDA)."""
    return _K.fp_sq(a)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Renormalize small-column results back to the lazy invariant."""
    return _truncate(_fold_round(carry3(x)))


# Add/sub/neg skip the pre-carry: raw sums of lazy vectors stay far under
# int32 through one fold round, which is the whole normalization.


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fold_round(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fold_round(a - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _fold_round(-a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small integer constant, |k| <= 64."""
    assert abs(k) <= 64
    return _norm(a * k)


def lincomb(terms) -> torch.Tensor:
    """sum(k_i * a_i) for small int constants with one normalization;
    sum(|k_i|) <= 64."""
    acc = None
    total = 0
    for a, k in terms:
        total += abs(k)
        t = a * k
        acc = t if acc is None else acc + t
    assert total <= 64
    return _norm(acc)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Branchless limb select; cond is (...,) bool broadcast over limbs."""
    return torch.where(cond[..., None], a, b)


# --- exact canonicalization (boundary-only) --------------------------------


def _scan_carry(x: torch.Tensor):
    """Exact sequential carry: -> (limbs in [0, 2^BITS), signed carry_out)."""
    c = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    ys = []
    for i in range(x.shape[-1]):
        tot = x[..., i] + c
        c = tot >> BITS
        ys.append(tot & MASK)
    return torch.stack(ys, dim=-1), c


def _geq(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Lexicographic x >= m for canonical limb vectors: compare at the
    most-significant differing limb (equal vectors report True)."""
    diff = x - m
    nz = (diff != 0).to(torch.uint8)
    w = x.shape[-1]
    msd = (w - 1) - torch.argmax(nz.flip(-1), dim=-1)
    top = torch.gather(diff, -1, msd.unsqueeze(-1))[..., 0]
    return top >= 0


# Barrett: after the entry fold and positivity shift the quotient is
# < 2^15; a float32 estimate from the top five limbs, minus one, is a
# guaranteed under-estimate within 2 of it. The float ops run as separate
# torch ops in the JAX order, so the rounding is the same.
_BARRETT_TOP_LIMB = 30
_BARRETT_INV = np.float32((2.0 ** (BITS * _BARRETT_TOP_LIMB)) / float(P))
_BASE_F32 = np.float32(BASE)


def canon(x: torch.Tensor) -> torch.Tensor:
    """Exact canonical representative in [0, p), width W. Input: any lazy
    limb vector of width W."""
    assert x.shape[-1] == W
    dev = x.device
    x = _truncate(_fold_round(x))
    x = x + on(_C_SHIFT, dev)
    x, _ = _scan_carry(x)
    base, inv = on(_BASE_F32, dev), on(_BARRETT_INV, dev)
    v_top = torch.zeros(x.shape[:-1], dtype=torch.float32, device=dev)
    for i in range(W - 1, _BARRETT_TOP_LIMB - 1, -1):
        v_top = v_top * base + x[..., i].to(torch.float32)
    q = torch.floor(v_top * inv).to(torch.int32)
    q = torch.clamp(q - 1, min=0)
    q_lo = q & MASK
    q_hi = q >> BITS
    x = x - q_lo[..., None] * on(P_LIMBS, dev) - q_hi[..., None] * on(
        _P_HI_LIMBS, dev
    )
    x, _ = _scan_carry(x)
    kp = on(_KP, dev)
    cnt = _geq(x, kp[1]).to(torch.int64) + _geq(x, kp[2]).to(torch.int64)
    x = x - kp[cnt]
    x, _ = _scan_carry(x)
    return x


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact Fp equality of lazy representations -> (...,) bool."""
    return torch.all(canon(sub(a, b)) == 0, dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canon(a) == 0, dim=-1)


def from_int(x: int) -> np.ndarray:
    """Host: int -> its limbs mod p (a host array, like every constant
    here; `on` puts it on a device)."""
    return to_limbs(x % P)


def to_fp_int(a) -> int:
    """Host: limb vector -> canonical int in [0, p)."""
    return to_int(np.asarray(a)) % P


from . import kernels as _K  # noqa: E402  (kernels imports this module)

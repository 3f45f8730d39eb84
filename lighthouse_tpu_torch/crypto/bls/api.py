"""Backend-pluggable BLS12-381 API (Ethereum proof-of-possession scheme).

Port of lighthouse_tpu/crypto/bls/api.py for the PyTorch/CUDA package:
`SecretKey`, `PublicKey`, `AggregatePublicKey`, `Signature`,
`AggregateSignature`, `SignatureSet`, key_validate, the batch entry point
`verify_signature_sets()` (reference crypto/bls/src/lib.rs:99-140) and
`aggregate_verify()`.

Backends (selected via `set_backend` / LIGHTHOUSE_TPU_BLS_BACKEND):

  * ``torch_cuda`` -- the GPU batch verifier (backends/torch_cuda.py), the
                      default. It runs on the card unless the caller passes
                      ``device="cpu"`` (to `set_backend` or to an entry
                      point), which runs every kernel's plain PyTorch
                      version instead. Batches whose keys are all tagged
                      with one device table (`validator_index`, `table`)
                      gather their pubkey rows on the device by index.
  * ``cpu``        -- pure-Python oracle pairing (the milagro-equivalent)
  * ``fake``       -- always-valid stub (fake_crypto)
  * ``fallback``   -- torch_cuda behind a circuit breaker, degrading to cpu
                      on device faults and re-probing back
                      (backends/fallback.py); chosen by name only

`verify_signature_sets_async` is the pipelined entry point: a future per
batch (crypto/bls/pipeline.py), or with a named lane and
LIGHTHOUSE_TPU_CONT_BATCH=1 a place in the continuous-batching scheduler
(crypto/bls/scheduler.py).

Keys and signatures carry their affine oracle points plus compressed bytes;
group membership is enforced at `PublicKey` construction while signatures
are subgroup-checked inside verification (as blst.rs:72-82 does).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from . import curve_ref as C
from .constants import R
from .curve_ref import DeserializeError, Point
from .fields_ref import Fp, Fp2
from .hash_to_curve_ref import hash_to_g2

PUBLIC_KEY_BYTES_LEN = 48
SIGNATURE_BYTES_LEN = 96
SECRET_KEY_BYTES_LEN = 32

INFINITY_PUBLIC_KEY = bytes([0xC0]) + bytes(PUBLIC_KEY_BYTES_LEN - 1)
INFINITY_SIGNATURE = bytes([0xC0]) + bytes(SIGNATURE_BYTES_LEN - 1)


class BlsError(ValueError):
    pass


def _g1_infinity() -> Point:
    return Point(Fp.zero(), Fp.zero(), True)


def _g2_infinity() -> Point:
    return Point(Fp2.zero(), Fp2.zero(), True)


class PublicKey:
    """Validated G1 public key: on curve, in the subgroup, not infinity
    (key-validate per the IETF BLS spec; reference generic_public_key.rs).
    `_tpu_limbs` caches the limb array (torch_cuda backend);
    `validator_index`/`table` are set by the chain's validator pubkey
    cache, so the batch verifier gathers the key's limbs from the
    device-resident table by index (`table` is anything with
    `.gather(indices)`; reference validator_pubkey_cache.rs:10-23)."""

    __slots__ = (
        "point", "_bytes", "_tpu_limbs", "validator_index", "table",
        "_subgroup_ok",
    )

    def __init__(
        self,
        point: Point,
        compressed: bytes | None = None,
        *,
        subgroup_checked: bool = False,
    ):
        self.point = point
        self._bytes = compressed
        # key_validate verdict cache: True when the constructor's caller
        # already proved r-torsion membership (from_bytes, generator
        # multiples, sums of validated keys — G1 is closed under +).
        # Unset == unknown; subgroup_ok() decides lazily and caches.
        if subgroup_checked:
            self._subgroup_ok = True

    def subgroup_ok(self) -> bool:
        """blst's key_validate, cached: on the curve, in the r-torsion
        subgroup, not the point at infinity. Keys decompressed through
        `from_bytes` were proven at construction and answer from the
        cache; directly-constructed points (the small-subgroup /
        low-order-component attack surface — see crypto/bls/adversary.py)
        pay one scalar-mul check on first use."""
        ok = getattr(self, "_subgroup_ok", None)
        if ok is None:
            p = self.point
            ok = (
                (not p.inf)
                and C.is_on_g1(p)
                and C.g1_subgroup_check(p)
            )
            self._subgroup_ok = ok
        return ok

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        try:
            point = C.g1_from_bytes(bytes(data))
        except DeserializeError as e:
            raise BlsError(f"invalid public key: {e}") from None
        if point.inf:
            raise BlsError("public key is the point at infinity")
        if not C.g1_subgroup_check(point):
            raise BlsError("public key not in the r-torsion subgroup")
        return cls(point, bytes(data), subgroup_checked=True)

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = C.g1_to_bytes(self.point)
        return self._bytes

    def __eq__(self, o):
        return isinstance(o, PublicKey) and self.to_bytes() == o.to_bytes()

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"PublicKey(0x{self.to_bytes().hex()[:16]}…)"


class AggregatePublicKey:
    """Sum of validated public keys (reference generic_aggregate_public_key.rs)."""

    __slots__ = ("point",)

    def __init__(self, point: Point):
        self.point = point

    @classmethod
    def aggregate(cls, pubkeys) -> "AggregatePublicKey":
        if not pubkeys:
            raise BlsError("cannot aggregate an empty pubkey list")
        acc = _g1_infinity()
        for pk in pubkeys:
            acc = acc + pk.point
        return cls(acc)


class Signature:
    """G2 signature. Decompression validates on-curve; subgroup membership
    is checked during verification (matching blst.rs:72-82). The point at
    infinity is representable (empty aggregates) and never verifies."""

    __slots__ = ("point", "_bytes", "_tpu_limbs")

    def __init__(self, point: Point, compressed: bytes | None = None):
        self.point = point
        self._bytes = compressed

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        try:
            point = C.g2_from_bytes(bytes(data))
        except DeserializeError as e:
            raise BlsError(f"invalid signature: {e}") from None
        return cls(point, bytes(data))

    @classmethod
    def infinity(cls) -> "Signature":
        return cls(_g2_infinity(), INFINITY_SIGNATURE)

    def is_infinity(self) -> bool:
        return self.point.inf

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = C.g2_to_bytes(self.point)
        return self._bytes

    def __eq__(self, o):
        return isinstance(o, Signature) and self.to_bytes() == o.to_bytes()

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"Signature(0x{self.to_bytes().hex()[:16]}…)"


class AggregateSignature:
    """Running aggregate of signatures (reference
    generic_aggregate_signature.rs); starts at infinity."""

    __slots__ = ("point",)

    def __init__(self, point: Point | None = None):
        self.point = point if point is not None else _g2_infinity()

    @classmethod
    def aggregate(cls, sigs) -> "AggregateSignature":
        out = cls()
        for s in sigs:
            out.add_assign(s)
        return out

    def add_assign(self, sig: Signature) -> None:
        self.point = self.point + sig.point

    def add_assign_aggregate(self, other: "AggregateSignature") -> None:
        self.point = self.point + other.point

    def to_signature(self) -> Signature:
        return Signature(self.point)

    def to_bytes(self) -> bytes:
        return C.g2_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, data: bytes) -> "AggregateSignature":
        return cls(Signature.from_bytes(data).point)


class SecretKey:
    """Scalar secret key; signing hashes to G2 with the Ethereum DST and
    multiplies (reference generic_secret_key.rs + impls/blst.rs sign)."""

    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        if not 1 <= scalar < R:
            raise BlsError("secret key scalar out of range")
        self.scalar = scalar

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_BYTES_LEN:
            raise BlsError("secret key must be 32 bytes")
        return cls(int.from_bytes(data, "big"))

    def to_bytes(self) -> bytes:
        return self.scalar.to_bytes(SECRET_KEY_BYTES_LEN, "big")

    def public_key(self) -> PublicKey:
        return PublicKey(
            C.g1_generator().mul(self.scalar), subgroup_checked=True
        )

    def sign(self, message: bytes) -> Signature:
        return Signature(hash_to_g2(bytes(message)).mul(self.scalar))


@dataclass
class SignatureSet:
    """{aggregate signature, pubkeys, 32-byte message}: one
    fast_aggregate_verify claim (reference generic_signature_set.rs:61-72)."""

    signature: Signature
    pubkeys: list = field(default_factory=list)
    message: bytes = b""

    @classmethod
    def single_pubkey(cls, signature, pubkey, message) -> "SignatureSet":
        return cls(signature, [pubkey], bytes(message))

    @classmethod
    def multiple_pubkeys(cls, signature, pubkeys, message) -> "SignatureSet":
        return cls(signature, list(pubkeys), bytes(message))


def key_validate_enabled() -> bool:
    """G1 key_validate coverage at the verification and import seams:
    every pubkey that did NOT come through `PublicKey.from_bytes` gets
    an infinity + on-curve + r-torsion check before it can influence a
    pairing (low-order G1 components are pairing-INVISIBLE — e(T, Q) == 1
    for any T in the cofactor subgroup — so only an explicit check
    rejects them). ON unless LIGHTHOUSE_TPU_KEY_VALIDATE=0; the off
    switch exists for adversary tests that prove their probes catch a
    stack that skips key_validate. Read per call so tests flip it
    without reimport."""
    return os.environ.get("LIGHTHOUSE_TPU_KEY_VALIDATE", "1") != "0"


def pubkey_subgroup_ok(pk) -> bool:
    """Duck-typed key_validate for one pubkey object: routes through the
    cached `PublicKey.subgroup_ok()` when present, else checks the bare
    point. Shared by the cpu oracle's set checks, the torch_cuda marshal
    seam, and the device pubkey-table import."""
    check = getattr(pk, "subgroup_ok", None)
    if check is not None:
        return bool(check())
    p = pk.point
    return (not p.inf) and C.is_on_g1(p) and C.g1_subgroup_check(p)


# --- backend selection ------------------------------------------------------

_BACKEND = None
_BACKEND_NAME = None
_DEVICE = None


def set_backend(name: str, device=None) -> None:
    """Select the verification backend -- 'torch_cuda', 'cpu', 'fake', or
    'fallback' (torch_cuda with circuit-breakered degradation to cpu) --
    and the device its entry points run on (None: the card; cpu and fake
    ignore it)."""
    global _BACKEND, _BACKEND_NAME, _DEVICE
    if name == "torch_cuda":
        from .backends import torch_cuda as mod
    elif name == "cpu":
        from .backends import cpu as mod
    elif name == "fake":
        from .backends import fake as mod
    elif name == "fallback":
        from .backends import fallback as mod
    else:
        raise BlsError(f"unknown BLS backend {name!r}")
    _BACKEND, _BACKEND_NAME, _DEVICE = mod, name, device


def get_backend_name() -> str:
    _ensure_backend()
    return _BACKEND_NAME


def _ensure_backend():
    if _BACKEND is None:
        set_backend(os.environ.get("LIGHTHOUSE_TPU_BLS_BACKEND", "torch_cuda"))
    return _BACKEND


def verify_signature_sets(sets, seed: int | None = None, device=None) -> bool:
    """Batch-verify: every set must satisfy fast_aggregate_verify. One
    random-linear-combination multi-pairing (the semantics of reference
    impls/blst.rs:36-119). `seed` pins the random weights; `device`
    overrides the backend's device for this call."""
    sets = list(sets)
    if not sets:
        return False
    backend = _ensure_backend()
    return backend.verify_signature_sets(
        sets, seed=seed, device=device if device is not None else _DEVICE
    )


def verify_signature_sets_async(
    sets,
    seed: int | None = None,
    lane: str | None = None,
    slot: int | None = None,
    device=None,
):
    """Pipelined batch-verify: marshal + enqueue now, answer later.

    Returns a ``pipeline.VerifyFuture`` whose ``result()`` yields exactly
    what ``verify_signature_sets`` would have returned for the same sets,
    seed and device. Host marshalling for the NEXT batch overlaps device
    work for this one (the stage graphs run asynchronously on the card);
    futures resolve in submit order. Backends without an async dispatch
    hook (cpu, fake, fallback) compute eagerly at submit -- same futures,
    no behavioral difference.

    When the caller names its `lane` (block / aggregate / unaggregated /
    sync / speculative) and continuous batching is enabled
    (`LIGHTHOUSE_TPU_CONT_BATCH=1`), the batch instead lands in the
    deadline scheduler (crypto/bls/scheduler.py): it merges with other
    queued lanes into the next padded warm-bucket launch, and `slot`
    anchors its per-lane time-to-verdict histogram on the slot clock.
    The returned ``ScheduledVerify`` duck-types VerifyFuture exactly.
    """
    from . import scheduler as bls_scheduler

    if lane is not None and bls_scheduler.enabled():
        return bls_scheduler.default_scheduler().submit(
            sets, lane=lane, seed=seed, slot=slot, device=device
        )
    from .pipeline import default_pipeline

    return default_pipeline().submit(sets, seed=seed, device=device)


def verify(signature: Signature, pubkeys, message: bytes, device=None) -> bool:
    """fast_aggregate_verify of a single claim."""
    return verify_signature_sets(
        [SignatureSet.multiple_pubkeys(signature, pubkeys, message)],
        device=device,
    )


def aggregate_verify(signature: Signature, pubkeys, messages, device=None) -> bool:
    """ONE aggregate signature over DISTINCT messages (the spec's
    AggregateVerify; reference generic_aggregate_signature.rs). Not
    expressible as verify_signature_sets (those carry one signature PER
    message), so the backend implements it directly. The structural
    verdicts are pinned here: length mismatch, no pubkeys and an infinity
    signature are False with no device work."""
    pubkeys = list(pubkeys)
    messages = [bytes(m) for m in messages]
    if len(pubkeys) != len(messages) or not pubkeys:
        return False
    if signature.point.inf:
        return False
    return _ensure_backend().aggregate_verify(
        signature, pubkeys, messages,
        device=device if device is not None else _DEVICE,
    )

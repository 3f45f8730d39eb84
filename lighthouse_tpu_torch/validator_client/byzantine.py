"""Byzantine validator clients: slashable signing driven through the
REAL duty-signing facade (validator_store.py), not fabricated at the
gossip layer.

A `ByzantineValidatorStore` is a `ValidatorStore` whose slashing
protection is deliberately BYPASSED: the slashing database still runs
its `check_and_insert_*` gate on every signing request, but a `NotSafe`
verdict is recorded to an audit trail and then overridden — exactly the
adversary model where a malicious operator patches the refusal out of
their client. The audit trail doubles as the scenario harness's proof
that the protection layer WOULD have refused each slashable message
(`protection_overrides` in the scenario report).

`ByzPlan` is the per-phase behavior knob (which slashable families a
byz validator produces and at what cadence); `ByzRoster` is the
simulator-side binding of a plan to the sampled byz validator set and
their shared byzantine store. The grammar in `harness/fuzz.py` draws
`ByzPlan`s from the same typed fields.


The port's copy of lighthouse_tpu/validator_client/byzantine.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.bls.api import Signature
from ..types.presets import Preset
from .slashing_protection import NotSafe
from .validator_store import ValidatorStore


@dataclass(frozen=True)
class ByzPlan:
    """Which slashable behaviors a phase's byz validators produce.

    fraction: share of each node's HOMED validators that turn Byzantine
    (sampled per node so every partition side gets adversaries).
    every: act every N slots of the phase (cadence, >= 1).
    """

    fraction: float = 0.25
    every: int = 2
    double_propose: bool = True
    conflicting_votes: bool = True
    surround_votes: bool = False
    equivocating_aggregates: bool = False

    def active(self) -> bool:
        return self.fraction > 0 and (
            self.double_propose
            or self.conflicting_votes
            or self.surround_votes
            or self.equivocating_aggregates
        )


class _RawPubkey:
    """Duck-types the blst PublicKey surface the store touches
    (`to_bytes`) without any curve arithmetic: byz signing under the
    fake-crypto scenario backend must not pay G1 decompression per key."""

    __slots__ = ("_bytes",)

    def __init__(self, pubkey_bytes: bytes):
        self._bytes = bytes(pubkey_bytes)

    def to_bytes(self) -> bytes:
        return self._bytes


class PlaceholderKeystore:
    """A `LocalKeystore`-shaped signing method that emits the infinity
    signature instead of doing G2 hash-to-curve + scalar multiplication.

    The scenario harness runs under the "fake" BLS backend where
    signature BYTES are never interpreted, so a real secret key would
    only burn CPU; what matters is that the full ValidatorStore path
    (domain derivation, signing-root computation, the slashing-DB gate)
    executes for every byz message."""

    __slots__ = ("pubkey",)

    def __init__(self, pubkey_bytes: bytes):
        self.pubkey = _RawPubkey(pubkey_bytes)

    def sign(self, signing_root: bytes) -> Signature:
        return Signature.infinity()


class ByzantineValidatorStore(ValidatorStore):
    """ValidatorStore with the slashing-protection verdict overridden.

    Every signing request still runs the real `check_and_insert_*` gate
    (so the database records what an honest client would have signed);
    a `NotSafe` refusal is appended to `self.overrides` as
    (kind, slot_or_target, reason) and then ignored. Everything else —
    doppelganger holds, domain/signing-root derivation, selection and
    aggregate proofs — is inherited unchanged."""

    def __init__(self, preset: Preset, spec, slashing_db=None):
        super().__init__(preset, spec, slashing_db=slashing_db)
        # audit trail: each entry proves the protection layer refused a
        # message this store went on to sign anyway
        self.overrides: list[tuple[str, int, str]] = []

    def sign_block(self, pubkey: bytes, block, state) -> Signature:
        try:
            return super().sign_block(pubkey, block, state)
        except NotSafe as e:
            self.overrides.append(("block", int(block.slot), str(e)))
            return self._method(pubkey).sign(b"")

    def sign_attestation(self, pubkey: bytes, data, state) -> Signature:
        try:
            return super().sign_attestation(pubkey, data, state)
        except NotSafe as e:
            self.overrides.append(
                ("attestation", int(data.target.epoch), str(e))
            )
            return self._method(pubkey).sign(b"")


class ByzRoster:
    """The simulator-side binding: which validator indices are Byzantine
    this phase, their shared bypassing store, and per-family counters."""

    def __init__(self, plan: ByzPlan, preset: Preset, spec):
        self.plan = plan
        self.store = ByzantineValidatorStore(preset, spec)
        # validator index -> pubkey bytes
        self.members: dict[int, bytes] = {}

    def enroll(self, validator_index: int, pubkey_bytes: bytes) -> None:
        pk = bytes(pubkey_bytes)
        self.members[validator_index] = pk
        self.store.add_validator(
            PlaceholderKeystore(pk), validator_index=validator_index
        )

    def pubkey_of(self, validator_index: int) -> bytes:
        return self.members[validator_index]

    def __contains__(self, validator_index: int) -> bool:
        return validator_index in self.members

    def __len__(self) -> int:
        return len(self.members)

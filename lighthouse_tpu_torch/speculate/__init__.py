"""Duty-driven precompute & speculative verification.

The port's copy of lighthouse_tpu/speculate/. It sits between the
chain's epoch boundary and the BLS pipeline:

  * :mod:`.precompute` — per-(slot, committee) aggregate pubkeys built at
    each epoch transition, keyed on the attester shuffling seed, so the
    hot attestation path skips per-set pubkey aggregation entirely (full
    participation) or pays only an O(absent) incremental correction;
  * :mod:`.scheduler` — idle-time pre-verification of the expected
    next-slot aggregates, confirmed-by-lookup on arrival.

`attach_speculation(chain, ...)` wires both into a live chain: it sets
`chain.speculation` (the hook `chain/attestation_verification.py` probes
during aggregate batch setup), subscribes to the chain's event sinks for
epoch-rollover refresh and reorg invalidation, and registers the idle
task on the BeaconProcessor. Every path is fail-open: a missing entry, a
stale shuffling key, or any speculation mismatch falls through to the
normal fully-verified path — speculation can make verification cheaper,
never weaker.
"""

from __future__ import annotations

from ..crypto.bls.api import SignatureSet
from ..state_transition.context import ConsensusContext
from ..types import compute_epoch_at_slot
from ..utils import metrics as M
from .precompute import CommitteePrecompute, PrecomputeEntry
from .scheduler import SpeculativeVerifier

__all__ = [
    "CommitteePrecompute",
    "PrecomputeEntry",
    "SpeculativeVerifier",
    "SpeculationSubsystem",
    "attach_speculation",
]


class SpeculationSubsystem:
    """The two halves plus their chain/processor plumbing. Construct via
    :func:`attach_speculation`."""

    def __init__(
        self,
        chain,
        processor=None,
        signature_source=None,
        queue_wait_p95_max: float = 0.05,
        device_correction: bool | None = None,
    ):
        self.chain = chain
        self.processor = processor
        self.enabled = True
        self.precompute = CommitteePrecompute(
            chain.preset,
            chain.spec,
            device_correction=device_correction,
        )
        self.verifier = SpeculativeVerifier(
            chain,
            self.precompute,
            signature_source=signature_source,
            queue_wait_p95_max=queue_wait_p95_max,
        )
        self._last_refreshed_epoch: int | None = None
        # audit trail for the scenario harness: tree roots of every
        # attestation accepted by CONFIRM-BY-LOOKUP (the only speculation
        # outcome that skips re-verification). The Byzantine-VC scenarios
        # counter-assert that no byz-emitted aggregate ever lands here.
        self.confirmed_roots: list[bytes] = []

    # -- precompute refresh (epoch boundary / startup / reorg) ---------------

    def refresh(self, force: bool = False) -> int:
        """Precompute the head state's current and next epochs (the
        committees a gossip aggregate can reference under the propagation
        window). Cheap when keys are unchanged; `force` re-walks anyway."""
        chain = self.chain
        state = chain.head_state
        epoch = compute_epoch_at_slot(int(state.slot), chain.preset)
        ctxt = ConsensusContext(chain.preset, chain.spec)
        get_pubkey = chain.pubkey_cache.getter(state)
        built = 0
        for e in (epoch, epoch + 1):
            if force:
                self.precompute._drop_epoch(e, invalidated=False)
            built += self.precompute.refresh_epoch(state, e, ctxt, get_pubkey)
        self.precompute.prune(max(0, epoch - 1))
        self._last_refreshed_epoch = epoch
        return built

    # -- chain event sink ----------------------------------------------------

    def on_event(self, kind: str, payload) -> None:
        """Head events drive the lifecycle: epoch rollover refreshes the
        next epoch's committees; any head move revalidates cached
        shuffling keys against the new head state (a reorg that crossed
        an epoch boundary changes the seed and drops the entries; a
        same-shuffling reorg keeps them warm)."""
        if kind != "head":
            return
        chain = self.chain
        state = chain.head_state
        epoch = compute_epoch_at_slot(int(state.slot), chain.preset)
        stale = False
        for e in list(self.precompute._keys):
            if not self.precompute.check_epoch(state, e):
                stale = True
        if stale or epoch != self._last_refreshed_epoch:
            self.refresh()
        self.verifier.prune(int(state.slot) - 2)

    # -- idle task (BeaconProcessor seam) ------------------------------------

    def idle_task(self) -> None:
        """One speculation pass, gated on pipeline idleness; registered
        via BeaconProcessor.set_idle_task."""
        if not self.enabled:
            return
        if not self.verifier.should_run(self.processor):
            return
        self.verifier.stats["idle_runs"] += 1
        M.SPECULATE_IDLE_RUNS.inc()
        self.verifier.speculate_slot()

    # -- the verification hook (critical path) -------------------------------

    def process_indexed_set(self, state, attestation, indexed, ind_set):
        """Called by aggregate batch setup with the already-built indexed
        attestation signature set. Returns:

          * ``None`` — the exact claim was pre-verified and the arriving
            signature matches: confirmed by lookup, drop the set;
          * a replacement set whose single pubkey is the precomputed
            (full or corrected) committee aggregate — zero per-set
            aggregation for the backend, identical verdict;
          * ``ind_set`` unchanged — miss; verify on the normal path.
        """
        if not self.enabled:
            return ind_set
        data = attestation.data
        slot, index = int(data.slot), int(data.index)
        epoch = int(data.target.epoch)
        bits = tuple(bool(b) for b in attestation.aggregation_bits)
        entry = self.precompute.lookup(state, slot, index, epoch)
        if entry is None or not entry.matches(bits, indexed.attesting_indices):
            self.precompute.stats["misses"] += 1
            M.SPECULATE_PRECOMPUTE_MISSES.inc()
            return ind_set
        if self.verifier.confirm(
            ind_set.message,
            bits,
            slot,
            index,
            entry.shuffling_key,
            bytes(attestation.signature),
        ):
            self.confirmed_roots.append(bytes(attestation.tree_hash_root()))
            return None
        pk = self.precompute.aggregate_pubkey(entry, bits)
        return SignatureSet(ind_set.signature, [pk], ind_set.message)

    # -- teardown ------------------------------------------------------------

    def detach(self) -> None:
        self.enabled = False
        chain = self.chain
        if getattr(chain, "speculation", None) is self:
            chain.speculation = None
        try:
            chain.event_sinks.remove(self.on_event)
        except ValueError:
            pass
        if self.processor is not None and (
            getattr(self.processor, "idle_task", None) == self.idle_task
        ):
            self.processor.set_idle_task(None)


def attach_speculation(
    chain,
    processor=None,
    signature_source=None,
    queue_wait_p95_max: float = 0.05,
    device_correction: bool | None = None,
) -> SpeculationSubsystem:
    """Wire the speculation subsystem into `chain` (and optionally a
    BeaconProcessor for idle-time scheduling). Refreshes the precompute
    for the current/next epochs immediately (the startup contract)."""
    sub = SpeculationSubsystem(
        chain,
        processor=processor,
        signature_source=signature_source,
        queue_wait_p95_max=queue_wait_p95_max,
        device_correction=device_correction,
    )
    chain.speculation = sub
    chain.event_sinks.append(sub.on_event)
    if processor is not None and hasattr(processor, "set_idle_task"):
        processor.set_idle_task(sub.idle_task)
    sub.refresh()
    return sub

"""Validator monitor (reference beacon_chain/src/validator_monitor.rs,
1,690 LoC): per-registered-validator observability — block proposals,
attestation inclusions and delays, per-epoch participation summaries
(source/target/head hit or MISS, from the state's own participation
flags), sync-committee signatures, exits and slashings — surfaced as
metrics and queryable stats. Plus the block-times cache
(block_times_cache.rs): per-block observed→imported latency.

The port's copy of lighthouse_tpu/chain/validator_monitor.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import metrics as M


@dataclass
class EpochSummary:
    """Per-epoch rollup for one monitored validator (validator_monitor.rs
    EpochSummary): what it did, and what the chain ended up recording."""

    epoch: int
    attestations_seen: int = 0
    attestation_min_delay: int | None = None
    source_hit: bool | None = None  # None until the epoch is evaluated
    target_hit: bool | None = None
    head_hit: bool | None = None
    sync_signatures: int = 0
    blocks_proposed: int = 0
    exits_observed: int = 0
    slashings_observed: int = 0


_SUMMARY_RETENTION = 8  # epochs of history per validator


@dataclass
class MonitoredValidator:
    index: int
    blocks_proposed: int = 0
    attestations_seen: int = 0
    attestation_min_delay_slots: dict[int, int] = field(default_factory=dict)
    last_attestation_slot: int | None = None
    # bounded window of recently-gossiped attestation slots (liveness
    # queries must see epoch E even after the validator attests E+1)
    recent_attestation_slots: dict[int, None] = field(default_factory=dict)
    sync_signatures: int = 0
    last_sync_signature_slot: int | None = None
    summaries: dict[int, EpochSummary] = field(default_factory=dict)

    def summary(self, epoch: int) -> EpochSummary:
        s = self.summaries.get(epoch)
        if s is None:
            s = self.summaries[epoch] = EpochSummary(epoch)
            # bounded history
            for old in sorted(self.summaries)[: -_SUMMARY_RETENTION]:
                del self.summaries[old]
        return s


@dataclass
class BlockTimes:
    slot: int
    observed_at: float | None = None
    imported_at: float | None = None

    @property
    def import_latency(self) -> float | None:
        if self.observed_at is None or self.imported_at is None:
            return None
        return self.imported_at - self.observed_at


class ValidatorMonitor:
    """Registered-validator tracking fed by the chain's import paths
    (beacon_chain calls in, exactly as the reference's monitor is driven
    from block/attestation processing)."""

    def __init__(self, auto_register: bool = False):
        self.auto_register = auto_register
        self.validators: dict[int, MonitoredValidator] = {}
        self.block_times: dict[bytes, BlockTimes] = {}
        self._last_evaluated_epoch: int | None = None
        self._retired_through: int | None = None
        # families are declared in utils/metrics.py (metric-origin rule:
        # the /metrics surface is enumerable from that one module)
        self._proposals = M.VALIDATOR_MONITOR_PROPOSALS
        self._attestations = M.VALIDATOR_MONITOR_ATTESTATIONS
        self._inclusion_delay = M.VALIDATOR_MONITOR_INCLUSION_DELAY
        self._target_misses = M.VALIDATOR_MONITOR_TARGET_MISSES
        self._head_misses = M.VALIDATOR_MONITOR_HEAD_MISSES
        self._sync_signatures = M.VALIDATOR_MONITOR_SYNC_SIGNATURES
        self._slashed = M.VALIDATOR_MONITOR_SLASHED

    def register_validator(self, index: int) -> None:
        self.validators.setdefault(index, MonitoredValidator(index))

    def _get(self, index: int) -> MonitoredValidator | None:
        v = self.validators.get(index)
        if v is None and self.auto_register:
            v = self.validators[index] = MonitoredValidator(index)
        return v

    # -- feed points (beacon_chain.rs import paths) -------------------------

    def on_block_observed(self, block_root: bytes, slot: int, now: float) -> None:
        bt = self.block_times.setdefault(bytes(block_root), BlockTimes(slot))
        if bt.observed_at is None:
            bt.observed_at = now

    def on_block_imported(
        self, block_root: bytes, block, now: float
    ) -> None:
        bt = self.block_times.setdefault(
            bytes(block_root), BlockTimes(block.slot)
        )
        bt.imported_at = now
        v = self._get(block.proposer_index)
        if v is not None:
            v.blocks_proposed += 1
            self._proposals.inc()
        # attestations included in this block credit their participants'
        # inclusion delay (validator_monitor.rs register_attestation_in_block)

    def on_attestation_included(
        self, attester_indices, data_slot: int, block_slot: int
    ) -> None:
        delay = max(block_slot - data_slot, 1)
        for idx in attester_indices:
            v = self._get(idx)
            if v is None:
                continue
            prior = v.attestation_min_delay_slots.get(data_slot)
            if prior is None or delay < prior:
                v.attestation_min_delay_slots[data_slot] = delay
                self._inclusion_delay.observe(delay)

    def on_gossip_attestation(self, attester_indices, slot: int) -> None:
        for idx in attester_indices:
            v = self._get(idx)
            if v is not None:
                v.attestations_seen += 1
                v.last_attestation_slot = slot
                v.recent_attestation_slots[slot] = None
                while len(v.recent_attestation_slots) > 128:
                    v.recent_attestation_slots.pop(
                        next(iter(v.recent_attestation_slots))
                    )
                self._attestations.inc()

    def on_sync_committee_message(self, validator_index: int, slot: int) -> None:
        v = self._get(validator_index)
        if v is not None:
            v.sync_signatures += 1
            v.last_sync_signature_slot = slot
            self._sync_signatures.inc()

    def on_exit_observed(self, validator_index: int, epoch: int) -> None:
        v = self._get(validator_index)
        if v is not None:
            v.summary(epoch).exits_observed += 1

    def on_slashing_observed(self, validator_indices, epoch: int) -> None:
        for idx in validator_indices:
            v = self._get(idx)
            if v is not None:
                v.summary(epoch).slashings_observed += 1
                self._slashed.inc()

    # -- per-epoch evaluation (validator_monitor.rs process_valid_state) ----

    def evaluate_epoch(self, state, preset) -> None:
        """At an epoch boundary, grade every monitored validator's
        PREVIOUS epoch from the state's own participation flags: did the
        chain record its source/target/head votes? Misses become counters
        a dashboard can alert on — the reference's core monitoring loop."""
        if not hasattr(state, "previous_epoch_participation"):
            return  # phase0: pending-attestation grading not surfaced
        from ..state_transition.participation import (
            TIMELY_HEAD_FLAG_INDEX,
            TIMELY_SOURCE_FLAG_INDEX,
            TIMELY_TARGET_FLAG_INDEX,
            has_flag,
        )
        from ..types import compute_epoch_at_slot, is_active_validator

        current_epoch = compute_epoch_at_slot(state.slot, preset)
        if current_epoch == 0:
            return  # no completed epoch to grade yet
        prev_epoch = current_epoch - 1
        # RE-grade on every head change while the epoch is still "previous"
        # — attestations for E-1 may land up to a full epoch late (delay
        # 2+ crosses the boundary), so summaries stay live until the epoch
        # retires. Miss COUNTERS bump only at retirement, from the final
        # summary, so late inclusions cannot overstate misses.
        if (
            self._last_evaluated_epoch is not None
            and prev_epoch > self._last_evaluated_epoch
        ):
            # a multi-epoch head jump retires EVERY epoch the watermark
            # skips over, not just the watermark itself -- intermediate
            # epochs graded on earlier head changes must still count
            # their misses (they can never be re-graded once retired)
            for epoch in range(self._last_evaluated_epoch, prev_epoch):
                self._count_retired_epoch(epoch)
        # a reorg can move the head to an EARLIER epoch; never regress the
        # watermark or a later advance would retire (and count) the same
        # epoch twice
        if (
            self._last_evaluated_epoch is None
            or prev_epoch > self._last_evaluated_epoch
        ):
            self._last_evaluated_epoch = prev_epoch
        elif prev_epoch < self._last_evaluated_epoch:
            return
        part = state.previous_epoch_participation
        for idx, v in self.validators.items():
            if idx >= len(state.validators):
                continue
            val = state.validators[idx]
            if not is_active_validator(val, prev_epoch):
                continue
            flags = part[idx]
            s = v.summary(prev_epoch)
            s.source_hit = bool(has_flag(flags, TIMELY_SOURCE_FLAG_INDEX))
            s.target_hit = bool(has_flag(flags, TIMELY_TARGET_FLAG_INDEX))
            s.head_hit = bool(has_flag(flags, TIMELY_HEAD_FLAG_INDEX))
            delays = [
                d
                for sl, d in v.attestation_min_delay_slots.items()
                if prev_epoch * preset.slots_per_epoch
                <= sl
                < (prev_epoch + 1) * preset.slots_per_epoch
            ]
            # per-epoch figures, not lifetime counters: distinct included
            # attestation slots and the best delay within THIS epoch
            s.attestations_seen = len(delays)
            s.attestation_min_delay = min(delays) if delays else None
            # prune inclusion-delay entries past the retention window so
            # per-head-change grading stays O(window), not O(uptime)
            horizon = (
                max(prev_epoch - _SUMMARY_RETENTION, 0)
                * preset.slots_per_epoch
            )
            for sl in [
                sl for sl in v.attestation_min_delay_slots if sl < horizon
            ]:
                del v.attestation_min_delay_slots[sl]

    def _count_retired_epoch(self, epoch: int) -> None:
        if self._retired_through is not None and epoch <= self._retired_through:
            return
        self._retired_through = epoch
        for v in self.validators.values():
            s = v.summaries.get(epoch)
            if s is None:
                continue
            if s.target_hit is False:
                self._target_misses.inc()
            if s.head_hit is False:
                self._head_misses.inc()

    # -- queries (the /lighthouse/ui/validator-metrics seat) ----------------

    def stats(self, index: int) -> dict | None:
        v = self.validators.get(index)
        if v is None:
            return None
        delays = v.attestation_min_delay_slots.values()
        recent = [
            {
                "epoch": s.epoch,
                "source_hit": s.source_hit,
                "target_hit": s.target_hit,
                "head_hit": s.head_hit,
                "attestation_min_delay": s.attestation_min_delay,
                "exits_observed": s.exits_observed,
                "slashings_observed": s.slashings_observed,
            }
            for _, s in sorted(v.summaries.items())
        ]
        return {
            "index": v.index,
            "blocks_proposed": v.blocks_proposed,
            "attestations_seen": v.attestations_seen,
            "attestations_included": len(v.attestation_min_delay_slots),
            "mean_inclusion_delay": (
                # lint: allow[float-consensus] -- operator-facing report,
                # never fed back into state-transition arithmetic
                sum(delays) / len(delays) if delays else None
            ),
            "last_attestation_slot": v.last_attestation_slot,
            "epoch_summaries": recent,
        }

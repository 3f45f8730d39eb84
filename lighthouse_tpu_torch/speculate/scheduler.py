"""Speculative next-slot pre-verification (the second half of speculate/).

During idle device time the scheduler pre-verifies the EXPECTED next-slot
aggregate attestations from the duty schedule: expected message = the
current head as target/source (no-reorg assumption, exactly what
`chain.produce_attestation_data` returns for a future slot), expected
participation = the full committee. Each pre-verified (message,
participation-bits, committee, shuffling-key) is memoized together with
the VERIFIED signature bytes, so when the real aggregate arrives it is
confirmed by cache lookup instead of paying a pairing on the critical
path.

Hard soundness rule — NEVER TRUST-ON-PREDICT:

  * a memo entry is only written after a real `verify_signature_sets`
    call returned True for exactly that (message, bits, committee) claim;
  * confirmation requires the arriving signature BYTES to equal the
    pre-verified ones (BLS signing is deterministic, so the honest
    aggregate over the same signer set is unique) — any difference is a
    MISMATCH, counted and fully re-verified on the normal path;
  * a missing memo entry is a MISS: the set rides the normal batch.

The expected aggregate's signature cannot be known by a node that does
not hold the keys, so where it comes from is pluggable
(`signature_source`): the bench/test harnesses supply interop-key
signing, a staking-pool deployment would bridge its own signers, and
with no source the scheduler is a no-op (precompute still works).

Idle gating (the processor's health snapshot and queue-wait histogram):
a pass runs only when the processor's queues are empty, nothing is
deferred or in flight, and the windowed queue-wait p95 is below
`queue_wait_p95_max` — speculation must never add latency to real work.

The port's copy of lighthouse_tpu/speculate/scheduler.py.
"""

from __future__ import annotations

from ..crypto.bls.api import (
    Signature,
    SignatureSet,
    verify_signature_sets_async,
)
from ..types import (
    DOMAIN_BEACON_ATTESTER,
    compute_epoch_at_slot,
)
from ..types.helpers import compute_signing_root, get_domain
from ..utils import metrics as M

_MAX_MEMO = 8192


class SpeculativeVerifier:
    def __init__(
        self,
        chain,
        precompute,
        signature_source=None,
        queue_wait_p95_max: float = 0.05,
    ):
        self.chain = chain
        self.precompute = precompute
        # signature_source(data, members, signing_root) -> bytes | None
        self.signature_source = signature_source
        self.queue_wait_p95_max = queue_wait_p95_max
        # (message, bits, slot, index, shuffling_key) -> verified sig bytes
        self._memo: dict[tuple, bytes] = {}
        self._wait_baseline = M.PROCESSOR_QUEUE_WAIT.snapshot()
        self.stats = {
            "preverified": 0,
            "confirms": 0,
            "confirm_misses": 0,
            "mismatches": 0,
            "idle_runs": 0,
        }

    # -- idle gating ---------------------------------------------------------

    def should_run(self, processor=None) -> bool:
        """Only speculate when the pipeline is genuinely idle: empty
        queues, zero in-flight verdicts, no busy workers, and the
        queue-wait p95 over the window since the last pass below the
        threshold."""
        if processor is not None:
            health = processor.health_snapshot()
            if (
                health["pending"]
                or health["deferred"]
                or health["busy_workers"]
            ):
                return False
        p95 = M.PROCESSOR_QUEUE_WAIT.quantile(0.95, since=self._wait_baseline)
        if p95 is not None and p95 > self.queue_wait_p95_max:
            # pressure in the window: skip, and restart the window so a
            # past storm doesn't gate speculation forever
            self._wait_baseline = M.PROCESSOR_QUEUE_WAIT.snapshot()
            return False
        return True

    # -- the speculation pass ------------------------------------------------

    def speculate_slot(self, slot: int | None = None) -> int:
        """Pre-verify the expected aggregates for `slot` (default: the
        slot after the chain's current one) from the duty schedule.
        Returns the number of memo entries written."""
        if self.signature_source is None:
            return 0
        chain = self.chain
        if slot is None:
            slot = int(chain.current_slot) + 1
        state = chain.head_state
        epoch = compute_epoch_at_slot(slot, chain.preset)
        entries = self.precompute._epochs.get(epoch)
        if not entries:
            return 0
        self._wait_baseline = M.PROCESSOR_QUEUE_WAIT.snapshot()
        written = 0
        for (e_slot, index), entry in sorted(entries.items()):
            if e_slot != slot:
                continue
            bits = (True,) * len(entry.members)
            key = None
            try:
                data = chain.produce_attestation_data(slot, index)
                domain = get_domain(
                    state, DOMAIN_BEACON_ATTESTER, epoch, chain.preset
                )
                root = compute_signing_root(data, domain)
                key = (
                    bytes(root),
                    bits,
                    slot,
                    index,
                    entry.shuffling_key,
                )
                if key in self._memo:
                    continue
                sig_bytes = self.signature_source(
                    data, entry.members, root
                )
            except Exception:  # noqa: BLE001 -- speculation must never
                # break the node: a failed prediction is just a future
                # confirm-miss
                continue
            if sig_bytes is None:
                continue
            # a REAL verification (device batch of one, precomputed
            # aggregate pubkey): only a True verdict is ever memoized.
            # Routed on the SPECULATIVE lane: under continuous batching
            # this work is preempted at any launch boundary where real
            # arrivals are queued (it stays queued, never dropped)
            s = SignatureSet.multiple_pubkeys(
                Signature.from_bytes(bytes(sig_bytes)), [entry.full_pk], root
            )
            if verify_signature_sets_async(
                [s], lane="speculative", slot=slot
            ).result():
                self._memo[key] = bytes(sig_bytes)
                written += 1
                self.stats["preverified"] += 1
                M.SPECULATE_PREVERIFIED.inc()
        if len(self._memo) > _MAX_MEMO:
            self.prune(slot - 2)
        return written

    # -- confirm-on-arrival (critical path) ----------------------------------

    def confirm(
        self, message, bits, slot, index, shuffling_key, signature_bytes
    ) -> bool:
        """True iff this exact claim was pre-verified: memo hit AND the
        arriving signature bytes equal the verified ones. Counts the
        outcome either way; False always means "verify normally"."""
        key = (bytes(message), tuple(bits), int(slot), int(index),
               shuffling_key)
        expected = self._memo.get(key)
        if expected is None:
            self.stats["confirm_misses"] += 1
            M.SPECULATE_CONFIRM_MISSES.inc()
            return False
        if bytes(signature_bytes) != expected:
            # same expected message but a different signature: a forgery
            # or non-canonical encoding — never trusted
            self.stats["mismatches"] += 1
            M.SPECULATE_MISMATCHES.inc()
            return False
        self.stats["confirms"] += 1
        M.SPECULATE_CONFIRMS.inc()
        return True

    def prune(self, min_slot: int) -> None:
        """Drop memo entries for slots before `min_slot` (stale
        speculations can never confirm: gossip's propagation window has
        passed)."""
        stale = [k for k in self._memo if k[2] < min_slot]
        for k in stale:
            del self._memo[k]

    def __len__(self) -> int:
        return len(self._memo)

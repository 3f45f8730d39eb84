"""Gossip attestation verification with batched signature checks on the card
(reference beacon_node/beacon_chain/src/attestation_verification.rs +
attestation_verification/batch.rs:31-222).

Pipeline per the reference's typestate flow: cheap early checks (slot
window, structure, first-seen dedup, committee lookup) run per item; all
surviving items' signature sets go to the backend in ONE
verify_signature_sets call (1 set per unaggregated attestation; 3 per
aggregate: selection proof, aggregate signature, indexed attestation).

Two upgrades over the reference's batch.rs:

  * verification is ASYNC-first: ``submit_*_batch`` marshals and
    dispatches through ``verify_signature_sets_async`` and returns a
    :class:`PendingBatch`; the sync ``batch_verify_*`` entry points are
    submit+complete in one call, so results are identical. The
    BeaconProcessor resolves pending batches instead of blocking its
    workers (double-buffering: batch N+1 marshals while N computes).
  * a failed batch isolates its invalid sets by BISECTION -- O(k log n)
    backend calls for k bad items instead of the reference's O(n)
    per-item fallback (batch.rs:122-133) -- keeping the no-censorship
    guarantee: every valid item in a poisoned batch is still accepted.

The bisection is also the failure-attribution half of the MEGA-PAIRING
(crypto/bls/aggregation.py): the aggregated path collapses a whole
slot's attestations into ~distinct-messages Miller pairs, so a reject
names only the batch -- every sub-batch the bisection re-verifies runs
through the same aggregated backend, and the O(k log n) search pins the
k forged items exactly as it does on the per-set path
(tests/test_bls_aggregation.py plants forgeries and asserts this).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.bls.api import verify_signature_sets, verify_signature_sets_async
from ..utils import metrics as M
from ..utils import tracing
from ..state_transition.context import ConsensusContext
from ..state_transition.signature_sets import (
    aggregate_and_proof_signature_set,
    indexed_attestation_signature_set,
    selection_proof_signature_set,
)
from ..types import compute_epoch_at_slot
from ..types.helpers import hash32

ATTESTATION_PROPAGATION_SLOT_RANGE = 32


class AttestationError(ValueError):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class VerifiedUnaggregated:
    attestation: object
    indexed_indices: list
    attester_index: int
    # the full IndexedAttestation (slasher feed; the batch already built it)
    indexed: object = None


@dataclass
class VerifiedAggregate:
    signed_aggregate: object
    indexed_indices: list
    indexed: object = None


@dataclass
class PendingBatch:
    """A dispatched attestation batch: the signature verdict is in
    flight on the device; ``complete()`` resolves it, runs the bisection
    fallback if needed, and finishes post-verification observation.
    ``done()`` never blocks, so a scheduler can poll."""

    future: object
    _complete: object

    def done(self) -> bool:
        return self.future is None or self.future.done()

    def complete(self):
        return self._complete()


def bisect_batch_failures(items, sets_of, verify=None):
    """A batch containing >=1 invalid set failed as a whole: isolate the
    invalid ITEMS with O(k log n) further backend calls (k = number of
    invalid items) instead of O(n) per-item re-verification.

    Per invalid item: binary-search the smallest failing prefix
    (ceil(log2 n) calls -- batch validity of any sub-batch is itself one
    backend call), then one call certifies the remaining tail clean or
    restarts the search inside it. One bad item in a 1024-item batch
    costs ceil(log2 1024) + 1 = 11 extra calls. Returns
    (ok_items, bad_items); every call bumps BLS_BISECTION_CALLS and every
    isolated item BLS_BISECTION_BAD_ITEMS (the attribution rate of the
    mega-pairing's all-or-nothing verdict).
    """
    verify = verify or verify_signature_sets

    def check(group) -> bool:
        M.BLS_BISECTION_CALLS.inc()
        return verify([s for item in group for s in sets_of(item)])

    ok, bad = [], []
    group = list(items)
    # loop invariant: check(group) is known False (>=1 bad inside)
    while group:
        if len(group) == 1:
            bad.append(group[0])
            break
        # smallest m with first m items invalid as a sub-batch: item m-1
        # is the FIRST bad item, items 0..m-2 are certified good
        lo, hi = 0, len(group)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if check(group[:mid]):
                lo = mid
            else:
                hi = mid
        ok.extend(group[: hi - 1])
        bad.append(group[hi - 1])
        group = group[hi:]
        if group and check(group):
            ok.extend(group)
            break
    M.BLS_BISECTION_BAD_ITEMS.inc(len(bad))
    return ok, bad


def is_aggregator(committee_len: int, selection_proof: bytes, spec) -> bool:
    """Spec is_aggregator: hash(selection_proof) picks ~TARGET_AGGREGATORS
    members per committee."""
    modulo = max(
        1, committee_len // spec.target_aggregators_per_committee
    )
    return (
        int.from_bytes(hash32(bytes(selection_proof))[:8], "little") % modulo
        == 0
    )


def _early_checks_unaggregated(chain, attestation):
    data = attestation.data
    current = chain.current_slot
    if not (
        data.slot
        <= current
        <= data.slot + ATTESTATION_PROPAGATION_SLOT_RANGE
    ):
        raise AttestationError("outside propagation slot range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, chain.preset):
        raise AttestationError("target epoch does not match slot")
    bits = list(attestation.aggregation_bits)
    if sum(bits) != 1:
        raise AttestationError("not exactly one aggregation bit")
    if bytes(data.beacon_block_root) not in chain._states:
        raise AttestationError("unknown head block")
    return bits.index(True)


def _setup_unaggregated_batch(
    chain, attestations, observed_attesters, ctxt, state, get_pubkey,
    survivors, rejected, batch_seen,
):
    for att in attestations:
        try:
            pos = _early_checks_unaggregated(chain, att)
            cache = ctxt.committee_cache(state, att.data.target.epoch)
            committee = cache.get_beacon_committee(
                att.data.slot, att.data.index
            )
            if len(committee) != len(list(att.aggregation_bits)):
                raise AttestationError("bits/committee length mismatch")
            attester = committee[pos]
            # peek only: marking happens AFTER signature verification, so a
            # forged message cannot censor the real one (the reference
            # observes post-verification for the same reason)
            key = (att.data.target.epoch, attester)
            if (
                observed_attesters.is_known(*key) or key in batch_seen
            ):
                raise AttestationError("attester already seen this epoch")
            batch_seen.add(key)
            indexed = ctxt.get_indexed_attestation(state, att)
            s = indexed_attestation_signature_set(
                state, get_pubkey, indexed, chain.preset, chain.spec
            )
            survivors.append((att, s, indexed, attester))
        except (AttestationError, ValueError) as e:
            rejected.append((att, str(e)))


def submit_unaggregated_batch(
    chain, attestations, observed_attesters, ctxt: ConsensusContext | None = None
) -> PendingBatch:
    """Phase 1 of the gossip attestation batch: early checks, set
    building, and ONE async backend dispatch. Returns a PendingBatch
    whose ``complete()`` yields (verified, rejected) exactly like
    ``batch_verify_unaggregated``. Between submit and complete the
    caller is free to marshal the next batch -- the device is busy, not
    the host."""
    ctxt = ctxt or ConsensusContext(chain.preset, chain.spec)
    state = chain.head_state
    get_pubkey = chain.pubkey_cache.getter(state)

    survivors = []
    rejected = []
    batch_seen: set = set()
    with M.ATTN_BATCH_SETUP_TIMES.time(), tracing.span(
        "att_setup", n=len(attestations)
    ):
        _setup_unaggregated_batch(
            chain, attestations, observed_attesters, ctxt, state,
            get_pubkey, survivors, rejected, batch_seen,
        )
    future = (
        verify_signature_sets_async(
            [s for _, s, _, _ in survivors],
            lane="unaggregated",
            slot=min(int(att.data.slot) for att, _, _, _ in survivors),
        )
        if survivors
        else None
    )
    # the submitting span context: complete() may run on another worker
    # after a DeferredWork hand-off, but its spans stay in this trace
    submit_ctx = tracing.current()

    def complete():
        verified = []
        if survivors:
            # NOTE the metric's meaning under the async path: this times
            # the residual wait for the verdict plus any bisection -- the
            # worker-visible cost -- not raw device time, which overlaps
            # the next batch's marshalling (see utils/metrics.py help)
            with M.ATTN_BATCH_VERIFY_TIMES.time(), tracing.span(
                "att_verify_wait", parent=submit_ctx, n=len(survivors)
            ):
                batch_ok = future.result()
                if not batch_ok:
                    # bisection fallback: O(k log n) backend calls
                    # isolate the k poisoned items (vs batch.rs:122-133
                    # O(n))
                    with tracing.span("att_bisect", n=len(survivors)):
                        ok_items, bad_items = bisect_batch_failures(
                            survivors, lambda item: [item[1]]
                        )
            if batch_ok:
                ok_items = survivors
            else:
                for item in bad_items:
                    rejected.append((item[0], "invalid signature"))
            for att, _, indexed, attester in ok_items:
                if observed_attesters.observe(
                    att.data.target.epoch, attester
                ):
                    # an overlapped batch marked this attester between our
                    # submit and complete: late cross-batch dedup
                    rejected.append(
                        (att, "attester already seen this epoch")
                    )
                    continue
                verified.append(
                    VerifiedUnaggregated(
                        att, list(indexed.attesting_indices), attester,
                        indexed,
                    )
                )
            M.ATTESTATIONS_PROCESSED.inc(len(verified))
            if chain.validator_monitor is not None:
                for v in verified:
                    chain.validator_monitor.on_gossip_attestation(
                        v.indexed_indices, v.attestation.data.slot
                    )
        return verified, rejected

    return PendingBatch(future, complete)


def batch_verify_unaggregated(
    chain, attestations, observed_attesters, ctxt: ConsensusContext | None = None
):
    """[(attestation)] -> (verified: [VerifiedUnaggregated],
    rejected: [(attestation, reason)]). ONE backend call for the batch
    (beacon_chain.rs:1696 batch_verify_unaggregated_attestations_for_gossip);
    submit + complete back-to-back (the synchronous entry point).
    """
    return submit_unaggregated_batch(
        chain, attestations, observed_attesters, ctxt
    ).complete()


def _early_checks_aggregate(
    chain, signed_aggregate, observed_aggregates, observed_aggregators, ctxt
):
    msg = signed_aggregate.message
    data = msg.aggregate.data
    current = chain.current_slot
    if not (
        data.slot <= current <= data.slot + ATTESTATION_PROPAGATION_SLOT_RANGE
    ):
        raise AttestationError("outside propagation slot range")
    # epoch sanity BEFORE it touches any cache (an attacker-chosen epoch
    # must never drive cache pruning)
    epoch = data.target.epoch
    if epoch != compute_epoch_at_slot(data.slot, chain.preset):
        raise AttestationError("target epoch does not match slot")
    if not any(msg.aggregate.aggregation_bits):
        raise AttestationError("empty aggregation bits")
    if bytes(data.beacon_block_root) not in chain._states:
        raise AttestationError("unknown head block")
    agg_root = msg.aggregate.tree_hash_root()
    # peek only; marking happens post-verification
    if observed_aggregates.is_known(epoch, agg_root):
        raise AttestationError("aggregate already seen")
    if observed_aggregators.is_known(epoch, msg.aggregator_index):
        raise AttestationError("aggregator already seen this epoch")
    state = chain.head_state
    cache = ctxt.committee_cache(state, epoch)
    committee = cache.get_beacon_committee(data.slot, data.index)
    if msg.aggregator_index not in committee:
        raise AttestationError("aggregator not in committee")
    if not is_aggregator(
        len(committee), msg.selection_proof, chain.spec
    ):
        raise AttestationError("invalid aggregator selection")
    return agg_root


def _setup_aggregate_batch(
    chain, signed_aggregates, observed_aggregates, observed_aggregators,
    ctxt, state, get_pubkey, survivors, rejected, batch_seen,
):
    for agg in signed_aggregates:
        try:
            agg_root = _early_checks_aggregate(
                chain, agg, observed_aggregates, observed_aggregators, ctxt
            )
            epoch = agg.message.aggregate.data.target.epoch
            keys = (
                (epoch, agg_root),
                (epoch, agg.message.aggregator_index),
            )
            if any(k in batch_seen for k in keys):
                raise AttestationError("aggregate already seen")
            batch_seen.update(keys)
            indexed = ctxt.get_indexed_attestation(
                state, agg.message.aggregate
            )
            ind = indexed_attestation_signature_set(
                state, get_pubkey, indexed, chain.preset, chain.spec
            )
            # speculation hook (speculate/): may drop the indexed set
            # (pre-verified, confirmed by lookup) or swap in a set whose
            # single pubkey is the precomputed committee aggregate
            # (identical point => identical verdict). Miss/mismatch keeps
            # the original set — never trust-on-predict.
            speculation = getattr(chain, "speculation", None)
            if speculation is not None:
                ind = speculation.process_indexed_set(
                    state, agg.message.aggregate, indexed, ind
                )
            sets = [
                selection_proof_signature_set(
                    state, get_pubkey, agg, chain.preset, chain.spec
                ),
                aggregate_and_proof_signature_set(
                    state, get_pubkey, agg, chain.preset, chain.spec
                ),
            ]
            if ind is not None:
                sets.append(ind)
            survivors.append((agg, sets, indexed))
        except (AttestationError, ValueError) as e:
            rejected.append((agg, str(e)))


def submit_aggregate_batch(
    chain,
    signed_aggregates,
    observed_aggregates,
    observed_aggregators,
    ctxt: ConsensusContext | None = None,
) -> PendingBatch:
    """Phase 1 of the aggregate-and-proof batch: early checks, THREE
    sets per item (selection proof, aggregate-and-proof signature,
    indexed attestation; batch.rs:77-107), one async dispatch."""
    ctxt = ctxt or ConsensusContext(chain.preset, chain.spec)
    state = chain.head_state
    get_pubkey = chain.pubkey_cache.getter(state)

    survivors = []
    rejected = []
    batch_seen: set = set()
    with tracing.span("agg_setup", n=len(signed_aggregates)):
        _setup_aggregate_batch(
            chain, signed_aggregates, observed_aggregates,
            observed_aggregators, ctxt, state, get_pubkey,
            survivors, rejected, batch_seen,
        )

    future = (
        verify_signature_sets_async(
            [s for _, sets, _ in survivors for s in sets],
            lane="aggregate",
            slot=min(
                int(agg.message.aggregate.data.slot)
                for agg, _, _ in survivors
            ),
        )
        if survivors
        else None
    )
    submit_ctx = tracing.current()

    def complete():
        verified = []
        if survivors:
            with tracing.span(
                "agg_verify_wait", parent=submit_ctx, n=len(survivors)
            ):
                batch_ok = future.result()
                if not batch_ok:
                    with tracing.span("agg_bisect", n=len(survivors)):
                        ok_items, bad_items = bisect_batch_failures(
                            survivors, lambda item: item[1]
                        )
            if batch_ok:
                ok_items = survivors
            else:
                for item in bad_items:
                    rejected.append((item[0], "invalid signature"))
            for agg, _, indexed in ok_items:
                epoch = agg.message.aggregate.data.target.epoch
                already = observed_aggregates.observe(
                    epoch, agg.message.aggregate.tree_hash_root()
                )
                already |= observed_aggregators.observe(
                    epoch, agg.message.aggregator_index
                )
                if already:
                    # marked by an overlapped batch after our submit
                    rejected.append((agg, "aggregate already seen"))
                    continue
                verified.append(
                    VerifiedAggregate(
                        agg, list(indexed.attesting_indices), indexed
                    )
                )
        return verified, rejected

    return PendingBatch(future, complete)


def batch_verify_aggregates(
    chain,
    signed_aggregates,
    observed_aggregates,
    observed_aggregators,
    ctxt: ConsensusContext | None = None,
):
    """Batched aggregate-and-proof verification, submit + complete in
    one call (the synchronous entry point; bisection on batch failure)."""
    return submit_aggregate_batch(
        chain,
        signed_aggregates,
        observed_aggregates,
        observed_aggregators,
        ctxt,
    ).complete()

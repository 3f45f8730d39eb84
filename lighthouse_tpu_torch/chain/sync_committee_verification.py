"""Gossip verification for sync-committee messages and signed
contribution-and-proofs (reference
beacon_node/beacon_chain/src/sync_committee_verification.rs:1-665), with
the repo's batch-first shape: early checks + dedup per item, then ONE
batched ASYNC signature-set dispatch (`verify_signature_sets_async`,
lane="sync") with bisection fallback -- the same submit/complete
PendingBatch structure as attestation_verification.py, so the sync lane
rides the pipeline overlap and the continuous-batching scheduler exactly
like the attestation lanes.

Also houses the naive per-subcommittee aggregation pool (the analogue of
naive_aggregation_pool.rs for sync messages) and the contribution pool
that block production draws its SyncAggregate from (op-pool's
sync_aggregate seat, operation_pool/src/sync_aggregate_id.rs).

The port's copy of lighthouse_tpu/chain/sync_committee_verification.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.bls.api import (
    AggregateSignature,
    Signature,
    verify_signature_sets_async,
)
from ..state_transition.context import ConsensusContext
from ..state_transition.signature_sets import (
    contribution_and_proof_signature_set,
    sync_committee_contribution_signature_set,
    sync_committee_message_set,
    sync_selection_proof_signature_set,
)
from ..types.helpers import hash32
from .attestation_verification import PendingBatch, bisect_batch_failures


class SyncCommitteeError(ValueError):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class VerifiedSyncMessage:
    message: object
    subnet_id: int
    positions: list  # positions within the subcommittee


@dataclass
class VerifiedContribution:
    signed_contribution: object
    participant_count: int


def sync_subcommittee_pubkeys(state, preset, subcommittee_index: int):
    """The pubkeys of one subnet's slice of the CURRENT sync committee."""
    size = preset.sync_subcommittee_size
    start = subcommittee_index * size
    return list(state.current_sync_committee.pubkeys[start : start + size])


def sync_committee_positions(state, preset) -> dict[bytes, list[int]]:
    """pubkey -> committee positions, one pass over the committee (the
    per-validator lookup table duties_service/sync.rs builds per period)."""
    if not hasattr(state, "current_sync_committee"):
        raise SyncCommitteeError("head state predates altair")
    out: dict[bytes, list[int]] = {}
    for i, committee_pk in enumerate(state.current_sync_committee.pubkeys):
        out.setdefault(bytes(committee_pk), []).append(i)
    return out


def subnets_for_sync_validator(
    state, preset, validator_index: int, positions=None
):
    """subnet id -> positions-in-subcommittee for a validator (spec
    compute_subnets_for_sync_committee). Pass a `sync_committee_positions`
    table when resolving many validators to avoid rescanning the committee
    per index."""
    if positions is None:
        positions = sync_committee_positions(state, preset)
    pk = bytes(state.validators[validator_index].pubkey)
    size = preset.sync_subcommittee_size
    out: dict[int, list[int]] = {}
    for i in positions.get(pk, ()):
        out.setdefault(i // size, []).append(i % size)
    return out


def is_sync_committee_aggregator(selection_proof: bytes, preset, spec) -> bool:
    """Spec is_sync_committee_aggregator."""
    modulo = max(
        1,
        preset.sync_committee_size
        // preset.sync_committee_subnet_count
        // spec.target_aggregators_per_sync_subcommittee,
    )
    return (
        int.from_bytes(hash32(bytes(selection_proof))[:8], "little") % modulo
        == 0
    )


class ObservedSyncContributors:
    """Dedup (slot, subcommittee, validator) -- observed_attesters.rs's
    sync flavor."""

    def __init__(self, retained_slots: int = 8):
        self.retained_slots = retained_slots
        self._seen: dict[tuple, set] = {}

    def observe(self, slot: int, subnet: int, validator_index: int) -> bool:
        s = self._seen.setdefault((slot, subnet), set())
        fresh = validator_index not in s
        s.add(validator_index)
        self._prune(slot)
        return fresh

    def is_known(self, slot: int, subnet: int, validator_index: int) -> bool:
        return validator_index in self._seen.get((slot, subnet), ())

    def _prune(self, current_slot: int) -> None:
        cutoff = current_slot - self.retained_slots
        for key in [k for k in self._seen if k[0] < cutoff]:
            del self._seen[key]


class ObservedSyncAggregators(ObservedSyncContributors):
    """Dedup (slot, subcommittee, aggregator_index)."""


def _early_checks_message(chain, message, subnet_id: int):
    if message.slot != chain.current_slot and message.slot + 1 != chain.current_slot:
        raise SyncCommitteeError("message not for the current slot")
    state = chain.head_state
    if message.validator_index >= len(state.validators):
        raise SyncCommitteeError("unknown validator index")
    subnets = subnets_for_sync_validator(
        state, chain.preset, message.validator_index
    )
    if subnet_id not in subnets:
        raise SyncCommitteeError("validator not in this sync subnet")
    return subnets[subnet_id]


def submit_sync_message_batch(
    chain, items, observed_contributors, ctxt: ConsensusContext | None = None
) -> PendingBatch:
    """Phase 1 of the sync-message batch: early checks, set building,
    ONE async dispatch on the sync lane. Returns a PendingBatch whose
    ``complete()`` yields (verified, rejected) exactly like
    ``batch_verify_sync_messages``."""
    state = chain.head_state
    get_pubkey = chain.pubkey_cache.getter(state)

    survivors = []
    rejected = []
    batch_seen: set = set()
    for message, subnet_id in items:
        try:
            positions = _early_checks_message(chain, message, subnet_id)
            key = (message.slot, subnet_id, message.validator_index)
            if observed_contributors.is_known(*key) or key in batch_seen:
                raise SyncCommitteeError(
                    "validator already contributed for this slot/subnet"
                )
            batch_seen.add(key)
            s = sync_committee_message_set(
                state, get_pubkey, message, chain.preset, chain.spec
            )
            survivors.append((message, subnet_id, positions, s, key))
        except (SyncCommitteeError, ValueError) as e:
            rejected.append((message, str(e)))

    future = (
        verify_signature_sets_async(
            [s for _, _, _, s, _ in survivors],
            lane="sync",
            slot=min(int(m.slot) for m, _, _, _, _ in survivors),
        )
        if survivors
        else None
    )

    def complete():
        verified = []
        if survivors:
            if future.result():
                ok_items = survivors
            else:
                # bisection fallback: O(k log n) backend calls isolate
                # the k poisoned messages (was O(n) per-item re-verify)
                ok_items, bad_items = bisect_batch_failures(
                    survivors, lambda item: [item[3]]
                )
                for item in bad_items:
                    rejected.append((item[0], "invalid signature"))
            for message, subnet_id, positions, _, key in ok_items:
                observed_contributors.observe(*key)
                verified.append(
                    VerifiedSyncMessage(message, subnet_id, positions)
                )
        return verified, rejected

    return PendingBatch(future, complete)


def batch_verify_sync_messages(
    chain, items, observed_contributors, ctxt: ConsensusContext | None = None
):
    """[(message, subnet_id)] -> (verified: [VerifiedSyncMessage],
    rejected: [(message, reason)]). Submit + complete back-to-back (the
    synchronous entry point)."""
    return submit_sync_message_batch(
        chain, items, observed_contributors, ctxt
    ).complete()


def _early_checks_contribution(
    chain, signed, observed_aggregators, observed_contributions
):
    msg = signed.message
    contribution = msg.contribution
    if (
        contribution.slot != chain.current_slot
        and contribution.slot + 1 != chain.current_slot
    ):
        raise SyncCommitteeError("contribution not for the current slot")
    preset = chain.preset
    if contribution.subcommittee_index >= preset.sync_committee_subnet_count:
        raise SyncCommitteeError("bad subcommittee index")
    if not any(contribution.aggregation_bits):
        raise SyncCommitteeError("empty contribution")
    if not is_sync_committee_aggregator(
        msg.selection_proof, preset, chain.spec
    ):
        raise SyncCommitteeError("selection proof does not select aggregator")
    state = chain.head_state
    subnets = subnets_for_sync_validator(state, preset, msg.aggregator_index)
    if contribution.subcommittee_index not in subnets:
        raise SyncCommitteeError("aggregator not in the subcommittee")
    agg_key = (
        contribution.slot,
        int(contribution.subcommittee_index),
        int(msg.aggregator_index),
    )
    if observed_aggregators.is_known(*agg_key):
        raise SyncCommitteeError("aggregator already seen for this slot")
    root = contribution.tree_hash_root()
    if observed_contributions.is_known(contribution.slot, root):
        raise SyncCommitteeError("contribution (or superset) already known")
    return agg_key, root


def submit_contribution_batch(
    chain,
    signed_contributions,
    observed_aggregators,
    observed_contributions,
    ctxt: ConsensusContext | None = None,
) -> PendingBatch:
    """Phase 1 of the contribution-and-proof batch: early checks, three
    sets per item (selection proof, contribution-and-proof signature,
    aggregate contribution signature --
    sync_committee_verification.rs's triple), ONE async dispatch on the
    sync lane."""
    state = chain.head_state
    preset = chain.preset
    get_pubkey = chain.pubkey_cache.getter(state)

    survivors = []
    rejected = []
    batch_seen: set = set()
    for signed in signed_contributions:
        try:
            agg_key, root = _early_checks_contribution(
                chain, signed, observed_aggregators, observed_contributions
            )
            if agg_key in batch_seen:
                raise SyncCommitteeError("duplicate aggregator in batch")
            batch_seen.add(agg_key)
            contribution = signed.message.contribution
            subkeys = sync_subcommittee_pubkeys(
                state, preset, int(contribution.subcommittee_index)
            )
            sets = [
                sync_selection_proof_signature_set(
                    state, get_pubkey, signed, preset, chain.spec
                ),
                contribution_and_proof_signature_set(
                    state, get_pubkey, signed, preset, chain.spec
                ),
            ]
            agg_set = sync_committee_contribution_signature_set(
                state, signed, subkeys, preset, chain.spec,
                resolve_pubkey=chain.pubkey_cache.resolve,
            )
            if agg_set is not None:
                sets.append(agg_set)
            count = sum(contribution.aggregation_bits)
            survivors.append((signed, sets, agg_key, root, count))
        except (SyncCommitteeError, ValueError) as e:
            rejected.append((signed, str(e)))

    future = (
        verify_signature_sets_async(
            [s for _, sets, _, _, _ in survivors for s in sets],
            lane="sync",
            slot=min(
                int(signed.message.contribution.slot)
                for signed, _, _, _, _ in survivors
            ),
        )
        if survivors
        else None
    )

    def complete():
        verified = []
        if survivors:
            if future.result():
                ok_items = survivors
            else:
                ok_items, bad_items = bisect_batch_failures(
                    survivors, lambda item: item[1]
                )
                for item in bad_items:
                    rejected.append((item[0], "invalid signature"))
            for signed, _, agg_key, root, count in ok_items:
                observed_aggregators.observe(*agg_key)
                observed_contributions.observe(
                    signed.message.contribution.slot, root
                )
                verified.append(VerifiedContribution(signed, count))
        return verified, rejected

    return PendingBatch(future, complete)


def batch_verify_contributions(
    chain,
    signed_contributions,
    observed_aggregators,
    observed_contributions,
    ctxt: ConsensusContext | None = None,
):
    """[SignedContributionAndProof] -> (verified, rejected). Submit +
    complete back-to-back (the synchronous entry point; bisection on
    batch failure)."""
    return submit_contribution_batch(
        chain,
        signed_contributions,
        observed_aggregators,
        observed_contributions,
        ctxt,
    ).complete()


# --- pools -------------------------------------------------------------------


class SyncMessagePool:
    """Naive aggregation of verified sync messages into per-subcommittee
    contributions (naive_aggregation_pool.rs, sync flavor)."""

    def __init__(self, preset, retained_slots: int = 8):
        self.preset = preset
        self.retained_slots = retained_slots
        # (slot, block_root, subnet) -> {position: signature_bytes}
        self._msgs: dict[tuple, dict[int, bytes]] = {}

    def insert(self, verified: VerifiedSyncMessage) -> None:
        m = verified.message
        key = (int(m.slot), bytes(m.beacon_block_root), verified.subnet_id)
        slot_msgs = self._msgs.setdefault(key, {})
        for pos in verified.positions:
            slot_msgs.setdefault(pos, bytes(m.signature))
        self._prune(int(m.slot))

    def get_contribution(self, t, slot: int, block_root: bytes, subnet: int):
        """Build a SyncCommitteeContribution from pooled messages."""
        msgs = self._msgs.get((slot, bytes(block_root), subnet))
        if not msgs:
            return None
        bits = [False] * self.preset.sync_subcommittee_size
        sigs = []
        for pos, sig in msgs.items():
            bits[pos] = True
            sigs.append(Signature.from_bytes(sig))
        agg = AggregateSignature.aggregate(sigs)
        return t.SyncCommitteeContribution(
            slot=slot,
            beacon_block_root=bytes(block_root),
            subcommittee_index=subnet,
            aggregation_bits=tuple(bits),
            signature=agg.to_signature().to_bytes(),
        )

    def _prune(self, current_slot: int) -> None:
        cutoff = current_slot - self.retained_slots
        for key in [k for k in self._msgs if k[0] < cutoff]:
            del self._msgs[key]


class SyncContributionPool:
    """Verified contributions -> the block producer's SyncAggregate
    (operation_pool's sync-aggregate seat): per subcommittee keep the
    best (most participants) contribution, then OR the bits and aggregate
    the four signatures."""

    def __init__(self, preset, retained_slots: int = 8):
        self.preset = preset
        self.retained_slots = retained_slots
        # (slot, block_root) -> {subnet: (count, contribution)}
        self._best: dict[tuple, dict[int, tuple[int, object]]] = {}

    def insert(self, verified: VerifiedContribution) -> None:
        c = verified.signed_contribution.message.contribution
        key = (int(c.slot), bytes(c.beacon_block_root))
        per_subnet = self._best.setdefault(key, {})
        subnet = int(c.subcommittee_index)
        cur = per_subnet.get(subnet)
        if cur is None or verified.participant_count > cur[0]:
            per_subnet[subnet] = (verified.participant_count, c)
        self._prune(int(c.slot))

    def get_sync_aggregate(self, t, slot: int, block_root: bytes):
        """SyncAggregate for a block at slot+1 referencing `block_root`
        (participants signed the PREVIOUS slot's head)."""
        per_subnet = self._best.get((slot, bytes(block_root)))
        size = self.preset.sync_committee_size
        sub = self.preset.sync_subcommittee_size
        bits = [False] * size
        sigs = []
        if per_subnet:
            for subnet, (_, c) in per_subnet.items():
                for i, bit in enumerate(c.aggregation_bits):
                    if bit:
                        bits[subnet * sub + i] = True
                sigs.append(Signature.from_bytes(bytes(c.signature)))
        agg = t.SyncAggregate()
        agg.sync_committee_bits = tuple(bits)
        if sigs:
            agg.sync_committee_signature = (
                AggregateSignature.aggregate(sigs).to_signature().to_bytes()
            )
        else:
            from ..crypto.bls.api import INFINITY_SIGNATURE

            agg.sync_committee_signature = INFINITY_SIGNATURE
        return agg

    def _prune(self, current_slot: int) -> None:
        cutoff = current_slot - self.retained_slots
        for key in [k for k in self._best if k[0] < cutoff]:
            del self._best[key]

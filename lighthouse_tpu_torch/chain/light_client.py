"""Light-client data (reference consensus/types/src/light_client_
{bootstrap,update,finality_update,optimistic_update}.rs + the
light_client_bootstrap RPC protocol, rpc/protocol.rs:156): the objects a
light client needs to trustlessly follow the chain from a weak-
subjectivity root, built from real states with real merkle branches
(ssz/merkle_proof.py) over the altair state layout.

Spec generalized indices (light_client_update.rs:11-21): the altair
BeaconState has 24 fields -> a depth-5 field tree, so
current_sync_committee (field 22) lives at gindex 54, next_sync_committee
(field 23) at 55, and finalized_checkpoint.root at 105 (field 20's
checkpoint subtree, right child). This repo's field order matches the
spec's, which the tests pin.

NOTE: no `from __future__ import annotations` -- @container consumes
annotations as live SSZ descriptors (types/containers.py header).

The port's copy of lighthouse_tpu/chain/light_client.py.
"""

import functools

from ..ssz import Bytes32, Bytes96, Vector, container, uint64
from ..ssz.merkle_proof import MerkleTree, verify_merkle_proof
from ..types import types_for
from ..types.containers import BeaconBlockHeader

CURRENT_SYNC_COMMITTEE_INDEX = 54
NEXT_SYNC_COMMITTEE_INDEX = 55
FINALIZED_ROOT_INDEX = 105

CURRENT_SYNC_COMMITTEE_PROOF_LEN = 5
NEXT_SYNC_COMMITTEE_PROOF_LEN = 5
FINALIZED_ROOT_PROOF_LEN = 6


class LightClientError(ValueError):
    pass


@functools.lru_cache(maxsize=None)
def light_client_types(preset):
    t = types_for(preset)

    @container
    class LightClientBootstrap:
        header: BeaconBlockHeader.ssz_type
        current_sync_committee: t.SyncCommittee.ssz_type
        current_sync_committee_branch: Vector(
            Bytes32, CURRENT_SYNC_COMMITTEE_PROOF_LEN
        )

    @container
    class LightClientUpdate:
        attested_header: BeaconBlockHeader.ssz_type
        next_sync_committee: t.SyncCommittee.ssz_type
        next_sync_committee_branch: Vector(
            Bytes32, NEXT_SYNC_COMMITTEE_PROOF_LEN
        )
        finalized_header: BeaconBlockHeader.ssz_type
        finality_branch: Vector(Bytes32, FINALIZED_ROOT_PROOF_LEN)
        sync_aggregate: t.SyncAggregate.ssz_type
        signature_slot: uint64

    @container
    class LightClientFinalityUpdate:
        attested_header: BeaconBlockHeader.ssz_type
        finalized_header: BeaconBlockHeader.ssz_type
        finality_branch: Vector(Bytes32, FINALIZED_ROOT_PROOF_LEN)
        sync_aggregate: t.SyncAggregate.ssz_type
        signature_slot: uint64

    @container
    class LightClientOptimisticUpdate:
        attested_header: BeaconBlockHeader.ssz_type
        sync_aggregate: t.SyncAggregate.ssz_type
        signature_slot: uint64

    from types import SimpleNamespace

    return SimpleNamespace(
        LightClientBootstrap=LightClientBootstrap,
        LightClientUpdate=LightClientUpdate,
        LightClientFinalityUpdate=LightClientFinalityUpdate,
        LightClientOptimisticUpdate=LightClientOptimisticUpdate,
    )


# -- state merkle branches ----------------------------------------------------


def _field_tree(state) -> tuple[MerkleTree, dict[str, int]]:
    from ..ssz import cached_field_roots

    # the per-instance incremental cache: repeated proof generation (an
    # unauthenticated req/resp surface) must not re-merkleize the state
    roots = cached_field_roots(state)
    return MerkleTree(roots), {
        n: i for i, (n, _) in enumerate(state.ssz_fields)
    }


def sync_committee_branch(state, which: str = "current") -> list[bytes]:
    """Depth-5 branch proving (current|next)_sync_committee against the
    state root (BeaconState::compute_merkle_proof in the reference)."""
    if not hasattr(state, "current_sync_committee"):
        raise LightClientError("state predates altair")
    tree, index = _field_tree(state)
    return tree.proof(index[f"{which}_sync_committee"])


def finality_branch(state) -> list[bytes]:
    """Depth-6 branch proving finalized_checkpoint.ROOT: one step inside
    the checkpoint container (sibling = epoch leaf), then the field tree."""
    from ..ssz import uint64 as u64

    tree, index = _field_tree(state)
    epoch_leaf = u64.hash_tree_root(state.finalized_checkpoint.epoch)
    return [epoch_leaf] + tree.proof(index["finalized_checkpoint"])


def _header_for(state) -> BeaconBlockHeader:
    """latest_block_header with the state root filled (the canonical
    header a state commits to -- from_beacon_state in the reference)."""
    from ..ssz import cached_root

    hdr = state.latest_block_header
    state_root = bytes(hdr.state_root)
    if not any(state_root):
        state_root = cached_root(state)
    return BeaconBlockHeader(
        slot=hdr.slot,
        proposer_index=hdr.proposer_index,
        parent_root=bytes(hdr.parent_root),
        state_root=state_root,
        body_root=bytes(hdr.body_root),
    )


# -- server-side construction -------------------------------------------------


def light_client_bootstrap(state, preset):
    """LightClientBootstrap::from_beacon_state."""
    if not hasattr(state, "current_sync_committee"):
        raise LightClientError("state predates altair")
    lt = light_client_types(preset)
    return lt.LightClientBootstrap(
        header=_header_for(state),
        current_sync_committee=state.current_sync_committee,
        current_sync_committee_branch=sync_committee_branch(state, "current"),
    )


def light_client_finality_update(
    attested_state, finalized_header, sync_aggregate, signature_slot, preset
):
    lt = light_client_types(preset)
    return lt.LightClientFinalityUpdate(
        attested_header=_header_for(attested_state),
        finalized_header=finalized_header,
        finality_branch=finality_branch(attested_state),
        sync_aggregate=sync_aggregate,
        signature_slot=signature_slot,
    )


def light_client_optimistic_update(
    attested_state, sync_aggregate, signature_slot, preset
):
    lt = light_client_types(preset)
    return lt.LightClientOptimisticUpdate(
        attested_header=_header_for(attested_state),
        sync_aggregate=sync_aggregate,
        signature_slot=signature_slot,
    )


def light_client_update(
    attested_state, finalized_header, sync_aggregate, signature_slot, preset
):
    lt = light_client_types(preset)
    return lt.LightClientUpdate(
        attested_header=_header_for(attested_state),
        next_sync_committee=attested_state.next_sync_committee,
        next_sync_committee_branch=sync_committee_branch(
            attested_state, "next"
        ),
        finalized_header=finalized_header,
        finality_branch=finality_branch(attested_state),
        sync_aggregate=sync_aggregate,
        signature_slot=signature_slot,
    )


# -- client-side verification -------------------------------------------------


def verify_bootstrap(bootstrap, trusted_block_root: bytes) -> None:
    """The light client's install check (spec initialize_light_client_
    store): the header must BE the trusted root, and the committee must
    prove into the header's state root."""
    header_root = bootstrap.header.tree_hash_root()
    if header_root != bytes(trusted_block_root):
        raise LightClientError(
            f"bootstrap header {header_root.hex()[:12]} is not the "
            f"trusted root {bytes(trusted_block_root).hex()[:12]}"
        )
    committee_root = bootstrap.current_sync_committee.tree_hash_root()
    if not verify_merkle_proof(
        committee_root,
        [bytes(h) for h in bootstrap.current_sync_committee_branch],
        CURRENT_SYNC_COMMITTEE_INDEX,
        bytes(bootstrap.header.state_root),
    ):
        raise LightClientError("sync committee branch does not verify")


def verify_finality_branch(update) -> None:
    """The finality proof inside a (finality) update: finalized header
    root proven at gindex 105 of the ATTESTED state."""
    if not verify_merkle_proof(
        update.finalized_header.tree_hash_root(),
        [bytes(h) for h in update.finality_branch],
        FINALIZED_ROOT_INDEX,
        bytes(update.attested_header.state_root),
    ):
        raise LightClientError("finality branch does not verify")


def verify_next_committee_branch(update) -> None:
    if not verify_merkle_proof(
        update.next_sync_committee.tree_hash_root(),
        [bytes(h) for h in update.next_sync_committee_branch],
        NEXT_SYNC_COMMITTEE_INDEX,
        bytes(update.attested_header.state_root),
    ):
        raise LightClientError("next sync committee branch does not verify")


# -- update ranking (spec is_better_update) -----------------------------------


def period_slots(preset) -> int:
    """Slots per sync-committee period — the spec constant behind period
    arithmetic, window rotation, and UPDATE_TIMEOUT."""
    return preset.slots_per_epoch * preset.epochs_per_sync_committee_period


def _period_of_slot(slot: int, preset) -> int:
    return slot // period_slots(preset)


def _epoch_of(slot: int, preset) -> int:
    return slot // preset.slots_per_epoch


def is_sync_committee_update(update) -> bool:
    return any(bytes(h) != bytes(32) for h in update.next_sync_committee_branch)


def is_finality_update(update) -> bool:
    return any(bytes(h) != bytes(32) for h in update.finality_branch)


def is_better_update(new, old, preset) -> bool:
    """Spec is_better_update (altair sync protocol): full comparison
    chain — supermajority, relevant sync-committee payload, finality,
    finality-with-matching-committee, participation, attested-slot
    recency, signature-slot recency. Drives the EF update_ranking vectors
    and best_valid_update selection."""
    new_bits = list(new.sync_aggregate.sync_committee_bits)
    old_bits = list(old.sync_aggregate.sync_committee_bits)
    max_active = len(new_bits)
    new_active = sum(new_bits)
    old_active = sum(old_bits)

    new_supermajority = new_active * 3 >= max_active * 2
    old_supermajority = old_active * 3 >= max_active * 2
    if new_supermajority != old_supermajority:
        return new_supermajority
    if not new_supermajority and new_active != old_active:
        return new_active > old_active

    def relevant_committee(u) -> bool:
        return is_sync_committee_update(u) and _period_of_slot(
            int(u.attested_header.slot), preset
        ) == _period_of_slot(int(u.signature_slot), preset)

    new_rel, old_rel = relevant_committee(new), relevant_committee(old)
    if new_rel != old_rel:
        return new_rel

    new_fin, old_fin = is_finality_update(new), is_finality_update(old)
    if new_fin != old_fin:
        return new_fin

    def finality_with_committee(u, has_fin: bool) -> bool:
        return has_fin and _period_of_slot(
            int(u.finalized_header.slot), preset
        ) == _period_of_slot(int(u.attested_header.slot), preset)

    new_fwc = finality_with_committee(new, new_fin)
    old_fwc = finality_with_committee(old, old_fin)
    if new_fwc != old_fwc:
        return new_fwc

    if new_active != old_active:
        return new_active > old_active
    if int(new.attested_header.slot) != int(old.attested_header.slot):
        return int(new.attested_header.slot) < int(old.attested_header.slot)
    return int(new.signature_slot) < int(old.signature_slot)


# -- the following light client ----------------------------------------------


class LightClientStore:
    """Spec light-client store (altair sync protocol): installs from a
    trusted bootstrap, then follows updates by verifying the SYNC
    AGGREGATE SIGNATURE over the attested header (the crypto a light
    client actually trusts), the supermajority rule, the finality and
    next-committee branches, and rotating committees across periods."""

    def __init__(
        self, trusted_block_root: bytes, bootstrap, preset, spec,
        genesis_validators_root: bytes,
    ):
        verify_bootstrap(bootstrap, trusted_block_root)
        self.preset = preset
        self.spec = spec
        self.genesis_validators_root = bytes(genesis_validators_root)
        self.finalized_header = bootstrap.header
        self.optimistic_header = bootstrap.header
        self.current_sync_committee = bootstrap.current_sync_committee
        self.next_sync_committee = None
        # spec get_safety_threshold inputs: rolling max participation over
        # the current and previous half-periods — the optimistic header
        # only follows updates with MORE than half the recent max, so a
        # single captured key cannot steer it
        self.previous_max_active_participants = 0
        self.current_max_active_participants = 0
        self._participation_window = 0
        self._last_local_window: int | None = None
        # spec LightClientStore.best_valid_update: stashed for the
        # UPDATE_TIMEOUT force-update path when finality stalls
        self.best_valid_update = None
        # parsed-pubkey cache keyed by committee root: the committee is
        # fixed for a whole sync period (8192 slots on mainnet), so the
        # per-update deserialization of up to 512 keys amortizes to zero
        self._parsed_committees: dict[bytes, list] = {}

    def _period_of(self, slot: int) -> int:
        return _period_of_slot(slot, self.preset)

    def _window_of(self, slot: int) -> int:
        return (2 * slot) // max(1, period_slots(self.preset))

    def _rotate_to(self, window: int) -> None:
        if window == self._participation_window + 1:
            self.previous_max_active_participants = (
                self.current_max_active_participants
            )
            self.current_max_active_participants = 0
            self._participation_window = window
        elif window > self._participation_window + 1:
            # >=2 windows elapsed with no verified updates: both maxes are
            # stale — zero them rather than carrying an old high-water mark
            # into the threshold (it would reject a recovered-but-lower
            # participation level for an extra half-period)
            self.previous_max_active_participants = 0
            self.current_max_active_participants = 0
            self._participation_window = window

    def process_slot(self, current_slot: int) -> None:
        """Clock-driven window rotation (spec
        process_slot_for_light_client_store's UPDATE_TIMEOUT): embedders
        call this each slot so the safety threshold DECAYS when updates
        stop arriving — otherwise a stale high-water mark would reject a
        recovered-but-lower participation level indefinitely."""
        self._last_local_window = self._window_of(current_slot)
        self._rotate_to(self._last_local_window)

    def _note_participation(self, n: int, signature_slot: int) -> None:
        """Track max participation per half-period window. Update-driven
        rotation is a fallback for undriven stores, capped at the local
        window when a clock IS driven — a verified-but-future
        signature_slot must not zero the maxes early (a lone captured key
        could then steer the threshold to 0)."""
        window = self._window_of(signature_slot)
        if self._last_local_window is not None:
            window = min(window, self._last_local_window)
        self._rotate_to(window)
        self.current_max_active_participants = max(
            self.current_max_active_participants, n
        )

    def safety_threshold(self) -> int:
        return (
            max(
                self.previous_max_active_participants,
                self.current_max_active_participants,
            )
            // 2
        )

    def _verify_sync_aggregate(
        self,
        update,
        supermajority: bool = True,
        min_participants: int | None = None,
    ) -> None:
        from ..crypto.bls.api import (
            PublicKey,
            Signature,
            SignatureSet,
            verify_signature_sets,
        )
        from ..types.chain_spec import DOMAIN_SYNC_COMMITTEE
        from ..types.containers import SigningData
        from ..types.helpers import compute_domain, compute_epoch_at_slot

        bits = list(update.sync_aggregate.sync_committee_bits)
        n = sum(bits)
        # Supermajority gates only FINALITY application; optimistic headers
        # advance above the SAFETY THRESHOLD (spec get_safety_threshold:
        # strictly more than half the recent max participation) — liveness
        # at 34-66% participation without following a lone captured key.
        if min_participants is not None:
            minimum = min_participants
        elif supermajority:
            minimum = -(-2 * len(bits) // 3)
        else:
            minimum = max(1, self.safety_threshold() + 1)
        if n < minimum:
            raise LightClientError(
                f"insufficient sync participation {n}/{len(bits)}"
            )
        sig_slot = int(update.signature_slot)
        if sig_slot <= int(update.attested_header.slot):
            raise LightClientError("signature slot not after attested slot")
        sig_period = self._period_of(sig_slot)
        store_period = self._period_of(int(self.finalized_header.slot))
        if sig_period == store_period:
            committee = self.current_sync_committee
        elif (
            sig_period == store_period + 1
            and self.next_sync_committee is not None
        ):
            committee = self.next_sync_committee
        else:
            raise LightClientError(
                f"no committee known for period {sig_period}"
            )
        committee_root = committee.tree_hash_root()
        parsed = self._parsed_committees.get(committee_root)
        if parsed is None:
            parsed = [
                PublicKey.from_bytes(bytes(pk)) for pk in committee.pubkeys
            ]
            # cap at 2: current + next is all a store ever holds, and
            # period-boundary updates alternate between them
            if len(self._parsed_committees) >= 2:
                self._parsed_committees.pop(
                    next(iter(self._parsed_committees))
                )
            self._parsed_committees[committee_root] = parsed
        pubkeys = [pk for pk, bit in zip(parsed, bits) if bit]
        # the aggregate signs the attested header root in the slot BEFORE
        # the signature slot (spec get_sync_committee_message domain)
        epoch = compute_epoch_at_slot(max(sig_slot, 1) - 1, self.preset)
        domain = compute_domain(
            DOMAIN_SYNC_COMMITTEE,
            self.spec.fork_version_at_epoch(epoch),
            self.genesis_validators_root,
        )
        root = SigningData(
            object_root=update.attested_header.tree_hash_root(),
            domain=domain,
        ).tree_hash_root()
        ok = verify_signature_sets(
            [
                SignatureSet.multiple_pubkeys(
                    Signature.from_bytes(
                        bytes(update.sync_aggregate.sync_committee_signature)
                    ),
                    pubkeys,
                    root,
                )
            ]
        )
        if not ok:
            raise LightClientError("sync aggregate signature invalid")
        # only a VERIFIED aggregate may raise the safety-threshold inputs
        self._note_participation(n, sig_slot)

    def process_update(self, update) -> None:
        """Full LightClientUpdate: signature + finality + committee
        rotation (spec process_light_client_update, reduced to the
        immediate-apply path -- every served update carries a verified
        finality proof)."""
        self._verify_sync_aggregate(update)
        verify_finality_branch(update)
        has_next = any(bytes(h) != bytes(32) for h in update.next_sync_committee_branch)
        if has_next:
            verify_next_committee_branch(update)
        att_period = self._period_of(int(update.attested_header.slot))
        store_period = self._period_of(int(self.finalized_header.slot))
        if has_next and att_period == store_period:
            self.next_sync_committee = update.next_sync_committee
        if int(update.finalized_header.slot) > int(self.finalized_header.slot):
            new_period = self._period_of(int(update.finalized_header.slot))
            if new_period > store_period:
                if self.next_sync_committee is None:
                    raise LightClientError(
                        "cannot cross a period without the next committee"
                    )
                self.current_sync_committee = self.next_sync_committee
                self.next_sync_committee = (
                    update.next_sync_committee if has_next else None
                )
            self.finalized_header = update.finalized_header
        if int(update.attested_header.slot) > int(self.optimistic_header.slot):
            self.optimistic_header = update.attested_header

    def process_finality_update(self, update) -> None:
        """LightClientFinalityUpdate: signature + finality proof, no
        committee payload."""
        self._verify_sync_aggregate(update)
        verify_finality_branch(update)
        if int(update.finalized_header.slot) > int(self.finalized_header.slot):
            if self._period_of(
                int(update.finalized_header.slot)
            ) > self._period_of(int(self.finalized_header.slot)):
                raise LightClientError(
                    "finality update crosses a period; need a full update"
                )
            self.finalized_header = update.finalized_header
        if int(update.attested_header.slot) > int(self.optimistic_header.slot):
            self.optimistic_header = update.attested_header

    def process_optimistic_update(self, update) -> None:
        """LightClientOptimisticUpdate: signature only; advances the
        optimistic head."""
        self._verify_sync_aggregate(update, supermajority=False)
        if int(update.attested_header.slot) > int(self.optimistic_header.slot):
            self.optimistic_header = update.attested_header

    # -- spec-shaped update machinery (EF light_client/sync vectors) --------

    def _update_timeout(self) -> int:
        # spec UPDATE_TIMEOUT: one sync-committee period of slots
        return period_slots(self.preset)

    def process_spec_update(self, update, current_slot: int) -> None:
        """Full spec process_light_client_update: validate (signature,
        slot ordering, period relevance, branches), stash
        best_valid_update, advance the optimistic header past the safety
        threshold, and APPLY on supermajority+finality — the exact shape
        the EF light_client/sync vectors drive."""
        bits = list(update.sync_aggregate.sync_committee_bits)
        n_active = sum(bits)
        sig_slot = int(update.signature_slot)
        attested_slot = int(update.attested_header.slot)
        finalized_slot = int(update.finalized_header.slot)
        has_finality = is_finality_update(update)
        has_committee = is_sync_committee_update(update)
        if not (current_slot >= sig_slot):
            raise LightClientError("update signed in the future")
        # full spec slot ordering (validate_light_client_update):
        # current_slot >= sig_slot > attested_slot >= finalized_slot; the
        # attested >= finalized half rides the has_finality branch below
        if not (sig_slot > attested_slot):
            raise LightClientError("signature slot not after attested slot")
        if has_finality and attested_slot < finalized_slot:
            raise LightClientError("attested before finalized")
        if not has_finality:
            # spec validate: a non-finality update must carry the EMPTY
            # finalized header — the sync aggregate signs only the
            # attested header, so an unproven non-empty finalized_header
            # would be attacker-chosen
            empty = type(update.finalized_header).default()
            if (
                update.finalized_header.tree_hash_root()
                != empty.tree_hash_root()
            ):
                raise LightClientError(
                    "non-finality update carries a finalized header"
                )
        store_period = self._period_of(int(self.finalized_header.slot))
        sig_period = self._period_of(sig_slot)
        attested_period = self._period_of(attested_slot)
        if self.next_sync_committee is not None:
            if sig_period not in (store_period, store_period + 1):
                raise LightClientError("irrelevant signature period")
        elif sig_period != store_period:
            raise LightClientError("signature period without known committee")
        update_has_next = (
            self.next_sync_committee is None
            and has_committee
            and attested_period == store_period
        )
        if attested_slot <= int(self.finalized_header.slot) and not update_has_next:
            raise LightClientError("update does not advance the store")
        if has_finality:
            verify_finality_branch(update)
        if has_committee:
            verify_next_committee_branch(update)
        # spec validate: only MIN_SYNC_COMMITTEE_PARTICIPANTS gates here
        self._verify_sync_aggregate(update, min_participants=1)

        if self.best_valid_update is None or is_better_update(
            update, self.best_valid_update, self.preset
        ):
            self.best_valid_update = update
        if (
            n_active > self.safety_threshold()
            and attested_slot > int(self.optimistic_header.slot)
        ):
            self.optimistic_header = update.attested_header
        update_has_finalized_next = (
            update_has_next
            and has_finality
            and self._period_of(finalized_slot) == attested_period
        )
        if n_active * 3 >= len(bits) * 2 and (
            finalized_slot > int(self.finalized_header.slot)
            or update_has_finalized_next
        ):
            self._apply_spec_update(update)
            self.best_valid_update = None

    def _apply_spec_update(self, update) -> None:
        """Spec apply_light_client_update: committee rotation across the
        period boundary, then finalized/optimistic header advance."""
        store_period = self._period_of(int(self.finalized_header.slot))
        finalized_period = self._period_of(int(update.finalized_header.slot))
        if self.next_sync_committee is None:
            if finalized_period != store_period:
                raise LightClientError(
                    "cannot install next committee from another period"
                )
            # only a committee-carrying update may install: a zeroed
            # default committee would flip the None "unknown" sentinel and
            # wedge the store at the period boundary (the spec's
            # is_next_sync_committee_known compares against SyncCommittee()
            # so a zeroed install stays "unknown" there; with a None
            # sentinel the guard must live here)
            if is_sync_committee_update(update):
                self.next_sync_committee = update.next_sync_committee
        elif finalized_period == store_period + 1:
            self.current_sync_committee = self.next_sync_committee
            self.next_sync_committee = (
                update.next_sync_committee
                if is_sync_committee_update(update)
                else None
            )
            self.previous_max_active_participants = (
                self.current_max_active_participants
            )
            self.current_max_active_participants = 0
        if int(update.finalized_header.slot) > int(self.finalized_header.slot):
            self.finalized_header = update.finalized_header
            if int(self.finalized_header.slot) > int(
                self.optimistic_header.slot
            ):
                self.optimistic_header = self.finalized_header

    def force_update(self, current_slot: int) -> None:
        """Spec process_light_client_store_force_update: when finality has
        stalled for a whole UPDATE_TIMEOUT, advance from the best stashed
        update, treating its attested header as finalized."""
        if (
            current_slot
            <= int(self.finalized_header.slot) + self._update_timeout()
            or self.best_valid_update is None
        ):
            return
        best = self.best_valid_update
        if int(best.finalized_header.slot) <= int(self.finalized_header.slot):
            # promote the attested header (spec zeroes the finality proof
            # and substitutes attested_header as the new finalized header)
            lt = light_client_types(self.preset)
            best = lt.LightClientUpdate(
                attested_header=best.attested_header,
                next_sync_committee=best.next_sync_committee,
                next_sync_committee_branch=best.next_sync_committee_branch,
                finalized_header=best.attested_header,
                finality_branch=best.finality_branch,
                sync_aggregate=best.sync_aggregate,
                signature_slot=best.signature_slot,
            )
        self._apply_spec_update(best)
        self.best_valid_update = None

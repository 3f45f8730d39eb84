"""The VC-facing beacon node interface (reference common/eth2's
BeaconNodeHttpClient surface, consumed by validator_client services).
`InProcessBeaconNode` implements it directly over a local BeaconChain --
the same duck type an HTTP client implements over the wire, so services
are transport-agnostic (the reference's BN<->VC process boundary).

The port's copy of lighthouse_tpu/validator_client/beacon_node.py.
"""

from __future__ import annotations

from ..chain.beacon_chain import BeaconChain
from ..ssz import cached_root
from ..pool import NaiveAggregationPool, OperationPool
from ..state_transition import (
    BlockSignatureStrategy,
    ConsensusContext,
    clone_state,
    get_beacon_proposer_index,
    per_block_processing,
    process_slots,
)
from ..types import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    types_for,
)
from ..types.containers import block_classes_for
from ..types.presets import Preset

_BN_COUNTER = 0  # distinct health-metric label per in-process node


class InProcessBeaconNode:
    def __init__(
        self,
        chain: BeaconChain,
        op_pool: OperationPool | None = None,
        naive_pool: NaiveAggregationPool | None = None,
        sync_message_pool=None,
        sync_contribution_pool=None,
        eth1_service=None,
        log=None,
    ):
        from ..chain.sync_committee_verification import (
            ObservedSyncAggregators,
            ObservedSyncContributors,
            SyncContributionPool,
            SyncMessagePool,
        )
        from ..pool.observed import ObservedAggregates

        self.chain = chain
        self.preset: Preset = chain.preset
        self.spec = chain.spec
        # restart-surviving pool (operation_pool/src/persistence.rs):
        # reload persisted operations from the chain's store
        self.op_pool = op_pool or OperationPool.load(
            chain.store, chain.preset, chain.spec, log=log
        )
        self.naive_pool = naive_pool or NaiveAggregationPool()
        self.sync_message_pool = sync_message_pool or SyncMessagePool(
            chain.preset
        )
        self.sync_contribution_pool = (
            sync_contribution_pool or SyncContributionPool(chain.preset)
        )
        self.observed_sync_contributors = ObservedSyncContributors()
        self.observed_sync_aggregators = ObservedSyncAggregators()
        self.observed_contributions = ObservedAggregates()
        # optional mev-boost builder handle (BuilderHttpClient); None =
        # local payload production only
        self.builder = None
        # optional Eth1Service: block production then votes eth1_data at
        # the follow distance and packs the deposits the winning vote owes
        # (reference eth1/src/service.rs + block production deposits)
        self.eth1_service = eth1_service
        # health is SCORED, not a boolean: recent outcomes feed a
        # HealthTracker (resilience/primitives.py), the same machinery
        # BeaconNodeFallback ranks remote nodes with -- so VC failover
        # tests exercise the real scoring path. `healthy = False` (the
        # old test toggle) now floods the window with failures.
        from ..resilience.primitives import HealthTracker

        # unique tracker name per node: each BN exports its own
        # resilience_endpoint_health_score{endpoint="bn<N>/self"} series
        # instead of every node clobbering one label
        global _BN_COUNTER
        _BN_COUNTER += 1
        self.health = HealthTracker(
            window=4, threshold=0.5, name=f"bn{_BN_COUNTER}"
        )

    # -- status --------------------------------------------------------------

    _HEALTH_KEY = "self"

    def is_healthy(self) -> bool:
        return self.health.is_healthy(self._HEALTH_KEY)

    def record_health(self, ok: bool) -> None:
        """Feed one observed outcome into the health score."""
        self.health.record(self._HEALTH_KEY, bool(ok))

    @property
    def healthy(self) -> bool:
        return self.is_healthy()

    @healthy.setter
    def healthy(self, up: bool) -> None:
        # saturate the outcome window so the score flips decisively --
        # the toggle drives the scoring path instead of bypassing it
        for _ in range(self.health.window):
            self.record_health(up)

    def genesis_validators_root(self) -> bytes:
        return bytes(self.chain.head_state.genesis_validators_root)

    def head_slot(self) -> int:
        return self.chain.head_state.slot

    def signing_context(self):
        """Object carrying fork + genesis_validators_root + slot for
        domain computation (the head state serves directly in-process;
        the HTTP client synthesizes an equivalent shim)."""
        return self.chain.head_state

    def validator_index_map(self, pubkeys) -> dict:
        """pubkey bytes -> validator index for the requested keys."""
        state = self.chain.head_state
        wanted = set(bytes(p) for p in pubkeys)
        return {
            bytes(v.pubkey): i
            for i, v in enumerate(state.validators)
            if bytes(v.pubkey) in wanted
        }

    def register_validators(self, registrations) -> None:
        """Forward VC builder registrations to the configured builder
        (the reference BN's register_validator endpoint -> builder
        fan-out); a builder-less BN accepts and drops them."""
        if self.builder is not None:
            self.builder.register_validators(registrations)

    def prepare_proposers(self, preparations) -> None:
        """Record proposer fee recipients with the execution layer
        (/eth/v1/validator/prepare_beacon_proposer seat)."""
        el = self.chain.execution_layer
        if el is None:
            return
        for prep in preparations:
            el.update_proposer_preparation(
                int(prep["validator_index"]), bytes(prep["fee_recipient"])
            )

    # -- duties (the endpoints duties_service.rs:356-765 polls) -------------

    def get_proposer_duties(self, epoch: int) -> list[tuple[int, int]]:
        """[(slot, proposer_index)] for every slot of `epoch`."""
        state = clone_state(self.chain.head_state)
        start = compute_start_slot_at_epoch(epoch, self.preset)
        if state.slot < start:
            state = process_slots(state, start, self.preset, self.spec)
        out = []
        saved = state.slot
        for slot in range(start, start + self.preset.slots_per_epoch):
            # proposer selection hashes the exact slot into the epoch seed;
            # the rest of the state is slot-independent within the epoch
            state.slot = slot
            out.append(
                (slot, get_beacon_proposer_index(state, self.preset, self.spec))
            )
        state.slot = saved
        return out

    def get_attester_duties(self, epoch: int, indices) -> list[dict]:
        state = clone_state(self.chain.head_state)
        target = compute_start_slot_at_epoch(epoch, self.preset)
        if state.slot < target:
            state = process_slots(state, target, self.preset, self.spec)
        ctxt = ConsensusContext(self.preset, self.spec)
        cache = ctxt.committee_cache(state, epoch)
        duties = []
        wanted = set(indices)
        for slot_off in range(self.preset.slots_per_epoch):
            slot = target + slot_off
            for ci in range(cache.committees_per_slot):
                committee = cache.get_beacon_committee(slot, ci)
                for pos, v in enumerate(committee):
                    if v in wanted:
                        duties.append(
                            {
                                "validator_index": v,
                                "slot": slot,
                                "committee_index": ci,
                                "committee_position": pos,
                                "committee_length": len(committee),
                                "committees_at_slot": cache.committees_per_slot,
                            }
                        )
        return duties

    # -- block production/publish (block_service path) ----------------------

    def _pack_body(self, body, state, slot: int, randao_reveal, graffiti):
        """Fill a (full or blinded) block body from the pools -- the one
        packing path both production flavors share."""
        t = types_for(self.preset)
        body.randao_reveal = bytes(randao_reveal)
        body.eth1_data = state.eth1_data
        if self.eth1_service is not None:
            # eth1 vote + the deposits the state owes under it. The vote
            # must be applied to a SCRATCH view first: expected deposit
            # count follows the eth1_data that WINS the voting period,
            # which (on minimal presets) can be this very vote.
            from ..state_transition.per_block import process_eth1_data

            vote = self.eth1_service.eth1_data_for_block(state)
            body.eth1_data = vote
            view = clone_state(state)
            process_eth1_data(view, vote, self.preset)
            body.deposits = tuple(
                self.eth1_service.deposits_for_block(
                    view, self.preset.max_deposits
                )
            )
        body.graffiti = bytes(graffiti).ljust(32, b"\x00")[:32]
        body.attestations = tuple(self.op_pool.get_attestations(state))
        prop, att, exits = self.op_pool.get_slashings_and_exits(state)
        body.proposer_slashings = tuple(prop)
        body.attester_slashings = tuple(att)
        body.voluntary_exits = tuple(exits)
        if hasattr(body, "sync_aggregate"):
            # the gossip-fed contribution pool supplies the aggregate for
            # the PREVIOUS slot's head (sync_committee_verification feeds
            # it); empty pool -> the valid empty aggregate
            prev_root = state.latest_block_header.tree_hash_root()
            body.sync_aggregate = self.sync_contribution_pool.get_sync_aggregate(
                t, slot - 1, prev_root
            )
        return body

    def _fill_state_root(self, block, signed_cls, state, proposer: int):
        """Scratch-apply the block to compute its post-state root."""
        from ..crypto.bls.api import INFINITY_SIGNATURE

        scratch = clone_state(state)
        per_block_processing(
            scratch,
            signed_cls(message=block, signature=INFINITY_SIGNATURE),
            self.preset,
            self.spec,
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            verified_proposer_index=proposer,
        )
        block.state_root = cached_root(scratch)
        return block

    def produce_block(self, slot: int, randao_reveal: bytes, graffiti=b""):
        """Unsigned block with pool-packed operations (the reference's
        produce_block endpoint -> op_pool.get_attestations packing)."""
        state = self.chain.state_for_block_production(slot)
        fork = state.fork_name
        t = types_for(self.preset)
        block_cls, signed_cls, body_cls = block_classes_for(t, fork)
        proposer = get_beacon_proposer_index(state, self.preset, self.spec)

        body = self._pack_body(
            body_cls.default(), state, slot, randao_reveal, graffiti
        )
        el = self.chain.execution_layer
        if hasattr(body, "execution_payload") and el is not None:
            # payload build honors the proposer's prepared fee recipient
            # (preparation_service.rs -> execution_layer get_payload)
            body.execution_payload = el.build_payload_for_block(
                state, slot, proposer, self.preset, self.spec
            )

        block = block_cls(
            slot=slot,
            proposer_index=proposer,
            parent_root=state.latest_block_header.tree_hash_root(),
            state_root=bytes(32),
            body=body,
        )
        return self._fill_state_root(block, signed_cls, state, proposer)

    def publish_block(self, signed_block) -> bytes:
        return self.chain.process_block(signed_block)

    # -- blinded production (mev-boost; execution_layer builder path) -------

    def produce_blinded_block(self, slot: int, randao_reveal: bytes, graffiti=b""):
        """A BLINDED block whose body carries the builder's
        ExecutionPayloadHeader instead of a payload (builder_client flow,
        beacon_node/execution_layer builder paths). Requires `self.builder`
        (a BuilderHttpClient) and a registered proposer; raises
        NoBidAvailable/BuilderError for the caller's local-production
        fallback."""
        from ..execution_layer.builder import BuilderError, verify_bid
        from ..state_transition.per_block import is_merge_transition_complete

        if getattr(self, "builder", None) is None:
            raise BuilderError("no builder configured")
        state = self.chain.state_for_block_production(slot)
        if state.fork_name != "bellatrix":
            raise BuilderError("blinded production is post-merge only")
        t = types_for(self.preset)
        proposer = get_beacon_proposer_index(state, self.preset, self.spec)
        proposer_pubkey = bytes(state.validators[proposer].pubkey)

        if is_merge_transition_complete(state):
            parent_hash = bytes(state.latest_execution_payload_header.block_hash)
        else:
            parent_hash = self.chain.execution_layer.pre_merge_parent_hash
        trusted = getattr(self.builder, "trusted_pubkey", None)
        if trusted is None:
            # fail closed: an unpinned builder identity lets a relay burn
            # the proposer's slot with a self-signed bid (see verify_bid)
            raise BuilderError(
                "builder has no pinned identity (trusted_pubkey)"
            )
        signed_bid = self.builder.get_header(slot, parent_hash, proposer_pubkey)
        verify_bid(signed_bid, self.spec, parent_hash, trusted_pubkey=trusted)

        body = self._pack_body(
            t.BlindedBeaconBlockBody.default(), state, slot, randao_reveal,
            graffiti,
        )
        body.execution_payload_header = signed_bid.message.header

        block = t.BlindedBeaconBlock(
            slot=slot,
            proposer_index=proposer,
            parent_root=state.latest_block_header.tree_hash_root(),
            state_root=bytes(32),
            body=body,
        )
        return self._fill_state_root(
            block, t.SignedBlindedBeaconBlock, state, proposer
        )

    def publish_blinded_block(self, signed_blinded) -> bytes:
        """Submit to the builder, unblind the revealed payload, import +
        return the full block root (publish_blocks.rs blinded path)."""
        from ..execution_layer.builder import unblind_signed_block

        payload = self.builder.submit_blinded_block(signed_blinded)
        full = unblind_signed_block(signed_blinded, payload, self.preset)
        return self.chain.process_block(full)

    # -- attestation endpoints ----------------------------------------------

    def produce_attestation_data(self, slot: int, committee_index: int):
        """AttestationData for (slot, index) on the current head."""
        from ..types.containers import AttestationData, Checkpoint
        from ..types.helpers import get_block_root_at_slot

        state = self.chain.head_state
        head_root = self.chain.head_root
        if state.slot < slot:
            state = process_slots(
                clone_state(state), slot, self.preset, self.spec
            )
        epoch = compute_epoch_at_slot(slot, self.preset)
        target_slot = compute_start_slot_at_epoch(epoch, self.preset)
        if target_slot >= state.slot:
            target_root = head_root
        else:
            target_root = get_block_root_at_slot(
                state, target_slot, self.preset
            )
        return AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=head_root,
            source=state.current_justified_checkpoint,
            target=Checkpoint(epoch=epoch, root=target_root),
        )

    def publish_attestation(self, attestation) -> None:
        """Accept a signed unaggregated attestation into the pools + fork
        choice (the gossip-equivalent ingestion path)."""
        self.naive_pool.insert(attestation)
        self.op_pool.insert_attestation(attestation)

    def get_aggregate(self, data):
        t = types_for(self.preset)
        return self.naive_pool.get_aggregate(t, data)

    def publish_aggregate_and_proof(self, signed_aggregate) -> None:
        self.op_pool.insert_attestation(signed_aggregate.message.aggregate)

    # -- sync-committee endpoints (validator/sync_committee_* routes) --------

    def get_sync_duties(self, epoch: int, indices) -> list[dict]:
        """Which of `indices` sit in the current sync committee, and on
        which subnets (duties_service/sync.rs poll)."""
        from ..chain.sync_committee_verification import (
            subnets_for_sync_validator,
            sync_committee_positions,
        )

        state = self.chain.head_state
        if not hasattr(state, "current_sync_committee"):
            return []
        table = sync_committee_positions(state, self.preset)
        out = []
        for idx in indices:
            subnets = subnets_for_sync_validator(state, self.preset, idx, table)
            if subnets:
                out.append({"validator_index": idx, "subnets": subnets})
        return out

    def publish_sync_message(self, message, subnet: int = 0) -> None:
        """Verify + pool a gossip sync-committee message (the in-process
        stand-in for the sync_committee_{subnet} topic)."""
        from ..chain.sync_committee_verification import (
            batch_verify_sync_messages,
        )

        verified, rejected = batch_verify_sync_messages(
            self.chain, [(message, subnet)], self.observed_sync_contributors
        )
        for v in verified:
            self.sync_message_pool.insert(v)
        for _, reason in rejected:
            if "already" in reason:
                return  # duplicate suppression is not an error
            raise ValueError(f"sync message rejected: {reason}")

    def get_sync_contribution(self, slot: int, block_root: bytes, subnet: int):
        t = types_for(self.preset)
        return self.sync_message_pool.get_contribution(
            t, slot, block_root, subnet
        )

    def publish_contribution_and_proof(self, signed_contribution) -> None:
        from ..chain.sync_committee_verification import (
            batch_verify_contributions,
        )

        verified, rejected = batch_verify_contributions(
            self.chain,
            [signed_contribution],
            self.observed_sync_aggregators,
            self.observed_contributions,
        )
        for v in verified:
            self.sync_contribution_pool.insert(v)
        for _, reason in rejected:
            if "already" in reason:
                return  # duplicate suppression is not an error
            raise ValueError(f"contribution rejected: {reason}")

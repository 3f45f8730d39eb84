"""Network node: Router + gossip methods + sync over the message bus
(reference beacon_node/network/src/router/mod.rs:206 handle_gossip,
worker/gossip_methods.rs, sync/manager.rs + range_sync, and
lighthouse_network's peer manager scoring, peer_manager/peerdb/score.rs).

One NetworkNode owns a BeaconChain, pools, observed caches, a
BeaconProcessor, and a peer score table; it subscribes to the gossip
topics and serves the req/resp protocols.

The port's copy of lighthouse_tpu/network/node.py.
"""

from __future__ import annotations

from ..chain.attestation_verification import (
    submit_aggregate_batch,
    submit_unaggregated_batch,
)
from ..chain.beacon_chain import BeaconChain, BlockError
from ..pool import (
    NaiveAggregationPool,
    ObservedAggregates,
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
    OperationPool,
)
from ..processor import BeaconProcessor, DeferredWork
from ..types import compute_epoch_at_slot, compute_fork_digest
from ..utils import metrics as M
from ..utils import tracing
from .message_bus import MessageBus, topic_name
from ..chain.sync_committee_verification import (
    ObservedSyncAggregators,
    ObservedSyncContributors,
    SyncContributionPool,
    SyncMessagePool,
    submit_contribution_batch,
    submit_sync_message_batch,
)

GOSSIP_PENALTY = -10
BAN_THRESHOLD = -50

STATUS_PROTOCOL = "/eth2/beacon_chain/req/status/1"
BLOCKS_BY_RANGE = "/eth2/beacon_chain/req/beacon_blocks_by_range/1"
BLOCKS_BY_ROOT = "/eth2/beacon_chain/req/beacon_blocks_by_root/1"
LIGHT_CLIENT_BOOTSTRAP = "/eth2/beacon_chain/req/light_client_bootstrap/1"


class NetworkNode:
    def __init__(
        self,
        peer_id: str,
        chain: BeaconChain,
        bus: MessageBus,
        subscribe_all_subnets: bool = True,
        op_pool=None,
        log=None,
    ):
        self.peer_id = peer_id
        self.chain = chain
        self.bus = bus
        # shared with the API node when the CLI wires one in; loads any
        # persisted operations either way (persistence.rs)
        self.op_pool = op_pool or OperationPool.load(
            chain.store, chain.preset, chain.spec, log=log
        )
        self.naive_pool = NaiveAggregationPool()
        self.observed_attesters = ObservedAttesters()
        self.observed_aggregates = ObservedAggregates()
        self.observed_aggregators = ObservedAggregators()
        self.observed_block_producers = ObservedBlockProducers()
        self.observed_sync_contributors = ObservedSyncContributors()
        self.observed_sync_aggregators = ObservedSyncAggregators()
        self.observed_contributions = ObservedAggregates()
        self.sync_message_pool = SyncMessagePool(chain.preset)
        self.sync_contribution_pool = SyncContributionPool(chain.preset)
        self.peer_scores: dict[str, int] = {}
        self.processor = BeaconProcessor(
            handlers={
                "gossip_block": self._work_block,
                "gossip_aggregate": self._work_aggregates,
                "gossip_attestation": self._work_attestations,
                "gossip_sync_message": self._work_sync_messages,
                "gossip_sync_contribution": self._work_sync_contributions,
            }
        )

        state = chain.head_state
        self.fork_digest = compute_fork_digest(
            bytes(state.fork.current_version),
            bytes(state.genesis_validators_root),
        )
        self._topic_block = topic_name("beacon_block", self.fork_digest)
        self._topic_aggregate = topic_name(
            "beacon_aggregate_and_proof", self.fork_digest
        )
        bus.subscribe(peer_id, self._topic_block, self._on_gossip_block)
        bus.subscribe(peer_id, self._topic_aggregate, self._on_gossip_aggregate)
        # attestation subnets: production nodes run the subnet service
        # (long-lived camping + duty subscriptions,
        # subnet_service/attestation_subnets.rs); simulators subscribe to
        # all 64 (the reference's --subscribe-all-subnets flag)
        self.subnet_service = None
        self.discovery = None
        if subscribe_all_subnets:
            for subnet in range(chain.spec.attestation_subnet_count):
                bus.subscribe(
                    peer_id,
                    topic_name("beacon_attestation", self.fork_digest, subnet),
                    self._on_gossip_attestation,
                )
        else:
            import hashlib

            from .subnet_service import AttestationSubnetService

            self.subnet_service = AttestationSubnetService(
                hashlib.sha256(peer_id.encode()).digest(),
                chain.preset,
                chain.spec,
                subscribe_cb=lambda subnet: bus.subscribe(
                    peer_id,
                    topic_name("beacon_attestation", self.fork_digest, subnet),
                    self._on_gossip_attestation,
                ),
                unsubscribe_cb=lambda subnet: bus.unsubscribe(
                    peer_id,
                    topic_name("beacon_attestation", self.fork_digest, subnet),
                ),
                enr_update_cb=None,
            )
            self.subnet_service.on_slot(chain.head_state.slot)
        self._topic_contribution = topic_name(
            "sync_committee_contribution_and_proof", self.fork_digest
        )
        bus.subscribe(
            peer_id, self._topic_contribution, self._on_gossip_contribution
        )
        # operation gossip topics (types/topics.rs: ProposerSlashing /
        # AttesterSlashing / VoluntaryExit pubsub kinds)
        self._topic_proposer_slashing = topic_name(
            "proposer_slashing", self.fork_digest
        )
        self._topic_attester_slashing = topic_name(
            "attester_slashing", self.fork_digest
        )
        self._topic_voluntary_exit = topic_name(
            "voluntary_exit", self.fork_digest
        )
        bus.subscribe(
            peer_id,
            self._topic_proposer_slashing,
            self._on_gossip_proposer_slashing,
        )
        bus.subscribe(
            peer_id,
            self._topic_attester_slashing,
            self._on_gossip_attester_slashing,
        )
        bus.subscribe(
            peer_id, self._topic_voluntary_exit, self._on_gossip_voluntary_exit
        )
        # per-epoch committees_per_slot memo for subnet computation
        self._committees_per_slot: dict[int, int] = {}
        # dedup for op gossip (observed_operations.rs): insertion-ordered
        # so the oldest half can be shed at the cap (the reference prunes
        # at finalization; a lifetime-unbounded set is a slow leak)
        self._seen_ops: dict[bytes, None] = {}
        self._seen_ops_cap = 8192
        # optional slasher (slasher/service/src/lib.rs); attach_slasher wires it
        self.slasher_service = None
        # gossip that outran its prerequisites waits here
        # (work_reprocessing_queue.rs). Deadlines ride the chain's SLOT
        # clock, not the wall clock, so the one-slot maturity window
        # advances with simulated time exactly as with real time.
        from ..processor.reprocess import ReprocessQueue
        from ..utils.timeout_lock import TimeoutRLock

        # serializes the four BATCH gossip lanes against each other (the
        # chain has its own lock; op/naive/sync pools and the observed-*
        # dedup caches are mutated inside batch_verify_* itself, so the
        # verify call cannot run outside the guard without splitting
        # dedup from verification). Block import — the long pole — runs
        # OUTSIDE this lock and overlaps every batch lane.
        self.pools_lock = TimeoutRLock("gossip_pools")

        sps = chain.spec.seconds_per_slot
        self.reprocess = ReprocessQueue(
            delay_s=float(sps),
            clock=lambda: chain.slot_clock.current_slot() * float(sps),
        )
        for subnet in range(chain.preset.sync_committee_subnet_count):
            bus.subscribe(
                peer_id,
                topic_name("sync_committee", self.fork_digest, subnet),
                self._make_sync_subnet_handler(subnet),
            )
        bus.register_rpc(peer_id, STATUS_PROTOCOL, self._rpc_status)
        bus.register_rpc(peer_id, BLOCKS_BY_RANGE, self._rpc_blocks_by_range)
        bus.register_rpc(peer_id, BLOCKS_BY_ROOT, self._rpc_blocks_by_root)
        bus.register_rpc(
            peer_id, LIGHT_CLIENT_BOOTSTRAP, self._rpc_light_client_bootstrap
        )

        from .sync import SyncManager

        self.sync_manager = SyncManager(self)

    # -- scoring (peerdb/score.rs) ------------------------------------------

    def penalize(self, peer: str, amount: int = GOSSIP_PENALTY) -> None:
        with self.pools_lock:
            self.peer_scores[peer] = self.peer_scores.get(peer, 0) + amount
        # feed the wire-level behavioral scorer too, severity-mapped:
        # full gossip penalties are P4 invalid-message events; mild -1
        # nudges (RPC timeouts, empty responses) are only a small P7
        # behaviour penalty — an honest-but-slow peer must not graylist
        scorer = getattr(self.bus, "scorer", None)
        if scorer is not None and peer:
            if amount <= GOSSIP_PENALTY:
                scorer.on_invalid(peer)
            elif amount < 0:
                scorer.on_behaviour_penalty(peer, 0.2)

    def is_banned(self, peer: str) -> bool:
        return self.peer_scores.get(peer, 0) <= BAN_THRESHOLD

    # -- gossip ingress (router -> processor queues) ------------------------

    def _on_gossip_block(self, signed_block, source: str) -> None:
        if self.is_banned(source):
            return
        block = signed_block.message
        # read-only exact-duplicate shedding against VERIFIED sightings;
        # recording happens post-signature-verification in the worker
        # (process_gossip_block), so an unverified forged block can never
        # suppress the real proposal (observe-after-verification pattern)
        known = self.observed_block_producers.known_root(
            block.slot, block.proposer_index
        )
        if known is not None and known == block.tree_hash_root():
            return
        # the trace's first event + the slot-relative observation delay
        # (reference beacon_block_delay_gossip): both ride injected clocks
        tracing.instant("gossip_block_rx", slot=int(block.slot))
        M.observe_slot_delay(
            M.BLOCK_OBSERVED_DELAY, self.chain.slot_clock, int(block.slot)
        )
        self.processor.submit("gossip_block", (signed_block, source))

    def _on_gossip_aggregate(self, signed_aggregate, source: str) -> None:
        if not self.is_banned(source):
            tracing.instant(
                "gossip_aggregate_rx",
                slot=int(signed_aggregate.message.aggregate.data.slot),
            )
            self.processor.submit("gossip_aggregate", (signed_aggregate, source))

    def _on_gossip_attestation(self, attestation, source: str) -> None:
        if not self.is_banned(source):
            tracing.instant(
                "gossip_attestation_rx", slot=int(attestation.data.slot)
            )
            self.processor.submit("gossip_attestation", (attestation, source))

    def _make_sync_subnet_handler(self, subnet: int):
        def handler(message, source: str) -> None:
            if not self.is_banned(source):
                self.processor.submit(
                    "gossip_sync_message", (message, subnet, source)
                )

        return handler

    def _on_gossip_contribution(self, signed_contribution, source: str) -> None:
        if not self.is_banned(source):
            self.processor.submit(
                "gossip_sync_contribution", (signed_contribution, source)
            )

    # -- slasher (slasher/service/src/lib.rs) -------------------------------

    def attach_slasher(self, slasher) -> None:
        """Run a slasher on this node: verified gossip feeds it, and its
        detections are pooled for block inclusion + broadcast on the
        slashing topics."""
        from ..slasher import SlasherService

        def broadcast(kind, op):
            topic = (
                self._topic_attester_slashing
                if kind == "attester_slashing"
                else self._topic_proposer_slashing
            )
            self._mark_op_seen(op.tree_hash_root())  # don't re-import our own
            self.bus.publish(self.peer_id, topic, op)

        self.slasher_service = SlasherService(
            slasher,
            self.op_pool,
            broadcast,
            fork_choice=self.chain.fork_choice,
        )

    def attach_discovery(self, disc) -> None:
        """Wire a DiscoveryService: subnet-service rotations advertise
        their long-lived subnets in the node's ENR attnets bits
        (discovery/enr.rs update flow)."""
        self.discovery = disc
        if self.subnet_service is not None:
            self.subnet_service.set_enr_update_cb(
                lambda subnets: disc.update_local_enr(attnets=subnets)
            )

    def on_slot(self) -> None:
        """Per-slot housekeeping (the reference's per-12s slasher batch)."""
        if self.slasher_service is not None:
            self.slasher_service.update()
        if self.subnet_service is not None:
            self.subnet_service.on_slot(self.chain.current_slot)
        # timed second chance for gossip still waiting on a block
        with self.pools_lock:
            due = list(self.reprocess.poll())
        for queue, item in due:
            self.processor.submit(queue, item)

    def _flush_reprocess(self, block_root: bytes) -> None:
        """A block imported: release gossip that was waiting for it."""
        with self.pools_lock:
            released = list(self.reprocess.on_block_imported(block_root))
        for queue, item in released:
            self.processor.submit(queue, item)

    # -- operation gossip (verify_operation.rs + observed_operations.rs) ---

    def _mark_op_seen(self, root: bytes) -> None:
        self._seen_ops[root] = None
        if len(self._seen_ops) > self._seen_ops_cap:
            for old in list(self._seen_ops)[: self._seen_ops_cap // 2]:
                del self._seen_ops[old]

    def _op_fresh(self, op) -> bool:
        root = op.tree_hash_root()
        if root in self._seen_ops:
            return False
        self._mark_op_seen(root)
        return True

    def _handle_op_gossip(self, op, source: str, validate, insert) -> None:
        """Shared op-gossip flow: dedup AFTER validation (the repo's
        observe-after-verification pattern -- a transiently-unverifiable op
        must be retryable on re-gossip), and distinguish ignore (our view
        is behind: no penalty) from reject (provably bad: penalize)."""
        root = op.tree_hash_root()
        if self.is_banned(source) or root in self._seen_ops:
            return
        from ..chain.pubkey_cache import PubkeyCacheError

        try:
            validate(op)
        except (KeyError, IndexError, PubkeyCacheError):
            return  # references state we don't have yet: ignore, may recur
        except ValueError:
            self.penalize(source)
            return
        self._mark_op_seen(root)
        insert(op)

    def _on_gossip_proposer_slashing(self, slashing, source: str) -> None:
        self._handle_op_gossip(
            slashing,
            source,
            self._validate_proposer_slashing,
            self.op_pool.insert_proposer_slashing,
        )

    def _on_gossip_attester_slashing(self, slashing, source: str) -> None:
        def accept(s):
            self.op_pool.insert_attester_slashing(s)
            # a proven equivocation also strips the equivocators'
            # fork-choice weight immediately (spec on_attester_slashing)
            self.chain.fork_choice.on_attester_slashing(s)
            if self.chain.validator_monitor is not None:
                common = set(s.attestation_1.attesting_indices) & set(
                    s.attestation_2.attesting_indices
                )
                self.chain.validator_monitor.on_slashing_observed(
                    [int(i) for i in common],
                    int(self.chain.current_slot)
                    // self.chain.preset.slots_per_epoch,
                )

        self._handle_op_gossip(
            slashing,
            source,
            self._validate_attester_slashing,
            accept,
        )

    def _on_gossip_voluntary_exit(self, signed_exit, source: str) -> None:
        def accept(e):
            self.op_pool.insert_voluntary_exit(e)
            if self.chain.validator_monitor is not None:
                self.chain.validator_monitor.on_exit_observed(
                    int(e.message.validator_index), int(e.message.epoch)
                )

        self._handle_op_gossip(
            signed_exit,
            source,
            self._validate_voluntary_exit,
            accept,
        )

    def _validate_proposer_slashing(self, slashing) -> None:
        from ..crypto.bls.api import verify_signature_sets
        from ..state_transition.signature_sets import (
            proposer_slashing_signature_sets,
        )

        h1 = slashing.signed_header_1.message
        h2 = slashing.signed_header_2.message
        if h1.slot != h2.slot or h1.proposer_index != h2.proposer_index:
            raise ValueError("headers not slashable")
        if h1.tree_hash_root() == h2.tree_hash_root():
            raise ValueError("identical headers")
        state = self.chain.head_state
        sets = proposer_slashing_signature_sets(
            state,
            self.chain.pubkey_cache.getter(state),
            slashing,
            self.chain.preset,
            self.chain.spec,
        )
        if not verify_signature_sets(sets):
            raise ValueError("bad proposer slashing signature")

    def _validate_attester_slashing(self, slashing) -> None:
        from ..crypto.bls.api import verify_signature_sets
        from ..state_transition.per_block import is_slashable_attestation_data
        from ..state_transition.signature_sets import (
            attester_slashing_signature_sets,
        )

        a1, a2 = slashing.attestation_1, slashing.attestation_2
        if not is_slashable_attestation_data(a1.data, a2.data):
            raise ValueError("attestation data not slashable")
        if not set(a1.attesting_indices) & set(a2.attesting_indices):
            raise ValueError("no common attesters")
        state = self.chain.head_state
        sets = attester_slashing_signature_sets(
            state,
            self.chain.pubkey_cache.getter(state),
            slashing,
            self.chain.preset,
            self.chain.spec,
        )
        if not verify_signature_sets(sets):
            raise ValueError("bad attester slashing signature")

    def _validate_voluntary_exit(self, signed_exit) -> None:
        """The FULL process_voluntary_exit precondition set (per_block.py):
        a validly-signed but premature exit must never reach the pool, or
        it bricks every subsequent pool-packed block."""
        from ..crypto.bls.api import verify_signature_sets
        from ..state_transition.signature_sets import exit_signature_set
        from ..types import FAR_FUTURE_EPOCH, is_active_validator

        state = self.chain.head_state
        msg = signed_exit.message
        epoch = compute_epoch_at_slot(state.slot, self.chain.preset)
        v = state.validators[msg.validator_index]
        if not is_active_validator(v, epoch):
            raise ValueError("exiting validator not active")
        if v.exit_epoch != FAR_FUTURE_EPOCH:
            raise ValueError("validator already exiting")
        if epoch < msg.epoch:
            raise ValueError("exit epoch in the future")
        if epoch < v.activation_epoch + self.chain.spec.shard_committee_period:
            raise ValueError("validator too young to exit")
        s = exit_signature_set(
            state,
            self.chain.pubkey_cache.getter(state),
            signed_exit,
            self.chain.preset,
            self.chain.spec,
        )
        if not verify_signature_sets([s]):
            raise ValueError("bad exit signature")

    # -- workers (worker/gossip_methods.rs) ---------------------------------

    def _work_block(self, item) -> None:
        signed_block, source = item
        from ..chain.block_verification import (
            BlockAlreadyKnown,
            BlockEquivocation,
            UnknownParent,
            process_gossip_block,
        )

        try:
            process_gossip_block(
                self.chain, signed_block, self.observed_block_producers
            )
        except BlockAlreadyKnown:
            return  # benign gossip/sync overlap: never penalized
        except BlockEquivocation:
            # a SIGNATURE-VALID second distinct block from the same
            # (slot, proposer): spec gossip validation IGNOREs it (no
            # penalty — the relayer may be honest), and it must not enter
            # fork choice through gossip. The slasher sees the verified
            # header: two conflicting headers from one proposer are
            # exactly a ProposerSlashing detection (the
            # equivocation-storm scenario's safety invariant).
            M.BLOCK_EQUIVOCATIONS.inc()
            if self.slasher_service is not None:
                self.slasher_service.accept_block(signed_block)
            return
        except UnknownParent as e:
            # chase the ANCESTRY we're missing (block_lookups/), then
            # import the block we already hold -- no refetch of it
            if self.sync_manager.lookup_block(e.parent_root):
                try:
                    process_gossip_block(
                        self.chain,
                        signed_block,
                        self.observed_block_producers,
                    )
                except BlockEquivocation:
                    M.BLOCK_EQUIVOCATIONS.inc()
                    if self.slasher_service is not None:
                        self.slasher_service.accept_block(signed_block)
                    return
                except BlockError:
                    self.penalize(source)
                    return
            else:
                self.penalize(source, -1)
                return
        except BlockError:
            self.penalize(source)
            return
        # mesh re-publication happens at the bus; nothing further here
        if self.slasher_service is not None:
            self.slasher_service.accept_block(signed_block)
        self._flush_reprocess(signed_block.message.tree_hash_root())

    def _work_aggregates(self, items):
        """Submit the batch (marshal + device dispatch) under the pools
        lock, hand the processor a DeferredWork: the worker is free to
        form the next batch while the device verifies this one."""
        aggs = [a for a, _ in items]
        sources = {id(a): s for a, s in items}
        with self.pools_lock:
            pending = submit_aggregate_batch(
                self.chain,
                aggs,
                self.observed_aggregates,
                self.observed_aggregators,
            )

        def complete():
            with self.pools_lock:
                verified, rejected = pending.complete()
                self._apply_aggregate_results(verified, rejected, sources)

        return DeferredWork(pending.done, complete)

    def _apply_aggregate_results(self, verified, rejected, sources) -> None:
        for v in verified:
            self.op_pool.insert_attestation(v.signed_aggregate.message.aggregate)
            self.chain.apply_attestation(
                v.signed_aggregate.message.aggregate, v.indexed_indices
            )
            if self.slasher_service is not None:
                self.slasher_service.accept_attestation(v.indexed)
        for agg, reason in rejected:
            if "signature" in reason or "selection" in reason:
                self.penalize(sources.get(id(agg), ""))
            elif "unknown head block" in reason:
                self.reprocess.defer(
                    "gossip_aggregate",
                    (agg, sources.get(id(agg), "")),
                    bytes(agg.message.aggregate.data.beacon_block_root),
                    agg.tree_hash_root(),
                )

    def _work_attestations(self, items):
        atts = [a for a, _ in items]
        sources = {id(a): s for a, s in items}
        with self.pools_lock:
            pending = submit_unaggregated_batch(
                self.chain, atts, self.observed_attesters
            )

        def complete():
            with self.pools_lock:
                verified, rejected = pending.complete()
                self._apply_attestation_results(verified, rejected, sources)

        return DeferredWork(pending.done, complete)

    def _apply_attestation_results(self, verified, rejected, sources) -> None:
        for v in verified:
            self.naive_pool.insert(v.attestation)
            self.op_pool.insert_attestation(v.attestation)
            self.chain.apply_attestation(v.attestation, v.indexed_indices)
            if self.slasher_service is not None:
                self.slasher_service.accept_attestation(v.indexed)
        for att, reason in rejected:
            if "signature" in reason:
                self.penalize(sources.get(id(att), ""))
            elif "unknown head block" in reason:
                self.reprocess.defer(
                    "gossip_attestation",
                    (att, sources.get(id(att), "")),
                    bytes(att.data.beacon_block_root),
                    att.tree_hash_root(),
                )

    def _work_sync_messages(self, items):
        """Same deferred shape as the attestation lanes: submit under the
        pools lock, let the worker form the next batch while the device
        verifies this one (the sync lane of the continuous-batching
        scheduler when it is enabled)."""
        msgs = [(m, subnet) for m, subnet, _ in items]
        sources = {id(m): s for m, _, s in items}
        with self.pools_lock:
            pending = submit_sync_message_batch(
                self.chain, msgs, self.observed_sync_contributors
            )

        def complete():
            with self.pools_lock:
                verified, rejected = pending.complete()
                for v in verified:
                    self.sync_message_pool.insert(v)
                    if self.chain.validator_monitor is not None:
                        self.chain.validator_monitor.on_sync_committee_message(
                            int(v.message.validator_index),
                            int(v.message.slot),
                        )
                for msg, reason in rejected:
                    if "signature" in reason:
                        self.penalize(sources.get(id(msg), ""))

        return DeferredWork(pending.done, complete)

    def _work_sync_contributions(self, items):
        contributions = [c for c, _ in items]
        sources = {id(c): s for c, s in items}
        with self.pools_lock:
            pending = submit_contribution_batch(
                self.chain,
                contributions,
                self.observed_sync_aggregators,
                self.observed_contributions,
            )

        def complete():
            with self.pools_lock:
                verified, rejected = pending.complete()
                for v in verified:
                    self.sync_contribution_pool.insert(v)
                for c, reason in rejected:
                    if "signature" in reason or "selection" in reason:
                        self.penalize(sources.get(id(c), ""))

        return DeferredWork(pending.done, complete)

    # -- publish (the local node's own messages) ----------------------------

    def publish_block(self, signed_block) -> None:
        # record our OWN proposal in the equivocation filter: without
        # this, a Byzantine double-proposal gossiped back at the
        # proposer's node would count as a first sighting and import
        block = signed_block.message
        self.observed_block_producers.observe(
            block.slot, block.proposer_index, block.tree_hash_root()
        )
        self.chain.process_block(signed_block)
        if self.slasher_service is not None:
            self.slasher_service.accept_block(signed_block)
        self._flush_reprocess(signed_block.message.tree_hash_root())
        self.bus.publish(self.peer_id, self._topic_block, signed_block)

    def publish_voluntary_exit(self, signed_exit) -> None:
        self._op_fresh(signed_exit)
        self.op_pool.insert_voluntary_exit(signed_exit)
        self.bus.publish(self.peer_id, self._topic_voluntary_exit, signed_exit)

    def subnet_for_attestation(self, attestation) -> int:
        """The spec subnet for an attestation's (slot, committee index),
        from the head state's committee count. The count is memoized per
        epoch (one shuffle, not one per publish), and epochs beyond the
        head state's computable range clamp to head+1 -- the committee
        COUNT tracks the active-validator set, which is what a lagging
        head can still answer."""
        data = attestation.data
        epoch = compute_epoch_at_slot(data.slot, self.chain.preset)
        count = self._committees_per_slot.get(epoch)
        if count is None:
            from ..state_transition import ConsensusContext

            state = self.chain.head_state
            state_epoch = compute_epoch_at_slot(state.slot, self.chain.preset)
            cache = ConsensusContext(
                self.chain.preset, self.chain.spec
            ).committee_cache(state, min(epoch, state_epoch + 1))
            count = cache.committees_per_slot
            if len(self._committees_per_slot) > 8:
                self._committees_per_slot.clear()
            self._committees_per_slot[epoch] = count
        from .subnet_service import compute_subnet_for_attestation

        return compute_subnet_for_attestation(
            count,
            data.slot,
            data.index,
            self.chain.preset,
            self.chain.spec,
        )

    def publish_attestation(self, attestation, subnet: int | None = None) -> None:
        if subnet is None:
            subnet = self.subnet_for_attestation(attestation)
        self.naive_pool.insert(attestation)
        self.op_pool.insert_attestation(attestation)
        self.bus.publish(
            self.peer_id,
            topic_name("beacon_attestation", self.fork_digest, subnet),
            attestation,
        )

    def publish_sync_message(self, message, subnet: int = 0) -> None:
        self.processor.submit(
            "gossip_sync_message", (message, subnet, self.peer_id)
        )
        self.bus.publish(
            self.peer_id,
            topic_name("sync_committee", self.fork_digest, subnet),
            message,
        )

    def publish_sync_contribution(self, signed_contribution) -> None:
        self.processor.submit(
            "gossip_sync_contribution", (signed_contribution, self.peer_id)
        )
        self.bus.publish(
            self.peer_id, self._topic_contribution, signed_contribution
        )

    def publish_aggregate(self, signed_aggregate) -> None:
        self.op_pool.insert_attestation(signed_aggregate.message.aggregate)
        self.bus.publish(self.peer_id, self._topic_aggregate, signed_aggregate)

    # -- req/resp handlers (rpc/protocol.rs) --------------------------------

    def _rpc_status(self, _payload, _peer):
        head_root, head_state = self.chain.head()
        return {
            "fork_digest": self.fork_digest,
            "finalized_epoch": self.chain.finalized_checkpoint[0],
            "finalized_root": self.chain.finalized_checkpoint[1],
            "head_root": head_root,
            "head_slot": head_state.slot,
        }

    def _rpc_blocks_by_range(self, payload, _peer):
        start = payload["start_slot"]
        count = min(payload["count"], 64)  # rpc/rate_limiter.rs quota cap
        out = []
        # walk the canonical chain from head backwards through the STORE
        # (not the in-memory state map) so finalized/backfilled history
        # below the pruning boundary is served too
        root = self.chain.head_root
        chain = []
        while True:
            blk = self.chain.store.get_block_any_temperature(root)
            if blk is None:
                break
            if blk.message.slot < start:
                break
            chain.append(blk)
            root = bytes(blk.message.parent_root)
            if not any(root):
                break
        for blk in reversed(chain):
            if start <= blk.message.slot < start + count:
                out.append(blk)
        return out

    def _rpc_blocks_by_root(self, payload, _peer):
        out = []
        for root in payload["roots"]:
            blk = self.chain.store.get_block_any_temperature(root)
            if blk is not None:
                out.append(blk)
        return out

    def _rpc_light_client_bootstrap(self, payload, _peer):
        """LightClientBootstrap req/resp (rpc/protocol.rs:156): serve the
        bootstrap for a requested block root."""
        from ..chain.light_client import (
            LightClientError,
            light_client_bootstrap,
        )

        state = self.chain.state_for_block_root(bytes(payload["root"]))
        if state is None:
            raise ValueError("unknown block root")
        try:
            return light_client_bootstrap(state, self.chain.preset)
        except LightClientError as e:
            raise ValueError(str(e)) from None

    # -- sync (sync/manager.rs + range_sync + backfill_sync) ----------------

    def sync_with(self, peer: str) -> int:
        """Single-peer forward range sync (kept for callers that target a
        specific peer; multi-peer logic lives in SyncManager)."""
        return self.sync_manager.sync_from(peer)

    def range_sync(self) -> int:
        return self.sync_manager.range_sync()

    def backfill_sync(self) -> int:
        return self.sync_manager.backfill_sync()

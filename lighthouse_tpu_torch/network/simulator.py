"""Multi-node in-process simulator (reference testing/simulator/src/main.rs
+ checks.rs + node_test_rig: N beacon nodes + validator shares on one
runtime, liveness/finality invariants asserted as slots progress).

Grown into the scenario harness's substrate (harness/scenario.py): the
bus supports transport-level partitions, nodes join/leave/crash/reopen
mid-run, validators are HOMED on nodes (a partitioned or offline node's
validators stop proposing and attesting — the realistic stake split),
and block production is per-partition-group so each side of a split
extends its own fork. Everything stays deterministic: same seed, same
schedule, same heads, bit-identical trace export.

The port's copy of lighthouse_tpu/network/simulator.py. The port's own
addition: `device`, every node chain's (its pubkey table and so every
block verify): None is the card, "cpu" only when asked.
"""

from __future__ import annotations

from ..chain.beacon_chain import BeaconChain
from ..harness.chain import StateHarness
from ..resilience.crash import CrashingStore, InjectedCrash
from ..store.hot_cold import HotColdDB
from ..store.kv import MemoryStore
from ..types import ChainSpec
from ..types.presets import Preset
from .message_bus import MessageBus
from .node import NetworkNode


class Simulator:
    def __init__(
        self,
        node_count: int,
        validator_count: int,
        preset: Preset,
        spec: ChainSpec | None = None,
        fault_plan=None,
        crash_plans: dict | None = None,
        attach_slashers: bool = False,
        migration_chunk_slots: int | None = None,
        speculate: bool = False,
        bus=None,
        device=None,
    ):
        self.preset = preset
        self.device = device
        self.spec = spec or ChainSpec.interop()
        # transport seat: the default in-process MessageBus, or an
        # injected bus-compatible fabric (harness wire-transport mode
        # runs the same plans over WireBus sockets via WireFabric)
        self.raw_bus = bus if bus is not None else MessageBus()
        if hasattr(self.raw_bus, "_bind_preset"):
            self.raw_bus._bind_preset(preset)
        self.bus = self.raw_bus
        self.fault_plan = fault_plan
        if fault_plan is not None:
            # chaos mode: every node talks to the bus through the seeded
            # FaultPlan (resilience/faults.py), so req/resp calls see
            # deterministic injected transport faults -- the sync
            # retry/penalty paths run for real instead of only on
            # hand-scripted broken handlers. Only `request` is faulted:
            # req/resp is where the retry machinery lives.
            self.bus = fault_plan.wrap(self.raw_bus, "bus", methods=("request",))
        self.producer = StateHarness(
            validator_count, preset, self.spec, sign=False
        )
        self.genesis = self.producer.state
        self.validator_count = validator_count
        self.attach_slashers = attach_slashers
        self.migration_chunk_slots = migration_chunk_slots
        # duty-driven precompute on every node: the scenario-level knob
        # that proves reorg invalidation + metric sanity under storms
        self.speculate = speculate
        # seeded per-node crash schedules: node index -> CrashPlan; the
        # node's kv routes every mutation through CrashingStore so an
        # armed plan kills "the process" at exactly the Nth store op
        self.crash_plans = dict(crash_plans or {})
        self.nodes: list[NetworkNode] = []
        self.dead: list[NetworkNode] = []
        self._next_index = 0
        # storm artifacts the invariant checker audits: roots that must
        # NEVER be imported by an honest node via gossip
        self.equivocation_roots: list[bytes] = []
        self.forged_roots: list[bytes] = []
        # Byzantine validator clients (validator_client/byzantine.py):
        # a per-phase roster of homed validators whose duties run through
        # a slashing-protection-bypassing store. Counters tally EMITTED
        # slashable messages; overrides accumulate the protection layer's
        # refusals across phase rosters.
        self.byz = None
        self.byz_counts = {
            "double_proposals": 0,
            "conflicting_vote_pairs": 0,
            "surround_votes": 0,
            "equivocating_aggregates": 0,
            "honest_votes_gossiped": 0,
        }
        self.byz_overrides: list[tuple[str, int, str]] = []
        # tree roots of every byz-emitted aggregate ATTESTATION: the
        # speculation layer must never confirm one of these by lookup
        self.byz_aggregate_roots: list[bytes] = []
        # group -> homed validators is recomputed per group per slot;
        # the scan is O(validators) and dominated hundred-node profiles
        # (tools/scenario_profile.py), so memoize on the group's peer set
        self._group_validators_cache: dict[frozenset, set[int]] = {}
        # current split as node groups (None = fully connected)
        self._partition: list[list[NetworkNode]] | None = None
        for _ in range(node_count):
            self.add_node()
        # validator shares: validator v is HOMED on node v % N (it
        # proposes/attests only while that node is alive and connected)
        self.validator_home = {
            v: self.nodes[v % node_count].peer_id
            for v in range(validator_count)
        }

    # -- node lifecycle (churn / crash-recovery) -----------------------------

    def add_node(self, peer_id: str | None = None) -> NetworkNode:
        """A fresh node from genesis joining the bus (churn join: it must
        range-sync to catch up). Homed validators are only assigned at
        construction — later joiners carry no stake, like a new peer."""
        from ..state_transition import clone_state

        index = self._next_index
        self._next_index += 1
        kv = MemoryStore()
        plan = self.crash_plans.get(index)
        if plan is not None:
            kv = CrashingStore(kv, plan)
        store = HotColdDB(
            kv,
            self.preset,
            self.spec,
            migration_chunk_slots=self.migration_chunk_slots,
        )
        chain = BeaconChain(
            store,
            clone_state(self.genesis),
            self.preset,
            self.spec,
            device=self.device,
        )
        if self.speculate:
            from ..speculate import attach_speculation

            attach_speculation(chain)
        node = NetworkNode(peer_id or f"node{index}", chain, self.bus)
        node.sim_index = index
        if self.attach_slashers:
            from ..slasher import Slasher

            node.attach_slasher(
                Slasher.open(MemoryStore(), self.preset, self.spec)
            )
        self.nodes.append(node)
        return node

    def remove_node(self, node: NetworkNode) -> None:
        """Peer leave: drop every subscription and rpc registration; its
        homed validators go silent until it rejoins."""
        self.raw_bus.disconnect(node.peer_id)
        if node in self.nodes:
            self.nodes.remove(node)
        self.dead.append(node)

    def rejoin_node(self, node: NetworkNode) -> NetworkNode:
        """A previously-removed node rejoins with its existing chain
        (fresh NetworkNode so all subscriptions re-register); it must
        range-sync to catch up. The old node's slasher (with its
        accumulated detection history) rides along."""
        fresh = NetworkNode(node.peer_id, node.chain, self.bus)
        fresh.sim_index = getattr(node, "sim_index", -1)
        if node.slasher_service is not None:
            fresh.attach_slasher(node.slasher_service.slasher)
        elif self.attach_slashers:
            from ..slasher import Slasher

            fresh.attach_slasher(
                Slasher.open(MemoryStore(), self.preset, self.spec)
            )
        if node in self.dead:
            self.dead.remove(node)
        self.nodes.append(fresh)
        self._replace_in_partition(node, fresh)
        return fresh

    def mark_dead(self, node: NetworkNode) -> None:
        """A node's simulated process died (InjectedCrash): it vanishes
        from the network mid-flight; reopen_node resurrects it."""
        self.remove_node(node)

    def _replace_in_partition(self, old: NetworkNode, new: NetworkNode) -> None:
        """A reopened/rejoined node takes the old object's seat in any
        installed split (group membership is by node object and, on the
        bus, by peer id — disconnect dropped both): partition and
        crash/churn knobs must compose, not silently isolate the node."""
        if self._partition is None:
            return
        for group in self._partition:
            if old in group:
                group[group.index(old)] = new
        self.raw_bus.set_partitions(
            [[n.peer_id for n in g] for g in self._partition]
        )

    def reopen_node(self, node: NetworkNode) -> NetworkNode:
        """Simulated process restart after a crash: reopen the dead
        node's kv the way a restarted process would (HotColdDB open runs
        write-ahead-journal recovery), resume FromStore, rejoin the bus
        under the same peer id. The caller range-syncs it afterwards.
        The CrashingStore wrapper (with its spent plan) is KEPT around
        the reopened store: re-arming the plan in a later phase models a
        node that dies again."""
        kv = node.chain.store.kv
        if isinstance(kv, CrashingStore):
            # the spent plan passes everything through until re-armed;
            # recovery's own writes therefore never re-crash
            kv = CrashingStore(kv.inner, kv.plan)
        store = HotColdDB(
            kv,
            self.preset,
            self.spec,
            migration_chunk_slots=self.migration_chunk_slots,
        )
        chain = BeaconChain.from_store(
            store, self.preset, self.spec, device=self.device
        )
        if self.speculate:
            from ..speculate import attach_speculation

            attach_speculation(chain)
        fresh = NetworkNode(node.peer_id, chain, self.bus)
        fresh.sim_index = getattr(node, "sim_index", -1)
        if self.attach_slashers:
            from ..slasher import Slasher

            fresh.attach_slasher(
                Slasher.open(MemoryStore(), self.preset, self.spec)
            )
        if node in self.dead:
            self.dead.remove(node)
        self.nodes.append(fresh)
        self._replace_in_partition(node, fresh)
        return fresh

    # -- partitions ----------------------------------------------------------

    def partition(self, groups) -> None:
        """Split the bus: `groups` is a list of node-index lists. Nodes in
        different groups cannot gossip or req/resp each other until
        heal(). Production becomes per-group: each side extends its own
        fork with its own homed validators."""
        node_groups = [[self.nodes[i] for i in g] for g in groups]
        self._partition = node_groups
        self.raw_bus.set_partitions(
            [[n.peer_id for n in g] for g in node_groups]
        )

    def heal(self) -> None:
        self._partition = None
        self.raw_bus.heal()

    def _node_groups(self) -> list[list[NetworkNode]]:
        if self._partition is None:
            return [list(self.nodes)] if self.nodes else []
        # drop nodes that died/left since the split was installed
        groups = [
            [n for n in g if n in self.nodes] for g in self._partition
        ]
        return [g for g in groups if g]

    def _group_validators(self, group) -> set[int]:
        """Validators homed on this group's peers. Cached per peer set
        (validator_home is fixed at construction); callers must treat
        the result as read-only."""
        peers = frozenset(n.peer_id for n in group)
        cached = self._group_validators_cache.get(peers)
        if cached is None:
            cached = {
                v for v, home in self.validator_home.items() if home in peers
            }
            self._group_validators_cache[peers] = cached
        return cached

    # -- Byzantine validator clients (validator_client/byzantine.py) ---------

    def set_byz_plan(self, plan, rng) -> None:
        """Install a fresh Byzantine roster for a phase: sample
        `plan.fraction` of each node's HOMED validators (per node, so
        every partition side gets adversaries), enrolled into a shared
        slashing-protection-bypassing store. `None` (or an inactive
        plan) clears the roster; the outgoing roster's protection
        overrides are kept for the end-of-run report."""
        from ..validator_client.byzantine import ByzRoster

        if self.byz is not None:
            self.byz_overrides.extend(self.byz.store.overrides)
        self.byz = None
        if plan is None or not plan.active():
            return
        by_home: dict[str, list[int]] = {}
        for v in range(self.validator_count):
            by_home.setdefault(self.validator_home[v], []).append(v)
        roster = ByzRoster(plan, self.preset, self.spec)
        for home in sorted(by_home):
            vs = sorted(by_home[home])
            k = int(len(vs) * plan.fraction)
            for v in sorted(rng.sample(vs, k)):
                roster.enroll(v, bytes(self.genesis.validators[v].pubkey))
        if roster.members:
            self.byz = roster

    def total_byz_overrides(self) -> int:
        n = len(self.byz_overrides)
        if self.byz is not None:
            n += len(self.byz.store.overrides)
        return n

    # -- slot driving --------------------------------------------------------

    def tick(self, slot: int) -> None:
        for n in list(self.nodes):
            n.chain.slot_clock.set_slot(slot)
            try:
                n.chain.on_tick()
                n.on_slot()  # slasher batch + other per-slot services
            except InjectedCrash:
                self.mark_dead(n)

    def run_slot(
        self,
        slot: int,
        attest: bool = True,
        active_validators=None,
        equivocate: bool = False,
        forge: bool = False,
        byzantine: bool = False,
    ) -> None:
        """One slot of the synthetic network, per partition group: the
        group holding the proposer's home node produces and gossips a
        block carrying the group's attestations for the previous slot;
        every node's processor drains. `active_validators` restricts who
        proposes/attests (long-non-finality withholding); `equivocate`
        gossips a second conflicting proposal and `forge` an invalid one
        (equivocation-storm phases), both relayed by a synthetic
        Byzantine peer that is not a real node; `byzantine` drives the
        installed ByzRoster's slashable duties through the real
        validator-store signing path (set_byz_plan)."""
        self.tick(slot)
        for group in self._node_groups():
            ctx = self._produce_for_group(
                group, slot, attest, active_validators, equivocate, forge
            )
            if byzantine and self.byz is not None and ctx is not None:
                self._run_byz_duties(group, slot, ctx)
        self.drain()

    def _produce_for_group(
        self, group, slot, attest, active_validators, equivocate, forge
    ) -> dict | None:
        """Returns the group's production context (advanced state,
        proposer, home node, attestations, the published block or None
        on an empty slot) for the byz duty driver; None only when the
        home node crashed mid-publish."""
        from ..state_transition import (
            clone_state,
            get_beacon_proposer_index,
            process_slots,
        )

        leader = group[0]
        parent_state = leader.chain._states[leader.chain.head_root]
        adv = process_slots(
            clone_state(parent_state), slot, self.preset, self.spec
        )
        proposer = get_beacon_proposer_index(adv, self.preset, self.spec)
        allowed = self._group_validators(group)
        if active_validators is not None:
            allowed = allowed & set(active_validators)
        ctx = {
            "adv": adv,
            "proposer": proposer,
            "allowed": allowed,
            "parent_state": parent_state,
            "home": leader,
            "atts": [],
            "signed": None,
        }
        if proposer not in allowed:
            return ctx  # the proposer is on the other side / offline
        home = next(
            (
                n
                for n in group
                if n.peer_id == self.validator_home.get(proposer)
            ),
            leader,
        )
        if leader.chain.head_root not in home.chain._states:
            # the proposer's home has not reconciled the group's head yet
            # (fresh heal/rejoin): the leader publishes on its behalf
            home = leader
        ctx["home"] = home
        atts = []
        if attest and slot > 1:
            atts = self.producer.attestations_for_slot(
                adv, slot - 1, validators=allowed
            )
        ctx["atts"] = atts
        signed, _ = self.producer.produce_block(
            slot, atts, base_state=parent_state
        )
        try:
            home.publish_block(signed)
        except InjectedCrash:
            self.mark_dead(home)
            return None
        ctx["signed"] = signed
        if self.speculate and atts:
            # gossip a real SignedAggregateAndProof so the aggregate
            # verification path (and with it the precompute hook) runs
            # on every receiving node, not just block-carried votes
            home.publish_aggregate(
                self.producer.make_signed_aggregate(adv, slot - 1, 0)
            )
        if equivocate or forge:
            # the Byzantine injector must sit on THIS group's side of any
            # installed split, or its gossip would reach nobody and the
            # storm invariants would pass vacuously
            self.raw_bus.join_group("byz", home.peer_id)
        if equivocate:
            # a SECOND distinct proposal by the same (slot, proposer):
            # honest nodes must IGNORE it (never import via gossip) and
            # their slashers must detect the double proposal
            double, _ = self.producer.produce_block(
                slot, atts, base_state=parent_state, graffiti=b"equivocation"
            )
            self.equivocation_roots.append(double.message.tree_hash_root())
            self.raw_bus.publish("byz", home._topic_block, double)
        if forge:
            # a provably-invalid block (wrong proposer + garbage state
            # root — a distinct proposer so the equivocation dedup does
            # not mask the invalidity path): honest nodes must reject it
            # AND penalize the Byzantine relayer
            bad, _ = self.producer.produce_block(
                slot, base_state=parent_state, graffiti=b"forged"
            )
            bad.message.proposer_index = (
                int(proposer) + 1
            ) % self.validator_count
            bad.message.state_root = b"\x66" * 32
            self.forged_roots.append(bad.message.tree_hash_root())
            self.raw_bus.publish("byz", home._topic_block, bad)
        return ctx

    # -- Byzantine duty driving (validator_client/byzantine.py) --------------

    def _run_byz_duties(self, group, slot, ctx) -> None:
        """Drive this group's Byzantine validators through the REAL
        validator-store signing path (domains, signing roots, the
        slashing-DB gate — bypassed and audited). Slashable artifacts
        are GOSSIPED by a colluding relay peer ("byzvc") sitting on the
        group's side of any split: a byz VC talks to the network through
        its relay, never through an honest node's import path, so the
        no-byz-import invariant audits exactly the gossip boundary."""
        plan = self.byz.plan
        anchor = ctx["home"]
        # place the relay on this group's side (no-op when unpartitioned)
        self.raw_bus.join_group("byzvc", anchor.peer_id)
        if (
            plan.double_propose
            and ctx["signed"] is not None
            and ctx["proposer"] in self.byz
        ):
            self._byz_double_propose(slot, ctx)
        if slot > 2:
            seats = self._byz_committee_seats(group, slot, ctx["adv"])
            if seats and (plan.conflicting_votes or plan.surround_votes):
                self._byz_votes(slot, ctx, seats)
            if seats and plan.equivocating_aggregates:
                self._byz_equivocating_aggregate(slot, ctx, seats)

    def _byz_committee_seats(self, group, slot, adv):
        """(position, validator) byz seats in committee 0 of slot-1
        homed in this group."""
        from ..state_transition import ConsensusContext
        from ..types import compute_epoch_at_slot

        att_slot = slot - 1
        ctxt = ConsensusContext(self.preset, self.spec)
        committee = ctxt.committee_cache(
            adv, compute_epoch_at_slot(att_slot, self.preset)
        ).get_beacon_committee(att_slot, 0)
        peers = {n.peer_id for n in group}
        return [
            (pos, v)
            for pos, v in enumerate(committee)
            if v in self.byz and self.validator_home.get(v) in peers
        ]

    def _byz_sign_aggregate(self, aggregator: int, attestation, adv):
        """SignedAggregateAndProof through the byz store's real
        selection-proof + aggregate-and-proof signing path."""
        from ..types import types_for

        t = types_for(self.preset)
        pk = self.byz.pubkey_of(aggregator)
        proof = self.byz.store.sign_selection_proof(
            pk, attestation.data.slot, adv
        )
        msg = t.AggregateAndProof(
            aggregator_index=aggregator,
            aggregate=attestation,
            selection_proof=proof.to_bytes(),
        )
        sig = self.byz.store.sign_aggregate_and_proof(pk, msg, adv)
        return t.SignedAggregateAndProof(
            message=msg, signature=sig.to_bytes()
        )

    def _byz_double_propose(self, slot, ctx) -> None:
        """A SECOND distinct proposal for the slot, signed by the byz
        proposer through the store: the honest proposal is signed first
        (the real duty, cleanly recorded), so the double is exactly the
        message the slashing DB refuses — the refusal is overridden and
        audited. Honest nodes must IGNORE the double via gossip and
        their slashers must emit a ProposerSlashing."""
        store = self.byz.store
        proposer = ctx["proposer"]
        pk = self.byz.pubkey_of(proposer)
        store.sign_block(pk, ctx["signed"].message, ctx["adv"])
        double, _ = self.producer.produce_block(
            slot,
            ctx["atts"],
            base_state=ctx["parent_state"],
            graffiti=b"byz-vc-double",
        )
        sig = store.sign_block(pk, double.message, ctx["adv"])
        double.signature = sig.to_bytes()
        self.equivocation_roots.append(double.message.tree_hash_root())
        self.raw_bus.publish("byzvc", ctx["home"]._topic_block, double)
        self.byz_counts["double_proposals"] += 1

    def _byz_votes(self, slot, ctx, seats) -> None:
        """Per-seat slashable voting on the attestation subnet. Gossip
        dedup admits ONE unaggregated vote per (target epoch, attester),
        so each byz seat gossips a single vote per epoch: an honest one
        while justification is young (building the history a surround
        needs), then — with surround_votes on — a vote whose source is
        dragged back to genesis, surrounding its own earlier honest vote.
        Conflicting DOUBLE votes ride the aggregate lane instead
        (_byz_conflicting_aggregates): two distinct byz aggregators pass
        the per-aggregator dedup where a second subnet vote cannot."""
        from ..types import types_for
        from ..types.containers import AttestationData, Checkpoint
        from .message_bus import topic_name

        adv = ctx["adv"]
        att_slot = slot - 1
        plan = self.byz.plan
        store = self.byz.store
        t = types_for(self.preset)
        anchor = ctx["home"]
        topic = topic_name("beacon_attestation", anchor.fork_digest, 0)
        genesis_root = bytes(anchor.chain.genesis_block_root)
        honest = self.producer.attestation_data_for(adv, att_slot, 0)
        for pos, v in seats:
            pk = self.byz.pubkey_of(v)
            if plan.surround_votes and honest.source.epoch >= 1:
                # source dragged back to genesis: (0, target) surrounds
                # this validator's own earlier honest (>=1, target') vote
                data = AttestationData(
                    slot=honest.slot,
                    index=honest.index,
                    beacon_block_root=bytes(honest.beacon_block_root),
                    source=Checkpoint(epoch=0, root=genesis_root),
                    target=Checkpoint(
                        epoch=honest.target.epoch,
                        root=bytes(honest.target.root),
                    ),
                )
                self.byz_counts["surround_votes"] += 1
            else:
                data = honest
                self.byz_counts["honest_votes_gossiped"] += 1
            sig = store.sign_attestation(pk, data, adv)
            att = self.producer.make_unaggregated(adv, att_slot, 0, pos)
            att = t.Attestation(
                aggregation_bits=att.aggregation_bits,
                data=data,
                signature=sig.to_bytes(),
            )
            self.raw_bus.publish("byzvc", topic, att)
        if plan.conflicting_votes and len(seats) >= 2:
            self._byz_conflicting_aggregates(
                slot, ctx, seats, honest, genesis_root
            )

    def _byz_conflicting_aggregates(
        self, slot, ctx, seats, honest, genesis_root
    ) -> None:
        """The conflicting DOUBLE vote: the group's byz seats vote two
        different heads for the same (slot, target), each variant relayed
        by a DIFFERENT byz aggregator — the (epoch, aggregator) gossip
        dedup admits both, every honest slasher sees both verified
        indexed attestations, and the shared attesting indices are a
        double-vote detection (AttesterSlashing)."""
        from ..crypto.bls.api import INFINITY_SIGNATURE
        from ..state_transition import ConsensusContext
        from ..types import compute_epoch_at_slot, types_for
        from ..types.containers import AttestationData, Checkpoint

        adv = ctx["adv"]
        att_slot = slot - 1
        store = self.byz.store
        t = types_for(self.preset)
        ctxt = ConsensusContext(self.preset, self.spec)
        committee = ctxt.committee_cache(
            adv, compute_epoch_at_slot(att_slot, self.preset)
        ).get_beacon_committee(att_slot, 0)
        members = {v for _, v in seats}
        bits = tuple(v in members for v in committee)
        conflict = AttestationData(
            slot=honest.slot,
            index=honest.index,
            beacon_block_root=genesis_root,
            source=Checkpoint(
                epoch=honest.source.epoch, root=bytes(honest.source.root)
            ),
            target=Checkpoint(
                epoch=honest.target.epoch, root=bytes(honest.target.root)
            ),
        )
        # every seat signs the conflicting data through the store: the
        # slashing DB refuses each double vote; refusals are overridden
        # and audited (the honest variant was signed in _byz_votes)
        for _, v in seats:
            store.sign_attestation(self.byz.pubkey_of(v), conflict, adv)
        topic = ctx["home"]._topic_aggregate
        # aggregators from the tail of the seat list: the speculation
        # path's honest aggregator is the committee head, and one
        # (epoch, aggregator) dedup slot must not eat the byz pair
        agg_honest, agg_conflict = seats[-1][1], seats[-2][1]
        for aggregator, data in (
            (agg_honest, honest),
            (agg_conflict, conflict),
        ):
            att = t.Attestation(
                aggregation_bits=bits, data=data, signature=INFINITY_SIGNATURE
            )
            signed = self._byz_sign_aggregate(aggregator, att, adv)
            self.byz_aggregate_roots.append(att.tree_hash_root())
            self.raw_bus.publish("byzvc", topic, signed)
        self.byz_counts["conflicting_vote_pairs"] += 1

    def _byz_equivocating_aggregate(self, slot, ctx, seats) -> None:
        """ONE byz aggregator signs TWO distinct aggregates for the same
        (slot, committee): full honest participation bits, then a
        single-seat subset of the same data. Honest nodes verify and
        import at most one ((epoch, aggregator) dedup IGNOREs the
        second) and speculation must never confirm either by lookup."""
        from ..types import types_for

        adv = ctx["adv"]
        att_slot = slot - 1
        t = types_for(self.preset)
        full = self.producer.attestations_for_slot(adv, att_slot)[0]
        pos, aggregator = seats[-1]
        bits = tuple(
            i == pos for i in range(len(list(full.aggregation_bits)))
        )
        subset = t.Attestation(
            aggregation_bits=bits,
            data=full.data,
            signature=bytes(full.signature),
        )
        topic = ctx["home"]._topic_aggregate
        for att in (full, subset):
            signed = self._byz_sign_aggregate(aggregator, att, adv)
            self.byz_aggregate_roots.append(att.tree_hash_root())
            self.raw_bus.publish("byzvc", topic, signed)
        self.byz_counts["equivocating_aggregates"] += 1

    def publish_conflicting_attestations(self, slot: int) -> None:
        """A Byzantine double vote: two attestations from the same
        committee seat for the same slot naming DIFFERENT head blocks,
        both relayed on the subnet. Dedup (ObservedAttesters) must keep
        fork choice single-voted; the network must keep finalizing."""
        from ..state_transition import clone_state, process_slots
        from ..types.containers import AttestationData, Checkpoint
        from ..types import types_for
        from .message_bus import topic_name

        if not self.nodes:
            return
        leader = self.nodes[0]
        head = leader.chain.head_state
        adv = process_slots(
            clone_state(head), slot, self.preset, self.spec
        )
        att = self.producer.make_unaggregated(adv, slot - 1, 0, 0)
        d = att.data
        conflicting = types_for(self.preset).Attestation(
            aggregation_bits=att.aggregation_bits,
            data=AttestationData(
                slot=d.slot,
                index=d.index,
                beacon_block_root=leader.chain.genesis_block_root,
                source=Checkpoint(
                    epoch=d.source.epoch, root=bytes(d.source.root)
                ),
                target=Checkpoint(
                    epoch=d.target.epoch, root=bytes(d.target.root)
                ),
            ),
            signature=att.signature,
        )
        topic = topic_name(
            "beacon_attestation", leader.fork_digest, 0
        )
        self.raw_bus.join_group("byz", leader.peer_id)
        self.raw_bus.publish("byz", topic, att)
        self.raw_bus.publish("byz", topic, conflicting)

    def drain(self) -> list[NetworkNode]:
        """Drain every node's processor; a node whose store kills the
        "process" mid-import (InjectedCrash) drops off the bus and is
        returned for the scenario runner to reopen."""
        crashed = []
        for n in list(self.nodes):
            try:
                n.processor.run_until_idle()
            except InjectedCrash:
                crashed.append(n)
        for n in crashed:
            self.mark_dead(n)
        return crashed

    def run_epochs(self, epochs: int, attest: bool = True) -> None:
        start = (
            max(n.chain.head_state.slot for n in self.nodes) + 1
        )
        for slot in range(start, start + epochs * self.preset.slots_per_epoch):
            self.run_slot(slot, attest=attest)

    def sync_all(self) -> int:
        """Every node range-syncs from its best peers AND reconciles
        peer forks (post-heal / post-churn catch-up): range sync only
        pulls from peers strictly AHEAD, so two equal-height forks left
        by a partition are exchanged via unknown-head block lookups (the
        reference's block_lookups path). Fork choice then converges every
        node onto the heavier fork. Returns total imported blocks."""
        from .node import STATUS_PROTOCOL

        imported = 0
        # fork reconciliation FIRST: equal-height forks are invisible to
        # range sync's strictly-ahead ranking, and a range batch from the
        # other fork without its ancestors would burn retry budget
        for n in list(self.nodes):
            try:
                for peer in self.raw_bus.peers_on(n._topic_block):
                    if peer == n.peer_id:
                        continue
                    try:
                        status = self.bus.request(
                            n.peer_id, peer, STATUS_PROTOCOL, {}
                        )
                        head = bytes(status["head_root"])
                        if head not in n.chain._states:
                            n.sync_manager.lookup_block(head)
                    except (ConnectionError, OSError):
                        # unreachable/faulted peer: reconcile the REST —
                        # one dead peer must not abort the whole round
                        continue
                n.chain.recompute_head()
            except InjectedCrash:
                self.mark_dead(n)
        for n in list(self.nodes):
            try:
                imported += n.range_sync()
            except InjectedCrash:
                self.mark_dead(n)
        self.drain()
        return imported

    # -- checks (testing/simulator/src/checks.rs) ---------------------------

    def check_all_heads_equal(self) -> bytes:
        heads = {n.chain.head_root for n in self.nodes}
        assert len(heads) == 1, f"nodes diverged: {len(heads)} heads"
        return heads.pop()

    def check_finality(self, min_epoch: int) -> None:
        for n in self.nodes:
            assert n.chain.finalized_checkpoint[0] >= min_epoch, (
                f"{n.peer_id} finalized {n.chain.finalized_checkpoint[0]}"
                f" < {min_epoch}"
            )

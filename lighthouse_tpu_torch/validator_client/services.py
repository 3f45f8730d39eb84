"""Validator-client duty services (reference validator_client/src/:
duties_service.rs:236-765, attestation_service.rs, block_service.rs,
doppelganger_service.rs, beacon_node_fallback.rs:293).

The services are synchronous per-slot steppers driven by a clock
(`ValidatorClient.on_slot`), mirroring the reference's slot-timer tasks:
block at slot start, attestations at 1/3 slot, aggregates at 2/3 slot,
duty polling per epoch.

The port's copy of lighthouse_tpu/validator_client/services.py.
"""

from __future__ import annotations

from ..chain.attestation_verification import is_aggregator
from ..resilience.primitives import AllEndpointsFailed, EventLog, HealthTracker
from ..types import compute_epoch_at_slot, types_for
from ..types.presets import Preset
from .validator_store import DoppelgangerHold, ValidatorStore
from .slashing_protection import NotSafe


class NoHealthyBeaconNode(RuntimeError):
    pass


class BeaconNodeFallback:
    """Health-scored multi-BN redundancy (beacon_node_fallback.rs:293):
    candidates are ranked by a HealthTracker over recent call outcomes
    (replacing first-healthy-wins), so a node that keeps failing duties
    sinks below a working one even while its own `is_healthy()` still
    says yes. Demoted nodes re-probe after a bounded number of passes
    (the reference's candidate re-check loop), so a recovered node wins
    its ranking back instead of being skipped forever."""

    def __init__(
        self,
        candidates,
        tracker: HealthTracker | None = None,
        events: EventLog | None = None,
    ):
        self.candidates = list(candidates)
        self.tracker = tracker or HealthTracker(
            window=4, threshold=0.5, reprobe_after_skips=2, name="beacon_node"
        )
        self.events = events

    def ranked(self):
        """Candidates best-first: healthy-or-reprobe-due by descending
        score, then demoted nodes as a last resort."""
        order = self.tracker.ranked(range(len(self.candidates)))
        return [self.candidates[i] for i in order]

    def best(self):
        for node in self.ranked():
            if node.is_healthy():
                return node
        raise NoHealthyBeaconNode("no healthy beacon node available")

    def record_outcome(self, node, ok: bool) -> None:
        """Feed one duty outcome for `node` into the ranking tracker
        (the per-slot duty loop reports here; see ValidatorClient.on_slot)."""
        for i, candidate in enumerate(self.candidates):
            if candidate is node:
                self.tracker.record(i, ok)
                return

    def call(self, fn):
        def on_error(i, e):
            if self.events is not None:
                self.events.record(
                    "bn_call_failed", index=i, error=type(e).__name__
                )

        try:
            _, out = self.tracker.failover(
                self.candidates,
                fn,
                retry_on=(Exception,),  # noqa: BLE001 -- reference
                # retries duty calls broadly (beacon_node_fallback.rs)
                skip=lambda node: not node.is_healthy(),
                on_error=on_error,
            )
        except AllEndpointsFailed as e:
            if e.last is not None:
                raise e.last
            raise NoHealthyBeaconNode(
                "no healthy beacon node available"
            ) from None
        return out


class DutiesService:
    """Maintains proposer/attester duty maps per epoch
    (duties_service.rs:236,356,460,765)."""

    def __init__(self, store: ValidatorStore, nodes: BeaconNodeFallback):
        self.store = store
        self.nodes = nodes
        self.proposers: dict[int, list[tuple[int, int]]] = {}
        self.attesters: dict[int, list[dict]] = {}
        self._polled: set[int] = set()

    def our_indices(self) -> set[int]:
        out = set()
        for pk in self.store.voting_pubkeys():
            idx = self.store.validator_index(pk)
            if idx is not None:
                out.add(idx)
        return out

    def poll(self, epoch: int) -> None:
        """Fetch duties for `epoch` and `epoch + 1` (the reference's
        lookahead) if not already known."""
        node = self.nodes.best()
        # resolve unknown validator indices first (poll_validator_indices)
        unknown = [
            pk
            for pk in self.store.voting_pubkeys()
            if self.store.validator_index(pk) is None
        ]
        if unknown:
            for pk, idx in node.validator_index_map(unknown).items():
                self.store.set_index(pk, idx)
        for e in (epoch, epoch + 1):
            if e in self._polled:
                continue
            self.proposers[e] = node.get_proposer_duties(e)
            self.attesters[e] = node.get_attester_duties(
                e, sorted(self.our_indices())
            )
            self._polled.add(e)

    def block_proposal_duty(self, slot: int, preset: Preset):
        epoch = compute_epoch_at_slot(slot, preset)
        ours = self.our_indices()
        for duty_slot, proposer in self.proposers.get(epoch, []):
            if duty_slot == slot and proposer in ours:
                return proposer
        return None

    def attestation_duties_at(self, slot: int, preset: Preset):
        epoch = compute_epoch_at_slot(slot, preset)
        return [
            d for d in self.attesters.get(epoch, []) if d["slot"] == slot
        ]


class ValidatorClient:
    """ProductionValidatorClient equivalent (validator_client/src/lib.rs:86):
    owns the store and services; `on_slot` performs every duty for the
    slot in the reference's intra-slot order."""

    def __init__(
        self,
        store: ValidatorStore,
        nodes: BeaconNodeFallback,
        preset: Preset,
        spec,
        graffiti: bytes = b"",
        graffiti_file: str | None = None,
    ):
        self.store = store
        self.nodes = nodes
        self.preset = preset
        self.spec = spec
        # default graffiti + optional per-validator overrides (reference
        # --graffiti flag and --graffiti-file: `pubkey: text` lines, with
        # `default: text` for the fallback)
        self.graffiti = bytes(graffiti)
        self.graffiti_overrides: dict[bytes, bytes] = {}
        if graffiti_file:
            self._load_graffiti_file(graffiti_file)
        self.duties = DutiesService(store, nodes)
        self.blocks_proposed: list[bytes] = []
        self.attestations_published = 0
        self.aggregates_published = 0
        self.sync_messages_published = 0
        self.sync_contributions_published = 0
        self.doppelganger_detected: list[bytes] = []
        self.duty_errors: list[tuple[int, str, str]] = []
        self._dg_start: dict[bytes, int] = {}
        self._prepared_epochs: set[int] = set()
        self._registered_epochs: set[int] = set()

    def _pubkey_for_index(self, index: int) -> bytes | None:
        for pk in self.store.voting_pubkeys():
            if self.store.validator_index(pk) == index:
                return pk
        return None

    def _load_graffiti_file(self, path: str) -> None:
        """`0x<pubkey>: text` per line, `default: text` for the fallback
        (the reference's GraffitiFile format)."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                key, _, text = line.partition(":")
                text = text.strip().encode()[:32]
                key = key.strip()
                if key == "default":
                    self.graffiti = text
                else:
                    pk = bytes.fromhex(key.removeprefix("0x"))
                    self.graffiti_overrides[pk] = text

    def graffiti_for(self, pubkey: bytes | None) -> bytes:
        if pubkey is not None and pubkey in self.graffiti_overrides:
            return self.graffiti_overrides[pubkey]
        return self.graffiti

    # -- per-slot duty execution --------------------------------------------

    def on_slot(self, slot: int) -> None:
        epoch = compute_epoch_at_slot(slot, self.preset)
        self.duties.poll(epoch)
        self._doppelganger_scan(epoch)
        # one failing duty must never take down the client or starve the
        # REMAINING duties of the slot (e.g. a BN whose eth1 cache lags
        # raises Eth1DepositsUnavailable from produce_block at our
        # proposal slot -- attestations still have to go out)
        for duty in (
            self._preparation_duty,
            self._builder_registrations,
        ):
            try:
                duty(epoch)
            except Exception as e:  # noqa: BLE001
                self.duty_errors.append((slot, duty.__name__, str(e)))
        for duty in (
            self._block_duty,
            self._attestation_duty,
            self._sync_committee_duty,
            self._aggregation_duty,
            self._sync_aggregation_duty,
        ):
            # each duty's outcome feeds the fallback's HealthTracker:
            # a node whose duties keep failing is demoted in the ranking
            # (and re-probed later), so failover engages from the REAL
            # duty path, not only from tests
            node = None
            try:
                node = self.nodes.best()
                duty(slot)
            except Exception as e:  # noqa: BLE001
                self.duty_errors.append((slot, duty.__name__, str(e)))
                if node is not None:
                    self.nodes.record_outcome(node, False)
            else:
                self.nodes.record_outcome(node, True)

    # -- preparation / fee recipients (preparation_service.rs) ---------------

    def _preparation_duty(self, epoch: int) -> None:
        """Once per epoch, push proposer preparations (validator index +
        fee recipient) to the BN so payload builds credit the right
        address."""
        if epoch in self._prepared_epochs:
            return
        preps = []
        for pk in self.store.voting_pubkeys():
            idx = self.store.validator_index(pk)
            fee = self.store.fee_recipient_for(pk)
            if idx is None or fee is None:
                continue  # unconfigured recipients are not pushed
            preps.append({"validator_index": idx, "fee_recipient": fee})
        if not preps:
            return
        # push to EVERY healthy BN, not just the current best: a mid-epoch
        # failover target must already hold the recipients
        pushed = False
        for node in self.nodes.candidates:
            if node.is_healthy() and hasattr(node, "prepare_proposers"):
                node.prepare_proposers(preps)
                pushed = True
        if pushed:
            self._prepared_epochs.add(epoch)
            # bounded: re-pushing an old epoch is harmless, so keep a
            # short memory rather than growing forever
            self._prepared_epochs = {
                e for e in self._prepared_epochs if e + 2 >= epoch
            }

    def _builder_registrations(self, epoch: int) -> None:
        """Sign + fan out builder-network registrations for every
        validator with a fee recipient (preparation_service.rs's
        register_validators leg). Independent of proposer preparations:
        registrations need no validator index, and are retried within the
        epoch until at least one builder-capable BN takes them."""
        if epoch in self._registered_epochs:
            return
        timestamp = (
            epoch
            * self.preset.slots_per_epoch
            * self.store.spec.seconds_per_slot
        )
        regs = []
        for pk in self.store.voting_pubkeys():
            fee = self.store.fee_recipient_for(pk)
            if fee is None:
                continue
            try:
                regs.append(
                    self.store.sign_validator_registration(
                        pk, fee, 30_000_000, timestamp
                    )
                )
            except Exception:  # noqa: BLE001 -- doppelganger hold etc.
                continue
        if not regs:
            return
        pushed = False
        for node in self.nodes.candidates:
            if node.is_healthy() and hasattr(node, "register_validators"):
                try:
                    node.register_validators(regs)
                    pushed = True
                except Exception:  # noqa: BLE001 -- builder down must not
                    continue  # abort the block/attestation duties below
        if pushed:
            self._registered_epochs.add(epoch)
            self._registered_epochs = {
                e for e in self._registered_epochs if e + 2 >= epoch
            }

    def _block_duty(self, slot: int) -> None:
        proposer = self.duties.block_proposal_duty(slot, self.preset)
        if proposer is None:
            return
        pubkey = self._pubkey_for_index(proposer)
        node = self.nodes.best()
        state = node.signing_context()
        epoch = compute_epoch_at_slot(slot, self.preset)
        try:
            randao = self.store.sign_randao(pubkey, epoch, state)
            block = node.produce_block(
                slot, randao.to_bytes(), graffiti=self.graffiti_for(pubkey)
            )
            sig = self.store.sign_block(pubkey, block, state)
        except (NotSafe, DoppelgangerHold):
            return
        t = types_for(self.preset)
        from ..types.containers import block_classes_for

        _, signed_cls, _ = block_classes_for(t, type(block).fork_name)
        root = node.publish_block(
            signed_cls(message=block, signature=sig.to_bytes())
        )
        self.blocks_proposed.append(root)

    def _attestation_duty(self, slot: int) -> None:
        duties = self.duties.attestation_duties_at(slot, self.preset)
        if not duties:
            return
        node = self.nodes.best()
        t = types_for(self.preset)
        state = node.signing_context()
        for d in duties:
            pubkey = self._pubkey_for_index(d["validator_index"])
            if pubkey is None:
                continue
            data = node.produce_attestation_data(slot, d["committee_index"])
            try:
                sig = self.store.sign_attestation(pubkey, data, state)
            except (NotSafe, DoppelgangerHold):
                continue
            bits = tuple(
                i == d["committee_position"]
                for i in range(d["committee_length"])
            )
            node.publish_attestation(
                t.Attestation(
                    aggregation_bits=bits,
                    data=data,
                    signature=sig.to_bytes(),
                )
            )
            self.attestations_published += 1

    def _aggregation_duty(self, slot: int) -> None:
        duties = self.duties.attestation_duties_at(slot, self.preset)
        if not duties:
            return
        node = self.nodes.best()
        t = types_for(self.preset)
        state = node.signing_context()
        for d in duties:
            pubkey = self._pubkey_for_index(d["validator_index"])
            if pubkey is None:
                continue
            try:
                proof = self.store.sign_selection_proof(pubkey, slot, state)
            except DoppelgangerHold:
                continue
            if not is_aggregator(
                d["committee_length"], proof.to_bytes(), self.spec
            ):
                continue
            data = node.produce_attestation_data(slot, d["committee_index"])
            aggregate = node.get_aggregate(data)
            if aggregate is None:
                continue
            msg = t.AggregateAndProof(
                aggregator_index=d["validator_index"],
                aggregate=aggregate,
                selection_proof=proof.to_bytes(),
            )
            try:
                sig = self.store.sign_aggregate_and_proof(pubkey, msg, state)
            except DoppelgangerHold:
                continue
            node.publish_aggregate_and_proof(
                t.SignedAggregateAndProof(
                    message=msg, signature=sig.to_bytes()
                )
            )
            self.aggregates_published += 1

    # -- sync committee (sync_committee_service.rs) --------------------------

    def _sync_duties(self, slot: int):
        node = self.nodes.best()
        epoch = compute_epoch_at_slot(slot, self.preset)
        indices = sorted(self.duties.our_indices())
        if not indices or not hasattr(node, "get_sync_duties"):
            return node, []
        return node, node.get_sync_duties(epoch, indices)

    def _sync_committee_duty(self, slot: int) -> None:
        """At slot start + 1/3 (the attestation tick): sign the head root
        as a SyncCommitteeMessage on each of our subnets."""
        node, duties = self._sync_duties(slot)
        if not duties:
            return
        state = node.signing_context()
        head_root = node.chain.head_root if hasattr(node, "chain") else None
        if head_root is None:
            return
        for d in duties:
            pubkey = self._pubkey_for_index(d["validator_index"])
            if pubkey is None:
                continue
            try:
                sig = self.store.sign_sync_committee_message(
                    pubkey, slot, head_root, state
                )
            except (NotSafe, DoppelgangerHold):
                continue
            from ..types.containers import SyncCommitteeMessage

            msg = SyncCommitteeMessage(
                slot=slot,
                beacon_block_root=head_root,
                validator_index=d["validator_index"],
                signature=sig.to_bytes(),
            )
            for subnet in d["subnets"]:
                node.publish_sync_message(msg, subnet)
                self.sync_messages_published += 1

    def _sync_aggregation_duty(self, slot: int) -> None:
        """At 2/3 slot: aggregators fetch their subnet's contribution and
        publish SignedContributionAndProof."""
        from ..chain.sync_committee_verification import (
            is_sync_committee_aggregator,
        )

        node, duties = self._sync_duties(slot)
        if not duties:
            return
        t = types_for(self.preset)
        state = node.signing_context()
        head_root = node.chain.head_root if hasattr(node, "chain") else None
        if head_root is None:
            return
        for d in duties:
            pubkey = self._pubkey_for_index(d["validator_index"])
            if pubkey is None:
                continue
            for subnet in d["subnets"]:
                try:
                    proof = self.store.sign_sync_selection_proof(
                        pubkey, slot, subnet, state
                    )
                except DoppelgangerHold:
                    continue
                if not is_sync_committee_aggregator(
                    proof.to_bytes(), self.preset, self.spec
                ):
                    continue
                contribution = node.get_sync_contribution(
                    slot, head_root, subnet
                )
                if contribution is None:
                    continue
                msg = t.ContributionAndProof(
                    aggregator_index=d["validator_index"],
                    contribution=contribution,
                    selection_proof=proof.to_bytes(),
                )
                try:
                    sig = self.store.sign_contribution_and_proof(
                        pubkey, msg, state
                    )
                except DoppelgangerHold:
                    continue
                node.publish_contribution_and_proof(
                    t.SignedContributionAndProof(
                        message=msg, signature=sig.to_bytes()
                    )
                )
                self.sync_contributions_published += 1

    # -- doppelganger (doppelganger_service.rs:1-25) ------------------------

    DOPPELGANGER_CLEAN_EPOCHS = 2

    def _doppelganger_scan(self, epoch: int) -> None:
        """Per held validator: record the epoch protection started, then
        require DOPPELGANGER_CLEAN_EPOCHS fully-elapsed epochs with no
        sighting of our index before releasing. A sighting is a detection
        (the reference shuts the process down; we record and keep the
        hold). If the node exposes no observed-attesters view, detection
        is impossible: the timed release still runs so duties do not stall
        forever (documented divergence)."""
        node = self.nodes.best()
        observed = getattr(node, "observed_attesters", None)
        for pk in self.store.voting_pubkeys():
            if not self.store._doppelganger_hold.get(pk):
                continue
            start = self._dg_start.setdefault(pk, epoch)
            idx = self.store.validator_index(pk)
            if observed is not None and idx is not None:
                for e in range(max(start - 1, 0), epoch + 1):
                    if observed.is_known(e, idx):
                        if pk not in self.doppelganger_detected:
                            self.doppelganger_detected.append(pk)
                        break
                else:
                    if epoch >= start + self.DOPPELGANGER_CLEAN_EPOCHS:
                        self.store.release_doppelganger(pk)
            elif epoch >= start + self.DOPPELGANGER_CLEAN_EPOCHS:
                self.store.release_doppelganger(pk)

"""In-process chain harness (reference beacon_chain/src/test_utils.rs
BeaconChainHarness:520 + EphemeralHarnessType): deterministic interop
validators, manual slots, block production with full-participation
attestations -- the framework's equivalent of "one model running
end-to-end" (SURVEY.md section 7 phase 4).

Signing uses the real interop keys unless `sign=False`, which emits
parseable placeholder signatures for fake-crypto runs (the reference's
fake_crypto feature + harness pairing).

The port's copy of lighthouse_tpu/harness/chain.py.
"""

from __future__ import annotations

from ..crypto.bls.api import AggregateSignature, INFINITY_SIGNATURE, Signature
from ..ssz import cached_root, uint64
from ..types import (
    ChainSpec,
    compute_epoch_at_slot,
    compute_signing_root,
    compute_start_slot_at_epoch,
    get_domain,
    interop_secret_key,
    types_for,
)
from ..types.chain_spec import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
)
from ..types.containers import (
    AttestationData,
    Checkpoint,
    SigningData,
    block_classes_for,
)
from ..types.helpers import get_block_root_at_slot
from ..types.presets import Preset
from ..state_transition import (
    BlockSignatureStrategy,
    ConsensusContext,
    clone_state,
    get_beacon_proposer_index,
    per_block_processing,
    process_slots,
)


class StateHarness:
    """Linear-chain harness over raw state transition (no fork choice/store;
    BeaconChainHarness proper builds on this plus the chain runtime)."""

    def __init__(
        self,
        validator_count: int,
        preset: Preset,
        spec: ChainSpec | None = None,
        sign: bool = True,
        execution_layer=None,
    ):
        from ..types import interop_genesis_state

        self.preset = preset
        self.spec = spec or ChainSpec.interop()
        self.sign = sign
        self.state = interop_genesis_state(validator_count, preset, self.spec)
        self.genesis_block_root = self.state.latest_block_header.tree_hash_root()
        self.blocks: list = []
        # optional EL handle: bellatrix blocks get real payloads from it
        self.execution_layer = execution_layer

    # -- signing helpers -----------------------------------------------------

    def _sign_root(self, root: bytes, validator_index: int) -> bytes:
        if not self.sign:
            return INFINITY_SIGNATURE
        sk = interop_secret_key(validator_index)
        return sk.sign(root).to_bytes()

    def aggregate_signature_source(self):
        """`signature_source(data, members, signing_root) -> bytes` for
        the speculation scheduler (speculate/): aggregates the members'
        interop-key signatures over the signing root — the harness/bench
        stand-in for a deployment that can see its own signers' output
        ahead of gossip. Returns None when the harness doesn't sign."""
        if not self.sign:
            return None

        def source(data, members, signing_root):
            agg = AggregateSignature.aggregate(
                [
                    Signature.from_bytes(
                        self._sign_root(signing_root, v)
                    )
                    for v in members
                ]
            )
            return agg.to_bytes()

        return source

    def _randao_reveal(self, state, proposer: int) -> bytes:
        epoch = compute_epoch_at_slot(state.slot, self.preset)
        domain = get_domain(state, DOMAIN_RANDAO, epoch, self.preset)
        root = SigningData(
            object_root=uint64.hash_tree_root(epoch), domain=domain
        ).tree_hash_root()
        return self._sign_root(root, proposer)

    # -- attestations --------------------------------------------------------

    def attestation_data_for(self, state, slot: int, index: int):
        """Spec-consistent AttestationData for (slot, committee index) as
        seen from `state` (at or past `slot`)."""
        epoch = compute_epoch_at_slot(slot, self.preset)
        head_root = get_block_root_at_slot(state, slot, self.preset)
        target_slot = compute_start_slot_at_epoch(epoch, self.preset)
        target_root = (
            get_block_root_at_slot(state, target_slot, self.preset)
            if target_slot < state.slot
            else head_root
        )
        if epoch == compute_epoch_at_slot(state.slot, self.preset):
            source = state.current_justified_checkpoint
        else:
            source = state.previous_justified_checkpoint
        return AttestationData(
            slot=slot,
            index=index,
            beacon_block_root=head_root,
            source=source,
            target=Checkpoint(epoch=epoch, root=target_root),
        )

    def attestations_for_slot(self, state, slot: int, validators=None):
        """Attestations for every committee at `slot` (state must be at
        or past `slot`). Full participation by default; `validators` (a
        container of validator indices) restricts the set bits to its
        members — the scenario harness's partition/withholding seat. A
        committee with no participating member yields no attestation."""
        t = types_for(self.preset)
        epoch = compute_epoch_at_slot(slot, self.preset)
        ctxt = ConsensusContext(self.preset, self.spec)
        cache = ctxt.committee_cache(state, epoch)
        out = []
        for index in range(cache.committees_per_slot):
            committee = cache.get_beacon_committee(slot, index)
            if validators is None:
                bits = tuple(True for _ in committee)
                signers = list(committee)
            else:
                bits = tuple(v in validators for v in committee)
                signers = [v for v in committee if v in validators]
                if not signers:
                    continue
            data = self.attestation_data_for(state, slot, index)
            if self.sign:
                domain = get_domain(
                    state, DOMAIN_BEACON_ATTESTER, epoch, self.preset
                )
                root = compute_signing_root(data, domain)
                agg = AggregateSignature.aggregate(
                    [
                        Signature.from_bytes(self._sign_root(root, v))
                        for v in signers
                    ]
                )
                sig = agg.to_bytes()
            else:
                sig = INFINITY_SIGNATURE
            out.append(
                t.Attestation(
                    aggregation_bits=bits,
                    data=data,
                    signature=sig,
                )
            )
        return out

    def make_unaggregated(self, state, slot: int, index: int, position: int):
        """Single-bit attestation from committee member at `position`
        (what a validator publishes to the subnet)."""
        ctxt = ConsensusContext(self.preset, self.spec)
        committee = ctxt.committee_cache(
            state, compute_epoch_at_slot(slot, self.preset)
        ).get_beacon_committee(slot, index)
        bits = tuple(i == position for i in range(len(committee)))
        data = self.attestation_data_for(state, slot, index)
        if self.sign:
            domain = get_domain(
                state,
                DOMAIN_BEACON_ATTESTER,
                data.target.epoch,
                self.preset,
            )
            sig = self._sign_root(
                compute_signing_root(data, domain), committee[position]
            )
        else:
            sig = INFINITY_SIGNATURE
        t = types_for(self.preset)
        return t.Attestation(
            aggregation_bits=bits, data=data, signature=sig
        )

    def make_signed_aggregate(self, state, slot: int, index: int):
        """Full-participation SignedAggregateAndProof from the first
        committee member that passes is_aggregator with a REAL selection
        proof (the aggregation duty path)."""
        from ..chain.attestation_verification import is_aggregator
        from ..types.chain_spec import (
            DOMAIN_AGGREGATE_AND_PROOF,
            DOMAIN_SELECTION_PROOF,
        )

        aggregate = self.attestations_for_slot(state, slot)[index]
        ctxt = ConsensusContext(self.preset, self.spec)
        epoch = compute_epoch_at_slot(slot, self.preset)
        committee = ctxt.committee_cache(state, epoch).get_beacon_committee(
            slot, index
        )
        sel_domain = get_domain(
            state, DOMAIN_SELECTION_PROOF, epoch, self.preset
        )
        sel_root = SigningData(
            object_root=uint64.hash_tree_root(slot), domain=sel_domain
        ).tree_hash_root()
        for aggregator in committee:
            proof = self._sign_root(sel_root, aggregator)
            if is_aggregator(len(committee), proof, self.spec):
                break
        else:
            raise RuntimeError("no aggregator found in committee")
        t = types_for(self.preset)
        msg = t.AggregateAndProof(
            aggregator_index=aggregator,
            aggregate=aggregate,
            selection_proof=proof,
        )
        agg_domain = get_domain(
            state, DOMAIN_AGGREGATE_AND_PROOF, epoch, self.preset
        )
        sig = self._sign_root(
            compute_signing_root(msg, agg_domain), aggregator
        )
        return t.SignedAggregateAndProof(message=msg, signature=sig)

    # -- block production ----------------------------------------------------

    def produce_block(
        self, slot: int, attestations=(), base_state=None, graffiti=None
    ):
        """Produce a signed block at `slot` on `base_state` (default: the
        linear head state). Returns (signed_block, post_state).
        `graffiti` distinguishes otherwise-identical blocks (the scenario
        harness's equivocation pairs)."""
        state = clone_state(base_state if base_state is not None else self.state)
        state = process_slots(state, slot, self.preset, self.spec)
        fork = state.fork_name
        t = types_for(self.preset)
        block_cls, signed_cls, body_cls = block_classes_for(t, fork)

        proposer = get_beacon_proposer_index(state, self.preset, self.spec)
        body = body_cls.default()
        body.randao_reveal = self._randao_reveal(state, proposer)
        body.eth1_data = state.eth1_data
        body.attestations = tuple(attestations)
        if graffiti is not None:
            body.graffiti = bytes(graffiti)[:32].ljust(32, b"\x00")
        if hasattr(body, "sync_aggregate"):
            # empty participation signs nothing: infinity signature (spec's
            # valid empty aggregate; SSZ default zero bytes do not parse)
            body.sync_aggregate.sync_committee_signature = INFINITY_SIGNATURE
        if (
            hasattr(body, "execution_payload")
            and self.execution_layer is not None
        ):
            body.execution_payload = self.execution_layer.build_payload_for_block(
                state, slot, proposer, self.preset, self.spec
            )

        block = block_cls(
            slot=slot,
            proposer_index=proposer,
            parent_root=state.latest_block_header.tree_hash_root(),
            state_root=bytes(32),
            body=body,
        )

        # apply on a scratch state to compute the post-state root
        scratch = clone_state(state)
        unsigned = signed_cls(message=block, signature=INFINITY_SIGNATURE)
        per_block_processing(
            scratch,
            unsigned,
            self.preset,
            self.spec,
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            verified_proposer_index=proposer,
        )
        block.state_root = cached_root(scratch)

        epoch = compute_epoch_at_slot(slot, self.preset)
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch, self.preset)
        signature = self._sign_root(
            compute_signing_root(block, domain), proposer
        )
        signed = signed_cls(message=block, signature=signature)
        return signed, scratch

    def apply_block(
        self,
        signed_block,
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ):
        """Advance the head state through `signed_block` (verifying
        signatures per strategy) and record it."""
        state = clone_state(self.state)
        state = process_slots(
            state, signed_block.message.slot, self.preset, self.spec
        )
        per_block_processing(
            state, signed_block, self.preset, self.spec, strategy=strategy
        )
        if bytes(signed_block.message.state_root) != cached_root(state):
            raise ValueError("block state_root mismatch")
        self.state = state
        self.blocks.append(signed_block)
        return state

    def extend_chain(
        self,
        num_slots: int,
        attest: bool = True,
        strategy: BlockSignatureStrategy | None = None,
    ):
        """Produce/apply one block per slot, attesting at full participation
        (the harness's extend_chain equivalent)."""
        if strategy is None:
            strategy = (
                BlockSignatureStrategy.VERIFY_BULK
                if self.sign
                else BlockSignatureStrategy.NO_VERIFICATION
            )
        for _ in range(num_slots):
            slot = self.state.slot + 1
            atts = []
            if attest and slot > 1:
                att_state = clone_state(self.state)
                att_state = process_slots(
                    att_state, slot, self.preset, self.spec
                )
                atts = self.attestations_for_slot(att_state, slot - 1)
            signed, _ = self.produce_block(slot, atts)
            self.apply_block(signed, strategy=strategy)
        return self.state

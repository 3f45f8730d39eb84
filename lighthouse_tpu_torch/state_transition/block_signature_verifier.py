"""Block signature verifier: collect EVERY signature in a block into one
set list, verify with ONE backend call (reference consensus/
state_processing/src/per_block_processing/block_signature_verifier.rs:73,
127-138 -- its rayon map-reduce at :357-385 becomes the batch verifier's
internal set-axis parallelism on the card)."""

from __future__ import annotations

from ..crypto.bls.api import verify_signature_sets_async
from ..types.presets import Preset
from .context import ConsensusContext
from .signature_sets import (
    attester_slashing_signature_sets,
    block_proposal_signature_set,
    deposit_signature_set,
    exit_signature_set,
    indexed_attestation_signature_set,
    proposer_slashing_signature_sets,
    randao_signature_set,
    state_pubkey_getter,
    sync_aggregate_signature_set,
)


class BlockSignatureVerifier:
    def __init__(
        self,
        state,
        preset: Preset,
        spec,
        ctxt: ConsensusContext | None = None,
        get_pubkey=None,
        resolve_pubkey=None,
    ):
        self.state = state
        self.preset = preset
        self.spec = spec
        self.ctxt = ctxt or ConsensusContext(preset, spec)
        self.get_pubkey = get_pubkey or state_pubkey_getter(state)
        # bytes -> PublicKey for sync-committee participants; the chain
        # plugs its pubkey cache here so keys stay table-tagged
        self.resolve_pubkey = resolve_pubkey
        self.sets = []

    # include_* mirror block_signature_verifier.rs:141-340

    def include_block_proposal(self, signed_block):
        self.sets.append(
            block_proposal_signature_set(
                self.state, self.get_pubkey, signed_block, self.preset, self.spec
            )
        )

    def include_randao_reveal(self, signed_block):
        block = signed_block.message
        self.sets.append(
            randao_signature_set(
                self.state,
                self.get_pubkey,
                block.proposer_index,
                block.body.randao_reveal,
                self.preset,
                self.spec,
            )
        )

    def include_proposer_slashings(self, signed_block):
        for op in signed_block.message.body.proposer_slashings:
            self.sets.extend(
                proposer_slashing_signature_sets(
                    self.state, self.get_pubkey, op, self.preset, self.spec
                )
            )

    def include_attester_slashings(self, signed_block):
        for op in signed_block.message.body.attester_slashings:
            self.sets.extend(
                attester_slashing_signature_sets(
                    self.state, self.get_pubkey, op, self.preset, self.spec
                )
            )

    def include_attestations(self, signed_block):
        for att in signed_block.message.body.attestations:
            indexed = self.ctxt.get_indexed_attestation(self.state, att)
            self.sets.append(
                indexed_attestation_signature_set(
                    self.state, self.get_pubkey, indexed, self.preset, self.spec
                )
            )

    def include_exits(self, signed_block):
        for op in signed_block.message.body.voluntary_exits:
            self.sets.append(
                exit_signature_set(
                    self.state, self.get_pubkey, op, self.preset, self.spec
                )
            )

    def include_sync_aggregate(self, signed_block):
        body = signed_block.message.body
        sync_aggregate = getattr(body, "sync_aggregate", None)
        if sync_aggregate is None:
            return
        from ..types.helpers import get_block_root_at_slot

        block = signed_block.message
        root = bytes(block.parent_root)
        s = sync_aggregate_signature_set(
            self.state,
            self.resolve_pubkey,
            sync_aggregate,
            block.slot,
            root,
            list(self.state.current_sync_committee.pubkeys),
            self.preset,
            self.spec,
        )
        if s is not None:
            self.sets.append(s)

    def include_all_signatures(self, signed_block):
        """Everything except deposits (deposits self-certify and are
        verified during processing, as the reference does)."""
        self.include_block_proposal(signed_block)
        self.include_all_signatures_except_block_proposal(signed_block)

    def include_all_signatures_except_block_proposal(self, signed_block):
        self.include_randao_reveal(signed_block)
        self.include_proposer_slashings(signed_block)
        self.include_attester_slashings(signed_block)
        self.include_attestations(signed_block)
        self.include_exits(signed_block)
        self.include_sync_aggregate(signed_block)

    def verify(self, slot: int | None = None) -> bool:
        """One device program for the whole block's sets. Routed on the
        block lane: under continuous batching the sets merge with queued
        attestation/sync traffic at the HIGHEST priority; when the chain
        passed its pubkey-cache getter in, every set is table-tagged, so
        the batch rides the device-table gather (and the sharded mesh at
        mesh-eligible sizes) -- whole-block import as one sharded device
        program."""
        if not self.sets:
            return True
        return verify_signature_sets_async(
            self.sets, lane="block", slot=slot
        ).result()

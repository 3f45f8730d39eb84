"""Slasher service: the glue between gossip verification, the slasher
database, and block production (reference slasher/service/src/lib.rs).

The node feeds it every VERIFIED gossip attestation (already indexed by
the batch verifier) and every imported block's header; once per slot it
drains the slasher's queues, and any detected equivocations become
AttesterSlashing/ProposerSlashing operations injected into the local op
pool (for inclusion in the next produced block) and handed to an optional
broadcast hook (the node publishes them on the slashing gossip topics).


The port's copy of lighthouse_tpu/slasher/service.py.
"""

from __future__ import annotations

from .slasher import Slasher


class SlasherService:
    def __init__(
        self, slasher: Slasher, op_pool, broadcast=None, fork_choice=None
    ):
        self.slasher = slasher
        self.op_pool = op_pool
        # fn(kind: "attester_slashing" | "proposer_slashing", op) -> None
        self.broadcast = broadcast
        # the detecting node strips equivocators' fork-choice weight
        # immediately, same as nodes learning via gossip (spec
        # on_attester_slashing)
        self.fork_choice = fork_choice
        # lifetime counters (the reference's slasher metrics seat)
        self.attestations_seen = 0
        self.blocks_seen = 0
        self.attester_slashings_found = 0
        self.proposer_slashings_found = 0

    # -- ingestion (service/src/lib.rs gossip feeds) ------------------------

    def accept_attestation(self, indexed_attestation) -> None:
        self.attestations_seen += 1
        self.slasher.accept_attestation(indexed_attestation)

    def accept_block(self, signed_block) -> None:
        """Reduce an imported block to its signed header (what the slasher
        stores and what a ProposerSlashing carries)."""
        from ..types.containers import SignedBeaconBlockHeader, header_from_block

        header = SignedBeaconBlockHeader(
            message=header_from_block(signed_block.message),
            signature=bytes(signed_block.signature),
        )
        self.blocks_seen += 1
        self.slasher.accept_block_header(header)

    # -- the per-slot batch (service/src/lib.rs update loop) ----------------

    def update(self) -> tuple[list, list]:
        """Drain + detect; pool and broadcast anything found. Returns the
        new (attester_slashings, proposer_slashings)."""
        new_att, new_prop = self.slasher.process_queued()
        for s in new_att:
            self.attester_slashings_found += 1
            self.op_pool.insert_attester_slashing(s)
            if self.fork_choice is not None:
                self.fork_choice.on_attester_slashing(s)
            if self.broadcast is not None:
                self.broadcast("attester_slashing", s)
        for s in new_prop:
            self.proposer_slashings_found += 1
            self.op_pool.insert_proposer_slashing(s)
            if self.broadcast is not None:
                self.broadcast("proposer_slashing", s)
        return new_att, new_prop

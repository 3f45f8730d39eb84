"""Block verification typestate pipeline (reference beacon_chain/src/
block_verification.rs:588-619): a block ascends through

    GossipVerifiedBlock        gossip checks + proposer signature ONLY
    SignatureVerifiedBlock     every remaining signature, ONE batch call
    (execution/import)         state transition + fork choice via
                               BeaconChain.process_block(NO_VERIFICATION)

so gossip re-publication happens after the cheap stage, the expensive
batch runs once, and the transition never re-verifies. Plus
`signature_verify_chain_segment` (block_verification.rs:525): a whole
sync segment's signatures in ONE backend call.

The port's copy of lighthouse_tpu/chain/block_verification.py."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.bls.api import verify_signature_sets
from ..state_transition import (
    BlockProcessingError,
    BlockSignatureStrategy,
    BlockSignatureVerifier,
    clone_state,
    process_slots,
)
from ..state_transition.per_slot import get_beacon_proposer_index
from ..state_transition.signature_sets import (
    block_proposal_signature_set,
)
from .beacon_chain import BeaconChain, BlockError


class UnknownParent(BlockError):
    """Parent not known locally: the caller should trigger a block lookup
    (block_lookups/) rather than penalize the peer."""

    def __init__(self, parent_root: bytes):
        super().__init__(f"unknown parent {bytes(parent_root).hex()[:12]}")
        self.parent_root = bytes(parent_root)


class BlockAlreadyKnown(BlockError):
    """Benign duplicate (the reference's BlockIsAlreadyKnown): gossip and
    sync overlap constantly, so callers must NOT penalize the sender."""

    def __init__(self, block_root: bytes):
        super().__init__(f"block already known {bytes(block_root).hex()[:12]}")
        self.block_root = bytes(block_root)


class BlockEquivocation(BlockError):
    """A signature-valid SECOND distinct block from a (slot, proposer)
    already observed with a verified block: spec gossip validation
    IGNOREs it (no penalty — the relayer may be honest relaying a real
    equivocation), it must not import via gossip, and the caller should
    hand the header to the slasher."""

    def __init__(self, block_root: bytes):
        super().__init__(
            f"proposer equivocation {bytes(block_root).hex()[:12]}"
        )
        self.block_root = bytes(block_root)


@dataclass
class GossipVerifiedBlock:
    signed_block: object
    block_root: bytes
    # the state advanced to the block's slot, reused by the next stage
    pre_state: object

    @classmethod
    def verify(cls, chain: BeaconChain, signed_block) -> "GossipVerifiedBlock":
        """block_verification.rs:588 GossipVerifiedBlock::new: slot/parent/
        proposer checks and the proposer signature alone."""
        block = signed_block.message
        block_root = block.tree_hash_root()
        if block_root in chain._states:
            raise BlockAlreadyKnown(block_root)
        if block.slot > chain.current_slot:
            raise BlockError("block from the future")
        fin_epoch, _ = chain.finalized_checkpoint
        if block.slot <= fin_epoch * chain.preset.slots_per_epoch:
            raise BlockError("block below finalization")
        parent_root = bytes(block.parent_root)
        parent_state = chain._states.get(parent_root)
        if parent_state is None:
            raise UnknownParent(parent_root)
        state = clone_state(parent_state)
        try:
            state = process_slots(state, block.slot, chain.preset, chain.spec)
        except BlockProcessingError as e:
            raise BlockError(str(e)) from None
        expected = get_beacon_proposer_index(state, chain.preset, chain.spec)
        if block.proposer_index != expected:
            raise BlockError(
                f"wrong proposer {block.proposer_index}, expected {expected}"
            )
        from ..utils import metrics as M

        try:
            sig_set = block_proposal_signature_set(
                state,
                chain.pubkey_cache.getter(state),
                signed_block,
                chain.preset,
                chain.spec,
            )
            with M.BLOCK_SIGNATURE_TIMES.time():
                ok = verify_signature_sets([sig_set])
        except ValueError:  # undecodable signature/pubkey bytes
            ok = False
        if not ok:
            raise BlockError("invalid proposer signature")
        return cls(signed_block, block_root, state)


@dataclass
class SignatureVerifiedBlock:
    signed_block: object
    block_root: bytes
    # gossip path carries the already-advanced pre-state so the import
    # stage doesn't redo clone + process_slots; segment path leaves None
    pre_state: object = None

    @classmethod
    def from_gossip_verified(
        cls, chain: BeaconChain, gossip_verified: GossipVerifiedBlock
    ) -> "SignatureVerifiedBlock":
        """block_verification.rs:597: every signature EXCEPT the proposal
        (already checked) in one batch."""
        from ..utils import metrics as M

        state = gossip_verified.pre_state
        verifier = BlockSignatureVerifier(
            state,
            chain.preset,
            chain.spec,
            get_pubkey=chain.pubkey_cache.getter(state),
            resolve_pubkey=chain.pubkey_cache.resolve,
        )
        try:
            verifier.include_all_signatures_except_block_proposal(
                gossip_verified.signed_block
            )
            with M.BLOCK_SIGNATURE_TIMES.time():
                ok = verifier.verify()
        except ValueError:  # undecodable signature/pubkey bytes
            ok = False
        if not ok:
            raise BlockError("invalid block signatures")
        return cls(
            gossip_verified.signed_block,
            gossip_verified.block_root,
            gossip_verified.pre_state,
        )

    def import_into(self, chain: BeaconChain) -> bytes:
        """ExecutionPendingBlock seat: transition (payload round trip runs
        inside), store, fork choice — signatures are already done."""
        return chain.process_block(
            self.signed_block,
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            pre_state=self.pre_state,
        )


def process_gossip_block(
    chain: BeaconChain, signed_block, observed_producers=None
) -> bytes:
    """The full gossip pipeline in order (gossip_methods.rs:656 -> 927).

    `observed_producers` (an ObservedBlockProducers) is consulted AFTER
    every signature verifies — recording only verified blocks, exactly
    like the reference — and a signature-valid second distinct block
    from the same (slot, proposer) raises BlockEquivocation instead of
    importing."""
    from ..utils import metrics as M
    from ..utils import tracing

    with tracing.span(
        "gossip_block", slot=int(signed_block.message.slot)
    ):
        with tracing.span("block_gossip_verify"):
            gv = GossipVerifiedBlock.verify(chain, signed_block)
        with tracing.span("block_signature_verify"):
            sv = SignatureVerifiedBlock.from_gossip_verified(chain, gv)
        if observed_producers is not None:
            block = signed_block.message
            verdict = observed_producers.observe(
                block.slot, block.proposer_index, sv.block_root
            )
            if verdict == "equivocation":
                raise BlockEquivocation(sv.block_root)
        # every signature checked: the reference's beacon_block_delay_
        # gossip_verification milestone (slot clock, replayable)
        M.observe_slot_delay(
            M.BLOCK_VERIFIED_DELAY,
            chain.slot_clock,
            int(signed_block.message.slot),
        )
        return sv.import_into(chain)


def signature_verify_chain_segment(chain: BeaconChain, blocks) -> list:
    """Batch-verify the signatures of a parent-linked segment in ONE
    backend call (block_verification.rs:525
    signature_verify_chain_segment), returning SignatureVerifiedBlocks
    ready to import in order. Raises BlockError if the segment doesn't
    link or any signature fails."""
    if not blocks:
        return []
    first = blocks[0].message
    parent_state = chain._states.get(bytes(first.parent_root))
    if parent_state is None:
        raise UnknownParent(bytes(first.parent_root))
    state = clone_state(parent_state)
    verifier = None
    out = []
    prev_root = bytes(first.parent_root)
    for signed in blocks:
        block = signed.message
        if bytes(block.parent_root) != prev_root:
            raise BlockError("segment does not hash-chain")
        try:
            state = process_slots(state, block.slot, chain.preset, chain.spec)
        except BlockProcessingError as e:
            raise BlockError(str(e)) from None
        if verifier is None:
            # one verifier accumulates every block's sets; committee
            # caches come from the advancing state
            verifier = BlockSignatureVerifier(
                state,
                chain.preset,
                chain.spec,
                get_pubkey=chain.pubkey_cache.getter(state),
                resolve_pubkey=chain.pubkey_cache.resolve,
            )
        else:
            verifier.state = state
            verifier.get_pubkey = chain.pubkey_cache.getter(state)
        try:
            verifier.include_all_signatures(signed)
        except ValueError:
            raise BlockError("undecodable signature in segment") from None
        prev_root = block.tree_hash_root()
        # snapshot the advanced pre-state so import skips its own clone +
        # process_slots (same reuse as the gossip pipeline's pre_state)
        out.append(SignatureVerifiedBlock(signed, prev_root, clone_state(state)))
        # apply the block so the NEXT block's committees/proposer derive
        # from the right state (NO_VERIFICATION: sets already collected)
        from ..state_transition import per_block_processing

        try:
            per_block_processing(
                state,
                signed,
                chain.preset,
                chain.spec,
                strategy=BlockSignatureStrategy.NO_VERIFICATION,
                verified_proposer_index=block.proposer_index,
            )
        except BlockProcessingError as e:
            raise BlockError(str(e)) from None
    from ..utils import metrics as M

    with M.BLOCK_SIGNATURE_TIMES.time():
        batch_ok = verifier.verify()
    if not batch_ok:
        raise BlockError("segment signature batch failed")
    return out

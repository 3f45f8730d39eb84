"""Spec fork choice over the proto array (reference consensus/fork_choice/
src/fork_choice.rs: on_block:747, on_attestation:1162, get_head:527).

Keeps the store checkpoints, queues current-slot attestations until the
next slot (spec: attestations can only influence fork choice from the
following slot), and applies proposer boost.

The port's copy of lighthouse_tpu/fork_choice/fork_choice.py.
"""

from __future__ import annotations

from ..types import compute_epoch_at_slot, compute_start_slot_at_epoch
from ..types.helpers import is_active_validator
from ..types.presets import Preset
from .proto_array import ProtoArrayForkChoice, ProtoArrayError


class ForkChoiceError(ValueError):
    pass


# spec INTERVALS_PER_SLOT: the first third of the slot is "timely"
_INTERVALS_PER_SLOT = 3


def _justified_balances(state, preset, epoch: int | None = None) -> list[int]:
    """Spec fork-choice weights: EFFECTIVE balances of validators active at
    the given epoch (default: the state's epoch); everyone else weighs zero
    (exited/slashed stakes must not keep moving the head)."""
    if epoch is None:
        epoch = compute_epoch_at_slot(state.slot, preset)
    return [
        v.effective_balance if is_active_validator(v, epoch) else 0
        for v in state.validators
    ]


class ForkChoice:
    def __init__(
        self,
        preset: Preset,
        spec,
        genesis_slot: int,
        genesis_root: bytes,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        state_lookup=None,
    ):
        self.preset = preset
        self.spec = spec
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        # unrealized store checkpoints (fork_choice.rs unrealized_justified/
        # finalized_checkpoint): the best justification any imported state
        # COULD realize at its next epoch boundary; pulled into the
        # realized checkpoints at the boundary tick
        self.unrealized_justified_checkpoint = justified_checkpoint
        self.unrealized_finalized_checkpoint = finalized_checkpoint
        self.justified_balances: list[int] = []
        # root -> post-state resolver for the justified checkpoint's state
        # (reference: JustifiedBalances built from the justified state,
        # fork_choice.rs / proto_array). Without it, on_block falls back to
        # the importing block's post-state -- a spec divergence in
        # contested forks.
        self.state_lookup = state_lookup
        self.current_slot = genesis_slot
        # intra-slot seconds (spec INTERVALS_PER_SLOT timeliness); slot
        # ticks reset it to 0, on_tick_time sets the real offset
        self.seconds_into_slot = 0
        self.queued_attestations: list[tuple[int, int, bytes, int]] = []
        self.proto = ProtoArrayForkChoice(
            genesis_slot,
            genesis_root,
            justified_checkpoint,
            finalized_checkpoint,
            slots_per_epoch=preset.slots_per_epoch,
        )

    # -- time (fork_choice.rs on_tick) --------------------------------------

    def on_tick(self, slot: int) -> None:
        while self.current_slot < slot:
            self.current_slot += 1
            self._dequeue_attestations()
            # proposer boost expires at the start of the next slot
            self.proto.proposer_boost_root = None
            # a plain slot tick lands at the slot start: timely until told
            # otherwise by on_tick_time
            self.seconds_into_slot = 0
            # epoch-boundary pull-up (fork_choice.rs on_tick): what was
            # unrealized last epoch is realized now, even if no block has
            # imported since -- the late-epoch justification race
            if self.current_slot % self.preset.slots_per_epoch == 0:
                self._realize_unrealized()

    def on_tick_time(self, time_s: int, genesis_time: int) -> None:
        """Second-granular tick (spec on_tick): advances the slot AND
        records the intra-slot offset, which gates proposer-boost
        timeliness (a block arriving past SECONDS_PER_SLOT /
        INTERVALS_PER_SLOT into its slot gets no boost)."""
        slot = (time_s - genesis_time) // self.spec.seconds_per_slot
        self.on_tick(slot)
        self.seconds_into_slot = (time_s - genesis_time) % (
            self.spec.seconds_per_slot
        )

    def _realize_unrealized(self) -> None:
        if (
            self.unrealized_justified_checkpoint[0]
            > self.justified_checkpoint[0]
        ):
            self.justified_checkpoint = self.unrealized_justified_checkpoint
            state = (
                self.state_lookup(self.justified_checkpoint[1])
                if self.state_lookup
                else None
            )
            if state is not None:
                self.justified_balances = _justified_balances(
                    state, self.preset, self.justified_checkpoint[0]
                )
        if (
            self.unrealized_finalized_checkpoint[0]
            > self.finalized_checkpoint[0]
        ):
            self.finalized_checkpoint = self.unrealized_finalized_checkpoint

    def _dequeue_attestations(self) -> None:
        remaining = []
        for att_slot, validator, root, epoch in self.queued_attestations:
            if att_slot + 1 <= self.current_slot:
                self.proto.process_attestation(validator, root, epoch)
            else:
                remaining.append((att_slot, validator, root, epoch))
        self.queued_attestations = remaining

    # -- blocks (fork_choice.rs:747 on_block) -------------------------------

    def on_block(
        self,
        signed_block,
        block_root: bytes,
        state,
        execution_status: str = "irrelevant",
        execution_block_hash: bytes = b"",
    ) -> None:
        """`state` is the post-state of the block. Realized checkpoints
        feed the store; the UNREALIZED pair (what the state would justify
        at its next boundary) feeds the store's unrealized checkpoints and
        -- for blocks from prior epochs -- the node itself
        (fork_choice.rs:747 on_block + compute_unrealized_checkpoints).
        `execution_status` carries the engine verdict for optimistic-sync
        tracking."""
        from ..state_transition.per_epoch import compute_unrealized_checkpoints
        from ..types import compute_epoch_at_slot as _epoch_at

        block = signed_block.message
        if block.slot > self.current_slot:
            raise ForkChoiceError("block from the future")
        # spec on_block: the block must descend from the finalized
        # checkpoint (fork_choice.rs is_finalized_checkpoint_or_descendant)
        fin_epoch, fin_root = self.finalized_checkpoint
        parent_root = bytes(block.parent_root)
        if (
            fin_root in self.proto.proto_array.indices
            and parent_root in self.proto.proto_array.indices
        ):
            parent_idx = self.proto.proto_array.indices[parent_root]
            parent_node = self.proto.proto_array.nodes[parent_idx]
            if not self.proto.proto_array._descends_from(
                parent_node, fin_root
            ):
                raise ForkChoiceError(
                    "block does not descend from the finalized checkpoint"
                )
        jc = (
            state.current_justified_checkpoint.epoch,
            bytes(state.current_justified_checkpoint.root),
        )
        fc = (
            state.finalized_checkpoint.epoch,
            bytes(state.finalized_checkpoint.root),
        )
        ujc, ufc = compute_unrealized_checkpoints(state, self.preset, self.spec)
        if ujc[0] > self.unrealized_justified_checkpoint[0]:
            self.unrealized_justified_checkpoint = ujc
        if ufc[0] > self.unrealized_finalized_checkpoint[0]:
            self.unrealized_finalized_checkpoint = ufc

        block_epoch = _epoch_at(block.slot, self.preset)
        current_epoch = _epoch_at(self.current_slot, self.preset)
        node_jc, node_fc = jc, fc
        if block_epoch < current_epoch:
            # a prior-epoch block: from our perspective its epoch boundary
            # has passed, so its unrealized checkpoints are realized
            node_jc, node_fc = ujc, ufc

        if node_jc[0] > self.justified_checkpoint[0]:
            self.justified_checkpoint = node_jc
            self.justified_balances = self._balances_for_checkpoint(
                node_jc, state
            )
        if node_fc[0] > self.finalized_checkpoint[0]:
            self.finalized_checkpoint = node_fc
        self.proto.process_block(
            block.slot,
            block_root,
            bytes(block.parent_root),
            node_jc,
            node_fc,
            execution_status,
            execution_block_hash,
            unrealized_justified_checkpoint=ujc,
        )
        # proposer boost: only the FIRST timely block of the slot gets it
        # (spec: set only when proposer_boost_root is empty AND the block
        # arrived within SECONDS_PER_SLOT / INTERVALS_PER_SLOT)
        timely = self.seconds_into_slot * _INTERVALS_PER_SLOT < (
            self.spec.seconds_per_slot
        )
        if (
            block.slot == self.current_slot
            and timely
            and self.proto.proposer_boost_root is None
        ):
            self.proto.proposer_boost_root = block_root
        if not self.justified_balances:
            self.justified_balances = self._balances_for_checkpoint(
                self.justified_checkpoint, state
            )

    def _balances_for_checkpoint(self, checkpoint, fallback_state):
        """Weights from the JUSTIFIED checkpoint's state (reference keeps
        JustifiedBalances from the justified state, fork_choice.rs), active
        at the checkpoint epoch. Falls back to the importing block's
        post-state only when the checkpoint state is unavailable."""
        epoch, root = checkpoint
        state = self.state_lookup(root) if self.state_lookup else None
        if state is None:
            state = fallback_state
        return _justified_balances(state, self.preset, epoch)

    def on_valid_execution_payload(self, root: bytes) -> None:
        self.proto.on_valid_execution_payload(root)

    def on_invalid_execution_payload(
        self, root: bytes, latest_valid_hash: bytes | None = None
    ) -> None:
        self.proto.on_invalid_execution_payload(root, latest_valid_hash)

    def is_optimistic(self, root: bytes) -> bool:
        return self.proto.is_optimistic(root)

    # -- attestations (fork_choice.rs:1162 on_attestation) ------------------

    def on_attestation(
        self,
        attestation_slot: int,
        attesting_indices,
        block_root: bytes,
        from_block: bool = False,
    ) -> None:
        epoch = compute_epoch_at_slot(attestation_slot, self.preset)
        if not from_block:
            # spec validate_on_attestation (gossip path only; attestations
            # carried in blocks are exempt from the recency asserts)
            if attestation_slot > self.current_slot:
                raise ForkChoiceError("attestation from a future slot")
            current_epoch = compute_epoch_at_slot(
                self.current_slot, self.preset
            )
            if epoch < max(current_epoch, 1) - 1:
                raise ForkChoiceError("attestation epoch too old")
        for v in attesting_indices:
            if attestation_slot + 1 <= self.current_slot:
                self.proto.process_attestation(v, bytes(block_root), epoch)
            else:
                self.queued_attestations.append(
                    (attestation_slot, v, bytes(block_root), epoch)
                )

    def on_attester_slashing(self, attester_slashing) -> None:
        """Spec on_attester_slashing (fork_choice.rs on_attester_slashing):
        validators attesting in BOTH of the slashing's attestations
        equivocated; their fork-choice weight is removed permanently.
        Takes the (already-validated) AttesterSlashing operation so every
        call site shares one intersection computation."""
        common = set(
            attester_slashing.attestation_1.attesting_indices
        ) & set(attester_slashing.attestation_2.attesting_indices)
        for v in common:
            self.proto.process_attester_slashing(int(v))

    # -- head (fork_choice.rs:527 get_head) ---------------------------------

    def get_head(self) -> bytes:
        boost = 0
        if self.proto.proposer_boost_root is not None:
            total = sum(self.justified_balances)
            committee_weight = total // self.preset.slots_per_epoch
            boost = committee_weight * self.spec.proposer_score_boost // 100
        try:
            return self.proto.find_head(
                self.justified_checkpoint,
                self.finalized_checkpoint,
                self.justified_balances,
                boost,
                current_epoch=compute_epoch_at_slot(
                    self.current_slot, self.preset
                ),
            )
        except ProtoArrayError as e:
            raise ForkChoiceError(str(e)) from None

"""Block replayer: apply a range of blocks to a state with configurable
signature strategy and per-slot/-block hooks (reference
consensus/state_processing/src/block_replayer.rs -- used by historical
state reconstruction and the database's block-range replay).

The port's copy of lighthouse_tpu/state_transition/replay.py."""

from __future__ import annotations

from ..types.presets import Preset
from .per_block import BlockSignatureStrategy, per_block_processing
from .per_slot import clone_state, process_slots


class BlockReplayer:
    def __init__(
        self,
        state,
        preset: Preset,
        spec,
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.NO_VERIFICATION,
        state_root_provider=None,
        pre_block_hook=None,
        pre_slot_hook=None,
    ):
        self.state = clone_state(state)
        self.preset = preset
        self.spec = spec
        self.strategy = strategy
        self.state_root_provider = state_root_provider
        self.pre_block_hook = pre_block_hook
        self.pre_slot_hook = pre_slot_hook

    def apply_blocks(self, blocks, target_slot: int | None = None):
        for signed_block in blocks:
            block = signed_block.message
            if self.pre_slot_hook:
                self.pre_slot_hook(self.state)
            self.state = process_slots(
                self.state, block.slot, self.preset, self.spec
            )
            if self.pre_block_hook:
                self.pre_block_hook(self.state, signed_block)
            per_block_processing(
                self.state,
                signed_block,
                self.preset,
                self.spec,
                strategy=self.strategy,
            )
        if target_slot is not None and target_slot > self.state.slot:
            self.state = process_slots(
                self.state, target_slot, self.preset, self.spec
            )
        return self

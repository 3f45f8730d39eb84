"""BeaconChainHarness: the full in-process chain test rig (reference
beacon_chain/src/test_utils.rs:520 BeaconChainHarness over
EphemeralHarnessType = MemoryStore + TestingSlotClock + interop keys).
Supports forks: blocks can be produced on any known parent.

`device` is the chain's (its pubkey table and so every block verify):
None is the card, "cpu" only when the caller asks for it.

The port's copy of lighthouse_tpu/harness/beacon_chain_harness.py.
"""

from __future__ import annotations

from ..chain.beacon_chain import BeaconChain
from ..state_transition import BlockSignatureStrategy, clone_state, process_slots
from ..store.hot_cold import HotColdDB
from ..store.kv import MemoryStore
from ..types import ChainSpec
from ..types.presets import Preset
from .chain import StateHarness


class BeaconChainHarness:
    def __init__(
        self,
        validator_count: int,
        preset: Preset,
        spec: ChainSpec | None = None,
        sign: bool = False,
        kv=None,
        execution_layer=None,
        device=None,
    ):
        self.producer = StateHarness(
            validator_count, preset, spec, sign=sign,
            execution_layer=execution_layer,
        )
        self.preset = preset
        self.spec = self.producer.spec
        self.store = HotColdDB(
            kv if kv is not None else MemoryStore(), preset, self.spec
        )
        self.chain = BeaconChain(
            self.store, self.producer.state, preset, self.spec, device=device
        )
        self.chain.execution_layer = execution_layer
        self.strategy = (
            BlockSignatureStrategy.VERIFY_BULK
            if sign
            else BlockSignatureStrategy.NO_VERIFICATION
        )

    def add_block_at_slot(
        self, slot: int, parent_root: bytes | None = None, attest: bool = True
    ) -> bytes:
        """Produce + import a block at `slot` on `parent_root` (default:
        current head), with full-participation attestations for `slot - 1`
        on that parent chain."""
        parent_root = parent_root or self.chain.head_root
        parent_state = self.chain._states[parent_root]
        atts = []
        if attest and slot > 1:
            adv = process_slots(
                clone_state(parent_state), slot, self.preset, self.spec
            )
            atts = self.producer.attestations_for_slot(adv, slot - 1)
        signed, _ = self.producer.produce_block(
            slot, atts, base_state=parent_state
        )
        self.chain.slot_clock.set_slot(slot)
        return self.chain.process_block(signed, strategy=self.strategy)

    def extend_chain(self, num_slots: int, attest: bool = True) -> bytes:
        root = self.chain.head_root
        for _ in range(num_slots):
            slot = self.chain._states[self.chain.head_root].slot + 1
            root = self.add_block_at_slot(slot, attest=attest)
        return root

    def finalized_epoch(self) -> int:
        return self.chain.finalized_checkpoint[0]

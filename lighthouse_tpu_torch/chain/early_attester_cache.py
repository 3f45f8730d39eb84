"""Early-attester cache: attest to a just-imported block without
touching the head state (reference beacon_node/beacon_chain/src/
early_attester_cache.rs).

When a block imports, everything an attester needs for that slot --
beacon_block_root, source, target -- is precomputed from the block's
own post-state and held as one slot-keyed item. Attestation production
consults the cache first; only on a miss (older-slot requests, skipped
slots) does it derive data from the head state. This keeps the
hot per-slot attestation path free of state clones and protects the
first third of the slot from head-lock contention, which is the
reference's motivation (early_attester_cache.rs:1-18).

The port's copy of lighthouse_tpu/chain/early_attester_cache.py.
"""

from __future__ import annotations

from ..types import compute_epoch_at_slot, compute_start_slot_at_epoch
from ..types.containers import AttestationData, Checkpoint
from ..types.helpers import get_block_root_at_slot


class EarlyAttesterCache:
    def __init__(self):
        self._item = None
        self.stats = {"hits": 0, "misses": 0}

    def add(self, preset, block_root: bytes, block, state) -> None:
        """Record the freshly imported block (post-state in hand).
        Target: the epoch boundary root as seen from the block's own
        chain -- the block itself when it starts the epoch."""
        epoch = compute_epoch_at_slot(block.slot, preset)
        target_slot = compute_start_slot_at_epoch(epoch, preset)
        target_root = (
            get_block_root_at_slot(state, target_slot, preset)
            if target_slot < block.slot
            else bytes(block_root)
        )
        self._item = {
            "epoch": epoch,
            "slot": int(block.slot),
            "block_root": bytes(block_root),
            "source": Checkpoint(
                epoch=state.current_justified_checkpoint.epoch,
                root=bytes(state.current_justified_checkpoint.root),
            ),
            "target": Checkpoint(epoch=epoch, root=target_root),
        }

    def try_attest(self, slot: int, index: int, preset):
        """AttestationData iff the cached block IS the block of `slot`
        (the early case: attesting to the block that just arrived for
        this very slot); None otherwise."""
        item = self._item
        if (
            item is None
            or item["slot"] != slot
            or compute_epoch_at_slot(slot, preset) != item["epoch"]
        ):
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return AttestationData(
            slot=slot,
            index=index,
            beacon_block_root=item["block_root"],
            source=item["source"],
            target=item["target"],
        )

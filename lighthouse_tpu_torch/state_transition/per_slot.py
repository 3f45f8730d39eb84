"""Per-slot state advancement (reference consensus/state_processing/src/
per_slot_processing.rs:25): cache roots, bump the slot, and run epoch
processing at boundaries. Also proposer selection and state cloning.

The port's copy of lighthouse_tpu/state_transition/per_slot.py."""

from __future__ import annotations

from ..types import (
    compute_epoch_at_slot,
    compute_proposer_index,
    get_active_validator_indices,
    get_seed,
)
from ..types.chain_spec import DOMAIN_BEACON_PROPOSER
from ..types.helpers import hash32
from ..types.presets import Preset
from .context import BlockProcessingError


def clone_state(state):
    """Deep copy via SSZ round trip -- guarantees no aliasing between the
    copies (the reference gets this from Rust Clone; BeaconState ssz
    encode/decode round trips are its benchmark workload,
    consensus/types/benches/benches.rs:49-176)."""
    cls = type(state)
    return cls.from_ssz_bytes(state.as_ssz_bytes())


def get_beacon_proposer_index(state, preset: Preset, spec) -> int:
    epoch = compute_epoch_at_slot(state.slot, preset)
    seed = hash32(
        get_seed(state, epoch, DOMAIN_BEACON_PROPOSER, preset, spec)
        + state.slot.to_bytes(8, "little")
    )
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(state, indices, seed, spec)


def process_slot(state, preset: Preset):
    """Cache state/block roots into the ring buffers (spec process_slot).

    The state root goes through the incremental tree-hash cache
    (ssz/cached.py, reference consensus/cached_tree_hash): slot-to-slot the
    state differs in a handful of fields, so the cached path re-hashes only
    dirty merkle paths instead of the whole ~100k-validator tree."""
    from ..ssz import cached_root

    previous_state_root = cached_root(state)
    roots = list(state.state_roots)
    roots[state.slot % preset.slots_per_historical_root] = previous_state_root
    state.state_roots = tuple(roots)

    if bytes(state.latest_block_header.state_root) == bytes(32):
        state.latest_block_header.state_root = previous_state_root

    block_root = state.latest_block_header.tree_hash_root()
    roots = list(state.block_roots)
    roots[state.slot % preset.slots_per_historical_root] = block_root
    state.block_roots = tuple(roots)


def process_slots(state, target_slot: int, preset: Preset, spec):
    """Advance `state` to `target_slot`, running epoch transitions at
    boundaries (spec process_slots; reference per_slot_processing)."""
    if target_slot < state.slot:
        raise BlockProcessingError(
            f"cannot rewind state from {state.slot} to {target_slot}"
        )
    from .per_epoch import process_epoch
    from .upgrades import upgrade_state_if_due

    while state.slot < target_slot:
        process_slot(state, preset)
        if (state.slot + 1) % preset.slots_per_epoch == 0:
            process_epoch(state, preset, spec)
        state.slot += 1
        state = upgrade_state_if_due(state, preset, spec)
    return state

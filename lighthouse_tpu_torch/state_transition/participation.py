"""Altair participation flags, weights, and base rewards (spec constants;
reference consensus/types/src/participation_flags.rs and
state_processing altair helpers).

The port's copy of lighthouse_tpu/state_transition/participation.py."""

from __future__ import annotations

from ..types import compute_epoch_at_slot
from ..types.helpers import (
    get_block_root,
    get_block_root_at_slot,
    get_total_active_balance,
)
from ..types.presets import Preset
from ..utils.math import integer_squareroot

TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64

PARTICIPATION_FLAG_WEIGHTS = [
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
]


def has_flag(flags: int, flag_index: int) -> bool:
    return bool(flags & (1 << flag_index))


def add_flag(flags: int, flag_index: int) -> int:
    return flags | (1 << flag_index)


def get_attestation_participation_flag_indices(
    state, data, inclusion_delay: int, preset: Preset, spec
) -> list[int]:
    """Which timeliness flags an attestation earns (spec
    get_attestation_participation_flag_indices)."""
    justified = (
        state.current_justified_checkpoint
        if data.target.epoch == compute_epoch_at_slot(state.slot, preset)
        else state.previous_justified_checkpoint
    )
    is_matching_source = data.source == justified
    if not is_matching_source:
        raise ValueError("attestation source does not match justified")
    is_matching_target = is_matching_source and bytes(
        data.target.root
    ) == bytes(get_block_root(state, data.target.epoch, preset))
    is_matching_head = is_matching_target and bytes(
        data.beacon_block_root
    ) == bytes(get_block_root_at_slot(state, data.slot, preset))

    flags = []
    if is_matching_source and inclusion_delay <= integer_squareroot(
        preset.slots_per_epoch
    ):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= preset.slots_per_epoch:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == spec.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def get_base_reward_per_increment(state, preset: Preset, spec) -> int:
    return (
        spec.effective_balance_increment
        * spec.base_reward_factor
        // integer_squareroot(get_total_active_balance(state, preset, spec))
    )


def get_base_reward_altair(
    state, index: int, base_reward_per_increment: int, preset: Preset, spec
) -> int:
    increments = (
        state.validators[index].effective_balance
        // spec.effective_balance_increment
    )
    return increments * base_reward_per_increment

"""Spec accessor/helper functions over BeaconState (the reference spreads
these across consensus/types/src/beacon_state.rs and
consensus/state_processing: epoch math, domains, seeds, committee and
proposer selection). Pure functions of (state, preset, spec) -- caching
layers (committee cache etc.) wrap these, they don't replace them."""

from __future__ import annotations

import hashlib

from ..utils.shuffle import compute_shuffled_index, shuffle_indices
from .chain_spec import (
    DOMAIN_BEACON_PROPOSER,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    ChainSpec,
)
from .containers import ForkData, SigningData
from .presets import Preset


def hash32(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# --- epoch / slot math ------------------------------------------------------


def compute_epoch_at_slot(slot: int, preset: Preset) -> int:
    return slot // preset.slots_per_epoch

def compute_start_slot_at_epoch(epoch: int, preset: Preset) -> int:
    return epoch * preset.slots_per_epoch


def compute_activation_exit_epoch(epoch: int, spec: ChainSpec) -> int:
    return epoch + 1 + spec.max_seed_lookahead


# --- fork data / domains / signing roots -----------------------------------


def compute_fork_data_root(
    current_version: bytes, genesis_validators_root: bytes
) -> bytes:
    return ForkData(
        current_version=current_version,
        genesis_validators_root=genesis_validators_root,
    ).tree_hash_root()


def compute_fork_digest(
    current_version: bytes, genesis_validators_root: bytes
) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes,
    fork_version: bytes,
    genesis_validators_root: bytes,
) -> bytes:
    root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + root[:28]


def get_domain(
    state, domain_type: bytes, epoch: int | None, preset: Preset
) -> bytes:
    epoch = (
        compute_epoch_at_slot(state.slot, preset) if epoch is None else epoch
    )
    fork_version = (
        state.fork.previous_version
        if epoch < state.fork.epoch
        else state.fork.current_version
    )
    return compute_domain(
        domain_type, fork_version, state.genesis_validators_root
    )


def compute_signing_root(obj, domain: bytes) -> bytes:
    return SigningData(
        object_root=obj.tree_hash_root(), domain=domain
    ).tree_hash_root()


def validators_registry_root(state) -> bytes:
    """Registry root with the same list limit the state's field uses
    (genesis_validators_root computation at genesis)."""
    field_type = dict(state.ssz_fields)["validators"]
    return field_type.hash_tree_root(state.validators)


# --- block root lookups -----------------------------------------------------


def get_block_root_at_slot(state, slot: int, preset: Preset) -> bytes:
    if not slot < state.slot <= slot + preset.slots_per_historical_root:
        raise ValueError(f"slot {slot} out of block_roots range")
    return state.block_roots[slot % preset.slots_per_historical_root]


def get_block_root(state, epoch: int, preset: Preset) -> bytes:
    return get_block_root_at_slot(
        state, compute_start_slot_at_epoch(epoch, preset), preset
    )


# --- validator predicates ---------------------------------------------------


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and (
        v.activation_epoch <= epoch < v.withdrawable_epoch
    )


def get_active_validator_indices(state, epoch: int) -> list[int]:
    return [
        i
        for i, v in enumerate(state.validators)
        if is_active_validator(v, epoch)
    ]


# --- randao / seeds ---------------------------------------------------------


def get_randao_mix(state, epoch: int, preset: Preset) -> bytes:
    return state.randao_mixes[epoch % preset.epochs_per_historical_vector]


def get_seed(
    state, epoch: int, domain_type: bytes, preset: Preset, spec: ChainSpec
) -> bytes:
    mix = get_randao_mix(
        state,
        epoch
        + preset.epochs_per_historical_vector
        - spec.min_seed_lookahead
        - 1,
        preset,
    )
    return hash32(domain_type + epoch.to_bytes(8, "little") + mix)


# --- committees -------------------------------------------------------------


def get_committee_count_per_slot(
    active_count: int, preset: Preset, spec: ChainSpec
) -> int:
    return max(
        1,
        min(
            preset.max_committees_per_slot,
            active_count
            // preset.slots_per_epoch
            // preset.target_committee_size,
        ),
    )


def compute_committee(
    indices: list[int],
    seed: bytes,
    index: int,
    count: int,
    perm=None,
    rounds: int | None = None,
):
    """Slice `index` of `count` of the shuffled active set. `perm` may carry
    the precomputed full shuffle (committee-cache path)."""
    n = len(indices)
    start = n * index // count
    end = n * (index + 1) // count
    if perm is None:
        if rounds is None:
            # no silent 90-round default: the round count is a config
            # value (spec.shuffle_round_count) and must come from the
            # caller, as every production path does
            raise ValueError("compute_committee without perm needs rounds")
        return [
            indices[compute_shuffled_index(i, n, seed, rounds)]
            for i in range(start, end)
        ]
    return [indices[perm[i]] for i in range(start, end)]


# --- proposer selection -----------------------------------------------------

MAX_RANDOM_BYTE = 2**8 - 1


def compute_proposer_index(
    state, indices: list[int], seed: bytes, spec: ChainSpec
) -> int:
    """Effective-balance-weighted selection (spec compute_proposer_index)."""
    if not indices:
        raise ValueError("no active validators")
    i = 0
    total = len(indices)
    while True:
        shuffled = compute_shuffled_index(
            i % total, total, seed, spec.shuffle_round_count
        )
        candidate = indices[shuffled]
        rand = hash32(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= spec.max_effective_balance * rand:
            return candidate
        i += 1


# --- balances ---------------------------------------------------------------


def get_total_balance(state, indices, spec: ChainSpec) -> int:
    return max(
        spec.effective_balance_increment,
        sum(state.validators[i].effective_balance for i in indices),
    )


def get_total_active_balance(state, preset: Preset, spec: ChainSpec) -> int:
    epoch = compute_epoch_at_slot(state.slot, preset)
    return get_total_balance(
        state, get_active_validator_indices(state, epoch), spec
    )


def increase_balance(state, index: int, delta: int) -> None:
    """One-off balance bump (deposits, slashing rewards). Bulk updates
    (epoch rewards, sync-aggregate) use apply_balance_deltas instead --
    this copies the registry-length tuple per call."""
    bal = list(state.balances)
    bal[index] += delta
    state.balances = tuple(bal)


def decrease_balance(state, index: int, delta: int) -> None:
    bal = list(state.balances)
    bal[index] = 0 if delta > bal[index] else bal[index] - delta
    state.balances = tuple(bal)


def apply_balance_deltas(state, rewards, penalties) -> None:
    """Batched per-validator increase-then-clamped-decrease in ONE pass
    (the spec applies increase_balance then decrease_balance per index)."""
    bal = list(state.balances)
    for i in range(len(bal)):
        b = bal[i] + rewards[i]
        p = penalties[i]
        bal[i] = 0 if p > b else b - p
    state.balances = tuple(bal)

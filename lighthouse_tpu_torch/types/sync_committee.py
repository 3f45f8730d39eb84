"""Altair sync-committee computation (spec get_next_sync_committee;
reference consensus/types/src/sync_committee.rs + state_processing altair
helpers): effective-balance-weighted sampling of sync_committee_size
validators, plus the aggregate pubkey."""

from __future__ import annotations

from ..crypto.bls.api import PublicKey
from ..crypto.bls import curve_ref as C
from .chain_spec import DOMAIN_SYNC_COMMITTEE, ChainSpec
from .helpers import (
    MAX_RANDOM_BYTE,
    get_active_validator_indices,
    get_seed,
    hash32,
)
from ..utils.shuffle import compute_shuffled_index
from .presets import Preset


def get_sync_committee_indices(
    state, base_epoch: int, preset: Preset, spec: ChainSpec
) -> list[int]:
    active = get_active_validator_indices(state, base_epoch)
    seed = get_seed(state, base_epoch, DOMAIN_SYNC_COMMITTEE, preset, spec)
    out = []
    i = 0
    n = len(active)
    while len(out) < preset.sync_committee_size:
        shuffled = compute_shuffled_index(i % n, n, seed, spec.shuffle_round_count)
        candidate = active[shuffled]
        rand = hash32(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= spec.max_effective_balance * rand:
            out.append(candidate)
        i += 1
    return out


def compute_sync_committee(
    state, base_epoch: int, preset: Preset, spec: ChainSpec
):
    from .containers import types_for

    t = types_for(preset)
    indices = get_sync_committee_indices(state, base_epoch, preset, spec)
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    agg = None
    for pb in pubkeys:
        pt = PublicKey.from_bytes(pb).point
        agg = pt if agg is None else agg + pt
    return t.SyncCommittee(
        pubkeys=tuple(pubkeys),
        aggregate_pubkey=C.g1_to_bytes(agg),
    )

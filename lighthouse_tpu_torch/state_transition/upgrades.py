"""Fork upgrades (reference consensus/state_processing/src/upgrade.rs):
state re-shaping at fork boundaries. phase0 -> altair translates pending
attestations into participation flags (spec translate_participation).

The port's copy of lighthouse_tpu/state_transition/upgrades.py."""

from __future__ import annotations

from ..types import compute_epoch_at_slot, types_for
from ..types.containers import Fork
from ..types.presets import Preset
from .participation import (
    add_flag,
    get_attestation_participation_flag_indices,
)


_FORK_ORDER = ["phase0", "altair", "bellatrix"]


def upgrade_state_if_due(state, preset: Preset, spec):
    """Called after each slot increment; upgrades (possibly through several
    forks, e.g. a config with no separate altair epoch) when the new slot is
    an epoch boundary and the spec names a later fork for that epoch."""
    if state.slot % preset.slots_per_epoch != 0:
        return state
    epoch = compute_epoch_at_slot(state.slot, preset)
    target = spec.fork_name_at_epoch(epoch)
    while _FORK_ORDER.index(state.fork_name) < _FORK_ORDER.index(target):
        if state.fork_name == "phase0":
            state = upgrade_to_altair(state, preset, spec)
        elif state.fork_name == "altair":
            state = upgrade_to_bellatrix(state, preset, spec)
    return state


def upgrade_to_altair(pre, preset: Preset, spec):
    t = types_for(preset)
    post = t.BeaconStateAltair.default()
    for name, _ in pre.ssz_fields:
        if hasattr(post, name) and name not in (
            "previous_epoch_attestations",
            "current_epoch_attestations",
        ):
            setattr(post, name, getattr(pre, name))
    post.fork = Fork(
        previous_version=pre.fork.current_version,
        current_version=spec.altair_fork_version,
        epoch=compute_epoch_at_slot(pre.slot, preset),
    )
    zeros = tuple(0 for _ in pre.validators)
    post.previous_epoch_participation = zeros
    post.current_epoch_participation = zeros
    post.inactivity_scores = zeros

    # translate_participation: replay previous-epoch pending attestations
    part = list(zeros)
    from ..types import CommitteeCache

    caches: dict[int, CommitteeCache] = {}
    for a in pre.previous_epoch_attestations:
        data = a.data
        try:
            flags = get_attestation_participation_flag_indices(
                post, data, a.inclusion_delay, preset, spec
            )
        except ValueError:
            continue
        epoch = compute_epoch_at_slot(data.slot, preset)
        cache = caches.get(epoch)
        if cache is None:
            cache = CommitteeCache(post, epoch, preset, spec)
            caches[epoch] = cache
        committee = cache.get_beacon_committee(data.slot, data.index)
        for i, bit in zip(committee, a.aggregation_bits):
            if bit:
                for f in flags:
                    part[i] = add_flag(part[i], f)
    post.previous_epoch_participation = tuple(part)

    from ..types.sync_committee import compute_sync_committee

    epoch = compute_epoch_at_slot(post.slot, preset)
    committee = compute_sync_committee(post, epoch + 1, preset, spec)
    post.current_sync_committee = committee
    post.next_sync_committee = committee
    return post


def upgrade_to_bellatrix(pre, preset: Preset, spec):
    """altair -> bellatrix (reference upgrade.rs upgrade_to_bellatrix):
    identical field copy plus a default (pre-merge, all-zero) execution
    payload header; the merge itself happens when the first payload-bearing
    block is imported (is_merge_transition_complete flips)."""
    t = types_for(preset)
    post = t.BeaconStateBellatrix.default()
    for name, _ in pre.ssz_fields:
        if hasattr(post, name):
            setattr(post, name, getattr(pre, name))
    post.fork = Fork(
        previous_version=pre.fork.current_version,
        current_version=spec.bellatrix_fork_version,
        epoch=compute_epoch_at_slot(pre.slot, preset),
    )
    post.latest_execution_payload_header = t.ExecutionPayloadHeader()
    return post

"""Vectorized altair/bellatrix per-epoch processing: numpy array passes
over balances / participation / registry columns instead of per-validator
Python loops (reference consensus/state_processing/src/per_epoch_processing/
altair/*.rs computes the same quantities via its ParticipationCache; here
the cache IS the column extraction).

Bit-exactness: every arithmetic step mirrors the spec's integer semantics
(floor division of non-negative int64/uint64 quantities). The handful of
products that could overflow 64 bits in pathological states (inactivity
scores beyond 2**28, slashing totals beyond 2**57) trip a guard that
falls back to the pure-Python oracle in per_epoch.py — the oracle stays
the semantic source of truth and the differential test in
tests/test_epoch_vec.py holds the two paths equal.

Scale target (BASELINE config 4): 500k-validator epoch transition < 1 s;
the loop oracle is ~10 s there.

The port's copy of lighthouse_tpu/state_transition/per_epoch_vec.py.
"""

from __future__ import annotations

import numpy as np

from ..types import FAR_FUTURE_EPOCH, GENESIS_EPOCH, compute_activation_exit_epoch
from ..types.presets import Preset
from ..utils.math import integer_squareroot
from .participation import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
)

_U64_FAR = np.uint64(FAR_FUTURE_EPOCH)


class VectorGuard(Exception):
    """A magnitude guard tripped: the state needs the arbitrary-precision
    oracle (per_epoch.py) for exactness."""


class _Columns:
    """One pass over the registry extracting the epoch-processing columns.

    Cached on the state instance keyed by the validators tuple's identity
    AND the preset (`state.__dict__['_lh_epoch_cols']`): epoch N+1 reuses
    epoch N's arrays — which the epoch-N writeback kept in sync — unless
    block processing replaced the registry tuple in between. The preset
    key matters when a harness swaps presets mid-process on a reused
    state object: identical tuple identity under a different preset must
    re-extract rather than serve stale column widths. clone_state is an
    SSZ round trip (fresh __dict__), so clones never alias the cache."""

    def __init__(self, state):
        vals = state.validators
        n = len(vals)
        self.n = n
        self.eff = np.fromiter(
            (v.effective_balance for v in vals), dtype=np.int64, count=n
        )
        self.slashed = np.fromiter(
            (v.slashed for v in vals), dtype=bool, count=n
        )
        self.activation = np.fromiter(
            (v.activation_epoch for v in vals), dtype=np.uint64, count=n
        )
        self.exit = np.fromiter(
            (v.exit_epoch for v in vals), dtype=np.uint64, count=n
        )
        self.withdrawable = np.fromiter(
            (v.withdrawable_epoch for v in vals), dtype=np.uint64, count=n
        )
        self.eligibility = np.fromiter(
            (v.activation_eligibility_epoch for v in vals),
            dtype=np.uint64,
            count=n,
        )

    def active_at(self, epoch: int) -> np.ndarray:
        e = np.uint64(epoch)
        return (self.activation <= e) & (e < self.exit)


def _columns_for(state, preset) -> _Columns:
    cached = state.__dict__.get("_lh_epoch_cols")
    if (
        cached is not None
        and len(cached) == 3
        and cached[0] is state.validators
        and cached[1] is preset
    ):
        return cached[2]
    return _Columns(state)


def _cached_col(state, key: str, field_value, dtype) -> np.ndarray:
    """Identity-keyed column cache for a basic-element list field."""
    cached = state.__dict__.get(key)
    if cached is not None and cached[0] is field_value:
        return cached[1]
    return np.fromiter(field_value, dtype=dtype, count=len(field_value))


def _total_with_floor(eff_sum: int, spec) -> int:
    # get_total_balance's EFFECTIVE_BALANCE_INCREMENT floor
    return max(spec.effective_balance_increment, int(eff_sum))


def process_epoch_altair_vec(state, preset: Preset, spec) -> None:
    """Drop-in replacement for per_epoch._process_epoch_altair. Raises
    VectorGuard when a magnitude guard would compromise exactness; the
    caller falls back to the oracle."""
    from .per_epoch import (
        _current_epoch,
        _previous_epoch,
        _process_eth1_data_reset,
        _process_historical_roots_update,
        _process_randao_mixes_reset,
        _process_slashings_reset,
        _process_sync_committee_updates,
        _weigh_justification_and_finalization,
    )

    current_epoch = _current_epoch(state, preset)
    previous_epoch = _previous_epoch(state, preset)
    original_validators = state.validators
    cols = _columns_for(state, preset)
    n = cols.n
    incr = spec.effective_balance_increment

    active_cur = cols.active_at(current_epoch)
    active_prev = cols.active_at(previous_epoch)
    total_balance = _total_with_floor(cols.eff[active_cur].sum(), spec)

    part_prev = _cached_col(
        state, "_lh_part_prev", state.previous_epoch_participation, np.uint8
    )
    part_cur = _cached_col(
        state, "_lh_part_cur", state.current_epoch_participation, np.uint8
    )

    # ALL magnitude guards run before any state mutation: a guard that
    # tripped mid-flight would hand the oracle a half-processed state.
    sqrt_total = integer_squareroot(total_balance)
    base_per_inc = incr * spec.base_reward_factor // sqrt_total
    active_increments = total_balance // incr
    if base_per_inc * 32 * max(PARTICIPATION_FLAG_WEIGHTS) * max(
        1, active_increments
    ) >= 2**62:
        raise VectorGuard("flag reward product near int64")
    scores0 = _cached_col(
        state, "_lh_scores", state.inactivity_scores, np.uint64
    )
    if n and int(scores0.max(initial=0)) + spec.inactivity_score_bias >= 2**28:
        raise VectorGuard("inactivity score near overflow")

    def participating(flag_index: int, epoch: int) -> np.ndarray:
        part = part_cur if epoch == current_epoch else part_prev
        active = active_cur if epoch == current_epoch else active_prev
        flag = (part & np.uint8(1 << flag_index)) != 0
        return active & flag & ~cols.slashed

    # 1. justification & finalization (the checkpoint logic itself is
    # scalar; only the participating-balance sums are the hot part)
    if current_epoch > GENESIS_EPOCH + 1:
        prev_target_bal = _total_with_floor(
            cols.eff[participating(TIMELY_TARGET_FLAG_INDEX, previous_epoch)].sum(),
            spec,
        )
        cur_target_bal = _total_with_floor(
            cols.eff[participating(TIMELY_TARGET_FLAG_INDEX, current_epoch)].sum(),
            spec,
        )
        _weigh_justification_and_finalization(
            state, total_balance, prev_target_bal, cur_target_bal, preset
        )

    # eligibility mask (spec get_eligible_validator_indices)
    eligible = active_prev | (
        cols.slashed & (np.uint64(previous_epoch + 1) < cols.withdrawable)
    )
    finality_delay = previous_epoch - state.finalized_checkpoint.epoch
    in_leak = finality_delay > spec.min_epochs_to_inactivity_penalty

    prev_target = participating(TIMELY_TARGET_FLAG_INDEX, previous_epoch)

    # 2. inactivity scores (spec process_inactivity_updates); order matters:
    # flag-delta inactivity penalties read the UPDATED scores
    scores = scores0
    if current_epoch > GENESIS_EPOCH:
        hit = eligible & prev_target
        miss = eligible & ~prev_target
        scores[hit] -= np.minimum(np.uint64(1), scores[hit])
        scores[miss] += np.uint64(spec.inactivity_score_bias)
        if not in_leak:
            scores[eligible] -= np.minimum(
                np.uint64(spec.inactivity_score_recovery_rate), scores[eligible]
            )
        new_scores = tuple(scores.tolist())
        state.inactivity_scores = new_scores
        state.__dict__["_lh_scores"] = (new_scores, scores)

    # 3. rewards & penalties (spec get_flag_index_deltas + inactivity)
    balances = _cached_col(state, "_lh_bal", state.balances, np.int64)
    if current_epoch > GENESIS_EPOCH:
        base = (cols.eff // incr) * np.int64(base_per_inc)

        rewards = np.zeros(n, dtype=np.int64)
        penalties = np.zeros(n, dtype=np.int64)
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            part = participating(flag_index, previous_epoch)
            part_increments = (
                _total_with_floor(cols.eff[part].sum(), spec) // incr
            )
            hit = eligible & part
            if not in_leak:
                rewards[hit] += (
                    base[hit]
                    * np.int64(weight)
                    * np.int64(part_increments)
                    // np.int64(active_increments * WEIGHT_DENOMINATOR)
                )
            if flag_index != TIMELY_HEAD_FLAG_INDEX:
                miss = eligible & ~part
                penalties[miss] += (
                    base[miss] * np.int64(weight) // np.int64(WEIGHT_DENOMINATOR)
                )
        # inactivity penalties read the updated scores
        miss_target = eligible & ~prev_target
        denom = (
            spec.inactivity_score_bias
            * spec.inactivity_penalty_quotient_for(state.fork_name)
        )
        penalties[miss_target] += (
            cols.eff[miss_target] * scores[miss_target].astype(np.int64)
            // np.int64(denom)
        )
        # apply_balance_deltas semantics: add rewards, clamp penalties at 0
        b = balances + rewards
        balances = np.where(penalties > b, np.int64(0), b - penalties)

    # 4. registry updates (spec process_registry_updates)
    changed = _registry_updates_vec(
        state, cols, active_cur, current_epoch, preset, spec
    )

    # 5. slashings (spec process_slashings, altair multiplier); the hits
    # are rare (slashed + exact half-vector withdrawable epoch) so the
    # penalty arithmetic runs in exact Python ints per hit
    slash_sum = sum(state.slashings)
    adjusted = min(
        slash_sum * spec.proportional_slashing_multiplier_for(state.fork_name),
        total_balance
    )
    hits = np.nonzero(
        cols.slashed
        & (
            np.uint64(current_epoch + preset.epochs_per_slashings_vector // 2)
            == cols.withdrawable
        )
    )[0]
    for i in hits.tolist():
        penalty = (
            int(cols.eff[i]) // incr * adjusted // total_balance * incr
        )
        balances[i] = 0 if penalty > balances[i] else balances[i] - penalty

    # 6-7. eth1 + effective-balance hysteresis (balances are final now)
    _process_eth1_data_reset(state, preset)
    changed |= _effective_balance_updates_vec(state, cols, balances, spec)

    new_bal = tuple(balances.tolist())
    state.balances = new_bal
    state.__dict__["_lh_bal"] = (new_bal, balances)

    # registry writeback: ONE surgical tree-cache update covering every
    # validator index any phase touched; a clean epoch keeps the original
    # tuple identity so the hash cache skips the field entirely
    if changed or state.validators is not original_validators:
        from ..ssz.cached import surgical_list_update

        final = tuple(list(state.validators))
        surgical_list_update(
            state, "validators", original_validators, final, sorted(changed)
        )
    state.__dict__["_lh_epoch_cols"] = (state.validators, preset, cols)

    # 8-10. resets, historical roots, rotation, sync committees
    _process_slashings_reset(state, preset)
    _process_randao_mixes_reset(state, preset)
    _process_historical_roots_update(state, preset)
    rotated = state.current_epoch_participation
    state.previous_epoch_participation = rotated
    new_cur = (0,) * n
    state.current_epoch_participation = new_cur
    state.__dict__["_lh_part_prev"] = (rotated, part_cur)
    state.__dict__["_lh_part_cur"] = (new_cur, np.zeros(n, dtype=np.uint8))
    _process_sync_committee_updates(state, preset, spec)


def _registry_updates_vec(
    state, cols, active_cur, current_epoch, preset, spec
) -> set[int]:
    """Spec process_registry_updates over columns. Eligibility marking and
    the activation queue are vectorized; ejections (rare) run through the
    exact initiate_validator_exit path. Element objects are mutated in
    place; the caller issues one surgical tree-cache update for the
    returned changed-index set."""
    from .per_block import initiate_validator_exit

    vals = state.validators
    changed: set[int] = set()

    newly_eligible = np.nonzero(
        (cols.eligibility == _U64_FAR)
        & (cols.eff == np.int64(spec.max_effective_balance))
    )[0]
    for i in newly_eligible.tolist():
        vals[i].activation_eligibility_epoch = current_epoch + 1
        cols.eligibility[i] = current_epoch + 1
        changed.add(i)

    ejections = np.nonzero(
        active_cur & (cols.eff <= np.int64(spec.ejection_balance))
    )[0]
    for i in ejections.tolist():
        initiate_validator_exit(state, i, preset, spec)
        v = state.validators[i]
        cols.exit[i] = v.exit_epoch
        cols.withdrawable[i] = v.withdrawable_epoch
        changed.add(i)
    vals = state.validators

    # activation queue: eligible-for-activation, FIFO by (eligibility, index)
    candidates = np.nonzero(
        (cols.eligibility <= np.uint64(state.finalized_checkpoint.epoch))
        & (cols.activation == _U64_FAR)
    )[0]
    if len(candidates):
        order = np.lexsort((candidates, cols.eligibility[candidates]))
        active_count = int(active_cur.sum())
        churn_limit = max(
            spec.min_per_epoch_churn_limit,
            active_count // spec.churn_limit_quotient,
        )
        target_epoch = compute_activation_exit_epoch(current_epoch, spec)
        for i in candidates[order[:churn_limit]].tolist():
            vals[i].activation_epoch = target_epoch
            cols.activation[i] = target_epoch
            changed.add(i)
    return changed


def _effective_balance_updates_vec(state, cols, balances, spec) -> set[int]:
    """Spec process_effective_balance_updates: hysteresis compare over the
    whole registry, object writes only for the (few) crossers."""
    incr = spec.effective_balance_increment
    hysteresis_increment = incr // spec.hysteresis_quotient
    down = hysteresis_increment * spec.hysteresis_downward_multiplier
    up = hysteresis_increment * spec.hysteresis_upward_multiplier
    crossed = np.nonzero(
        (balances + np.int64(down) < cols.eff)
        | (cols.eff + np.int64(up) < balances)
    )[0]
    vals = state.validators
    max_eff = spec.max_effective_balance
    for i in crossed.tolist():
        b = int(balances[i])
        new_eff = min(b - b % incr, max_eff)
        vals[i].effective_balance = new_eff
        cols.eff[i] = new_eff
    return set(crossed.tolist())

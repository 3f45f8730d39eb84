"""Per-epoch state transition, phase0 + altair (reference
consensus/state_processing/src/per_epoch_processing.rs and its
per_epoch_processing/{base,altair} modules).

Runs at the last slot of each epoch (before the slot increments), so
"current epoch" below is the epoch being closed.

The port's copy of lighthouse_tpu/state_transition/per_epoch.py.
"""

from __future__ import annotations

from ..types import (
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    compute_activation_exit_epoch,
    compute_epoch_at_slot,
    get_active_validator_indices,
    is_active_validator,
)
from ..types.containers import Checkpoint
from ..types.helpers import (
    apply_balance_deltas,
    decrease_balance,
    get_block_root,
    get_block_root_at_slot,
    get_total_balance,
)
from ..types.presets import Preset
from ..utils.math import integer_squareroot
from .participation import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    get_base_reward_per_increment,
    has_flag,
)

BASE_REWARDS_PER_EPOCH = 4


def process_epoch(state, preset: Preset, spec):
    if state.fork_name == "phase0":
        _process_epoch_base(state, preset, spec)
        return
    import os

    if os.environ.get("LIGHTHOUSE_TPU_EPOCH_ORACLE"):
        _process_epoch_altair(state, preset, spec)
        return
    from .per_epoch_vec import VectorGuard, process_epoch_altair_vec

    if os.environ.get("LIGHTHOUSE_TPU_EPOCH_MESH") == "1":
        # raised before the state is touched: the port has no epoch mesh,
        # and quietly taking the vector path would hide that
        raise NotImplementedError(
            "LIGHTHOUSE_TPU_EPOCH_MESH=1: the epoch mesh is not ported yet "
            "(ROADMAP Queue 1 item 13)"
        )
    try:
        process_epoch_altair_vec(state, preset, spec)
    except VectorGuard:
        # magnitude guard tripped (pathological state): the arbitrary-
        # precision loop oracle is always exact
        _process_epoch_altair(state, preset, spec)


def compute_unrealized_checkpoints(state, preset: Preset, spec):
    """What (justified, finalized) WOULD become if the next epoch boundary
    processed this state's attestations right now -- the fork-choice
    unrealized-justification input (reference fork_choice.rs
    compute_unrealized_checkpoints / state_processing's
    per_epoch_processing::altair::participation_cache justifiability).

    Runs the real weigh function against the live state, then restores the
    four fields it mutates -- no state clone."""
    current_epoch = _current_epoch(state, preset)
    jc = (
        state.current_justified_checkpoint.epoch,
        bytes(state.current_justified_checkpoint.root),
    )
    fc = (
        state.finalized_checkpoint.epoch,
        bytes(state.finalized_checkpoint.root),
    )
    if current_epoch <= GENESIS_EPOCH + 1:
        return jc, fc
    if not hasattr(state, "previous_justified_checkpoint"):
        # reduced/stub states without the justification machinery (test
        # doubles): nothing unrealized to compute
        return jc, fc

    saved = (
        state.previous_justified_checkpoint,
        state.current_justified_checkpoint,
        state.justification_bits,
        state.finalized_checkpoint,
    )
    try:
        total_balance, prev_bal, cur_bal = _justification_target_balances(
            state, preset, spec
        )
        _weigh_justification_and_finalization(
            state, total_balance, prev_bal, cur_bal, preset
        )
        ujc = (
            state.current_justified_checkpoint.epoch,
            bytes(state.current_justified_checkpoint.root),
        )
        ufc = (
            state.finalized_checkpoint.epoch,
            bytes(state.finalized_checkpoint.root),
        )
        return ujc, ufc
    finally:
        (
            state.previous_justified_checkpoint,
            state.current_justified_checkpoint,
            state.justification_bits,
            state.finalized_checkpoint,
        ) = saved


def _justification_target_balances(state, preset: Preset, spec):
    """(total_active, prev_target, cur_target) balances feeding
    weigh_justification_and_finalization — the ONE implementation behind
    the full transitions, the isolated EF sub-transition, and the
    fork-choice unrealized-checkpoint computation."""
    current_epoch = _current_epoch(state, preset)
    total = _total_active_balance(state, preset, spec)
    if state.fork_name == "phase0":
        cache_map: dict = {}
        prev = _attesting_indices(
            state,
            _matching_target_attestations(
                state, _previous_epoch(state, preset), preset
            ),
            preset,
            spec,
            cache_map,
        )
        try:
            cur_matching = _matching_target_attestations(
                state, current_epoch, preset
            )
        except ValueError:
            # a state AT its epoch-start slot has no current-epoch block
            # root yet (and necessarily no current-epoch attestations)
            cur_matching = []
        cur = _attesting_indices(state, cur_matching, preset, spec, cache_map)
    else:
        prev = _unslashed_participating_indices(
            state,
            TIMELY_TARGET_FLAG_INDEX,
            _previous_epoch(state, preset),
            preset,
        )
        cur = _unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, current_epoch, preset
        )
    return (
        total,
        get_total_balance(state, prev, spec),
        get_total_balance(state, cur, spec),
    )


def _rotate_participation(state) -> None:
    """End-of-epoch participation rotation, both flavors."""
    if state.fork_name == "phase0":
        state.previous_epoch_attestations = state.current_epoch_attestations
        state.current_epoch_attestations = ()
    else:
        state.previous_epoch_participation = state.current_epoch_participation
        state.current_epoch_participation = tuple(0 for _ in state.validators)


def run_epoch_sub_transition(state, handler: str, preset: Preset, spec):
    """Run ONE epoch sub-transition by its EF-vector handler name
    (testing/ef_tests/src/cases/epoch_processing.rs maps the same names
    to the same isolated spec functions). The official epoch_processing
    vectors' post-states reflect only the named step, so the runner must
    not execute the full transition."""
    phase0 = state.fork_name == "phase0"
    current_epoch = _current_epoch(state, preset)
    if handler == "justification_and_finalization":
        if current_epoch <= GENESIS_EPOCH + 1:
            return
        total, prev_bal, cur_bal = _justification_target_balances(
            state, preset, spec
        )
        _weigh_justification_and_finalization(
            state, total, prev_bal, cur_bal, preset
        )
    elif handler == "inactivity_updates":
        if not phase0 and current_epoch > GENESIS_EPOCH:
            _process_inactivity_updates(state, preset, spec)
    elif handler == "rewards_and_penalties":
        if current_epoch <= GENESIS_EPOCH:
            return
        total = _total_active_balance(state, preset, spec)
        if phase0:
            rewards, penalties = _attestation_deltas(
                state, preset, spec, {}, total
            )
        else:
            rewards, penalties = _flag_deltas(state, preset, spec, total)
        apply_balance_deltas(state, rewards, penalties)
    elif handler == "registry_updates":
        _process_registry_updates(state, preset, spec)
    elif handler == "slashings":
        _process_slashings(
            state,
            preset,
            spec,
            spec.proportional_slashing_multiplier_for(state.fork_name),
        )
    elif handler == "eth1_data_reset":
        _process_eth1_data_reset(state, preset)
    elif handler == "effective_balance_updates":
        _process_effective_balance_updates(state, spec)
    elif handler == "slashings_reset":
        _process_slashings_reset(state, preset)
    elif handler == "randao_mixes_reset":
        _process_randao_mixes_reset(state, preset)
    elif handler in ("historical_roots_update", "historical_summaries_update"):
        _process_historical_roots_update(state, preset)
    elif handler in (
        "participation_record_updates",
        "participation_flag_updates",
    ):
        _rotate_participation(state)
    elif handler == "sync_committee_updates":
        _process_sync_committee_updates(state, preset, spec)
    else:
        raise ValueError(f"unknown epoch sub-transition {handler!r}")


# ===========================================================================
# shared machinery
# ===========================================================================


def _current_epoch(state, preset):
    return compute_epoch_at_slot(state.slot, preset)


def _previous_epoch(state, preset):
    cur = _current_epoch(state, preset)
    return cur - 1 if cur > GENESIS_EPOCH else GENESIS_EPOCH


def _total_active_balance(state, preset, spec):
    return get_total_balance(
        state,
        get_active_validator_indices(state, _current_epoch(state, preset)),
        spec,
    )


def _finality_delay(state, preset):
    return (
        _previous_epoch(state, preset)
        - state.finalized_checkpoint.epoch
    )


def _is_in_inactivity_leak(state, preset, spec):
    return _finality_delay(state, preset) > spec.min_epochs_to_inactivity_penalty


def _eligible_validator_indices(state, preset):
    prev = _previous_epoch(state, preset)
    return [
        i
        for i, v in enumerate(state.validators)
        if is_active_validator(v, prev)
        or (v.slashed and prev + 1 < v.withdrawable_epoch)
    ]


def _weigh_justification_and_finalization(
    state,
    total_active_balance: int,
    previous_target_balance: int,
    current_target_balance: int,
    preset: Preset,
):
    """Spec weigh_justification_and_finalization -- shared by both forks."""
    previous_epoch = _previous_epoch(state, preset)
    current_epoch = _current_epoch(state, preset)
    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[:-1]

    if previous_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=previous_epoch,
            root=get_block_root(state, previous_epoch, preset),
        )
        bits[1] = True
    if current_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=current_epoch,
            root=get_block_root(state, current_epoch, preset),
        )
        bits[0] = True
    state.justification_bits = tuple(bits)

    # finalization
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


def _process_registry_updates(state, preset, spec):
    current_epoch = _current_epoch(state, preset)
    vals = list(state.validators)
    for v in vals:
        if (
            v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
            and v.effective_balance == spec.max_effective_balance
        ):
            v.activation_eligibility_epoch = current_epoch + 1
        if (
            is_active_validator(v, current_epoch)
            and v.effective_balance <= spec.ejection_balance
        ):
            from .per_block import initiate_validator_exit

            state.validators = tuple(vals)
            initiate_validator_exit(state, vals.index(v), preset, spec)
            vals = list(state.validators)

    activation_queue = sorted(
        (
            i
            for i, v in enumerate(vals)
            if v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (vals[i].activation_eligibility_epoch, i),
    )
    active = len(get_active_validator_indices(state, current_epoch))
    churn_limit = max(
        spec.min_per_epoch_churn_limit, active // spec.churn_limit_quotient
    )
    for i in activation_queue[:churn_limit]:
        vals[i].activation_epoch = compute_activation_exit_epoch(
            current_epoch, spec
        )
    state.validators = tuple(vals)


def _process_slashings(state, preset, spec, multiplier: int):
    epoch = _current_epoch(state, preset)
    total_balance = _total_active_balance(state, preset, spec)
    adjusted = min(sum(state.slashings) * multiplier, total_balance)
    incr = spec.effective_balance_increment
    for i, v in enumerate(state.validators):
        if (
            v.slashed
            and epoch + preset.epochs_per_slashings_vector // 2
            == v.withdrawable_epoch
        ):
            penalty = (
                v.effective_balance // incr * adjusted // total_balance * incr
            )
            decrease_balance(state, i, penalty)


def _process_eth1_data_reset(state, preset):
    next_epoch = _current_epoch(state, preset) + 1
    if next_epoch % preset.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = ()


def _process_effective_balance_updates(state, spec):
    incr = spec.effective_balance_increment
    hysteresis_increment = incr // spec.hysteresis_quotient
    down = hysteresis_increment * spec.hysteresis_downward_multiplier
    up = hysteresis_increment * spec.hysteresis_upward_multiplier
    vals = list(state.validators)
    for i, v in enumerate(vals):
        balance = state.balances[i]
        if (
            balance + down < v.effective_balance
            or v.effective_balance + up < balance
        ):
            v.effective_balance = min(
                balance - balance % incr, spec.max_effective_balance
            )
    state.validators = tuple(vals)


def _process_slashings_reset(state, preset):
    next_epoch = _current_epoch(state, preset) + 1
    s = list(state.slashings)
    s[next_epoch % preset.epochs_per_slashings_vector] = 0
    state.slashings = tuple(s)


def _process_randao_mixes_reset(state, preset):
    current = _current_epoch(state, preset)
    next_epoch = current + 1
    mixes = list(state.randao_mixes)
    mixes[next_epoch % preset.epochs_per_historical_vector] = mixes[
        current % preset.epochs_per_historical_vector
    ]
    state.randao_mixes = tuple(mixes)


def _process_historical_roots_update(state, preset):
    next_epoch = _current_epoch(state, preset) + 1
    if (
        next_epoch
        % (preset.slots_per_historical_root // preset.slots_per_epoch)
        == 0
    ):
        from ..types.containers import types_for

        t = types_for(preset)
        batch = t.HistoricalBatch(
            block_roots=state.block_roots, state_roots=state.state_roots
        )
        state.historical_roots = (
            *state.historical_roots,
            batch.tree_hash_root(),
        )


# ===========================================================================
# phase0
# ===========================================================================


def _matching_source_attestations(state, epoch, preset):
    if epoch == _current_epoch(state, preset):
        return list(state.current_epoch_attestations)
    if epoch == _previous_epoch(state, preset):
        return list(state.previous_epoch_attestations)
    raise ValueError("epoch out of attestation range")


def _matching_target_attestations(state, epoch, preset):
    target_root = get_block_root(state, epoch, preset)
    return [
        a
        for a in _matching_source_attestations(state, epoch, preset)
        if bytes(a.data.target.root) == bytes(target_root)
    ]


def _matching_head_attestations(state, epoch, preset):
    return [
        a
        for a in _matching_target_attestations(state, epoch, preset)
        if bytes(a.data.beacon_block_root)
        == bytes(get_block_root_at_slot(state, a.data.slot, preset))
    ]


def _attesting_indices(state, attestations, preset, spec, cache_map):
    """Union of unslashed attesters over PendingAttestations; committee
    lookups share per-epoch CommitteeCaches."""
    from ..types import CommitteeCache

    out = set()
    for a in attestations:
        epoch = compute_epoch_at_slot(a.data.slot, preset)
        cache = cache_map.get(epoch)
        if cache is None:
            cache = CommitteeCache(state, epoch, preset, spec)
            cache_map[epoch] = cache
        committee = cache.get_beacon_committee(a.data.slot, a.data.index)
        for i, bit in zip(committee, a.aggregation_bits):
            if bit and not state.validators[i].slashed:
                out.add(i)
    return out


def _get_base_reward(state, index, total_balance_sqrt, spec):
    return (
        state.validators[index].effective_balance
        * spec.base_reward_factor
        // total_balance_sqrt
        // BASE_REWARDS_PER_EPOCH
    )


def _process_epoch_base(state, preset, spec):
    cache_map: dict = {}
    current_epoch = _current_epoch(state, preset)
    previous_epoch = _previous_epoch(state, preset)
    total_balance = _total_active_balance(state, preset, spec)

    # 1. justification & finalization
    if current_epoch > GENESIS_EPOCH + 1:
        _, prev_bal, cur_bal = _justification_target_balances(
            state, preset, spec
        )
        _weigh_justification_and_finalization(
            state, total_balance, prev_bal, cur_bal, preset
        )

    # 2. rewards & penalties
    if current_epoch > GENESIS_EPOCH:
        rewards, penalties = _attestation_deltas(
            state, preset, spec, cache_map, total_balance
        )
        apply_balance_deltas(state, rewards, penalties)

    # 3-10. registry, slashings, resets
    _process_registry_updates(state, preset, spec)
    _process_slashings(state, preset, spec, spec.proportional_slashing_multiplier)
    _process_eth1_data_reset(state, preset)
    _process_effective_balance_updates(state, spec)
    _process_slashings_reset(state, preset)
    _process_randao_mixes_reset(state, preset)
    _process_historical_roots_update(state, preset)
    _rotate_participation(state)


def attestation_component_deltas(state, preset, spec, cache_map, total_balance):
    """Phase0 reward/penalty deltas SPLIT BY COMPONENT, matching the EF
    rewards vectors' file set (cases/rewards.rs; reference
    per_epoch_processing/base/rewards_and_penalties.rs): source, target,
    head, inclusion_delay, inactivity -- each (rewards, penalties)."""
    n = len(state.validators)
    previous_epoch = _previous_epoch(state, preset)
    sqrt_total = integer_squareroot(total_balance)
    eligible = _eligible_validator_indices(state, preset)
    in_leak = _is_in_inactivity_leak(state, preset, spec)
    incr = spec.effective_balance_increment

    source_atts = _matching_source_attestations(state, previous_epoch, preset)
    target_atts = _matching_target_attestations(state, previous_epoch, preset)
    head_atts = _matching_head_attestations(state, previous_epoch, preset)

    out: dict[str, tuple[list[int], list[int]]] = {}
    for name, atts in (
        ("source", source_atts),
        ("target", target_atts),
        ("head", head_atts),
    ):
        rewards = [0] * n
        penalties = [0] * n
        attesting = _attesting_indices(state, atts, preset, spec, cache_map)
        attesting_balance = get_total_balance(state, attesting, spec)
        for i in eligible:
            base = _get_base_reward(state, i, sqrt_total, spec)
            if i in attesting:
                if in_leak:
                    rewards[i] += base
                else:
                    rewards[i] += (
                        base
                        * (attesting_balance // incr)
                        // (total_balance // incr)
                    )
            else:
                penalties[i] += base
        out[name] = (rewards, penalties)

    # inclusion delay rewards (source attesters only; no penalties)
    rewards = [0] * n
    source_attesting = _attesting_indices(
        state, source_atts, preset, spec, cache_map
    )
    best: dict[int, object] = {}
    for a in source_atts:
        epoch = compute_epoch_at_slot(a.data.slot, preset)
        cache = cache_map[epoch]
        committee = cache.get_beacon_committee(a.data.slot, a.data.index)
        for i, bit in zip(committee, a.aggregation_bits):
            if bit and i in source_attesting:
                if i not in best or a.inclusion_delay < best[i].inclusion_delay:
                    best[i] = a
    for i, a in best.items():
        base = _get_base_reward(state, i, sqrt_total, spec)
        proposer_reward = base // spec.proposer_reward_quotient
        rewards[a.proposer_index] += proposer_reward
        max_attester_reward = base - proposer_reward
        rewards[i] += max_attester_reward // a.inclusion_delay
    out["inclusion_delay"] = (rewards, [0] * n)

    # inactivity penalties (no rewards)
    penalties = [0] * n
    if in_leak:
        target_attesting = _attesting_indices(
            state, target_atts, preset, spec, cache_map
        )
        delay = _finality_delay(state, preset)
        for i in eligible:
            base = _get_base_reward(state, i, sqrt_total, spec)
            proposer_reward = base // spec.proposer_reward_quotient
            penalties[i] += BASE_REWARDS_PER_EPOCH * base - proposer_reward
            if i not in target_attesting:
                penalties[i] += (
                    state.validators[i].effective_balance
                    * delay
                    // spec.inactivity_penalty_quotient
                )
    out["inactivity"] = ([0] * n, penalties)
    return out


def _attestation_deltas(state, preset, spec, cache_map, total_balance):
    """Phase0 get_attestation_deltas: the component sum."""
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    components = attestation_component_deltas(
        state, preset, spec, cache_map, total_balance
    )
    for r, p in components.values():
        for i in range(n):
            rewards[i] += r[i]
            penalties[i] += p[i]
    return rewards, penalties


# ===========================================================================
# altair
# ===========================================================================


def _unslashed_participating_indices(state, flag_index, epoch, preset):
    if epoch == _current_epoch(state, preset):
        participation = state.current_epoch_participation
    else:
        participation = state.previous_epoch_participation
    return {
        i
        for i in get_active_validator_indices(state, epoch)
        if has_flag(participation[i], flag_index)
        and not state.validators[i].slashed
    }


def _process_epoch_altair(state, preset, spec):
    current_epoch = _current_epoch(state, preset)
    previous_epoch = _previous_epoch(state, preset)
    total_balance = _total_active_balance(state, preset, spec)

    # 1. justification & finalization from participation flags
    if current_epoch > GENESIS_EPOCH + 1:
        _, prev_bal, cur_bal = _justification_target_balances(
            state, preset, spec
        )
        _weigh_justification_and_finalization(
            state, total_balance, prev_bal, cur_bal, preset
        )

    # 2. inactivity scores
    if current_epoch > GENESIS_EPOCH:
        _process_inactivity_updates(state, preset, spec)

    # 3. rewards & penalties
    if current_epoch > GENESIS_EPOCH:
        rewards, penalties = _flag_deltas(state, preset, spec, total_balance)
        apply_balance_deltas(state, rewards, penalties)

    _process_registry_updates(state, preset, spec)
    _process_slashings(
        state,
        preset,
        spec,
        spec.proportional_slashing_multiplier_for(state.fork_name),
    )
    _process_eth1_data_reset(state, preset)
    _process_effective_balance_updates(state, spec)
    _process_slashings_reset(state, preset)
    _process_randao_mixes_reset(state, preset)
    _process_historical_roots_update(state, preset)
    _rotate_participation(state)
    _process_sync_committee_updates(state, preset, spec)


def _process_inactivity_updates(state, preset, spec):
    previous_epoch = _previous_epoch(state, preset)
    target = _unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, previous_epoch, preset
    )
    leak = _is_in_inactivity_leak(state, preset, spec)
    scores = list(state.inactivity_scores)
    for i in _eligible_validator_indices(state, preset):
        if i in target:
            scores[i] -= min(1, scores[i])
        else:
            scores[i] += spec.inactivity_score_bias
        if not leak:
            scores[i] -= min(spec.inactivity_score_recovery_rate, scores[i])
    state.inactivity_scores = tuple(scores)


def flag_component_deltas(state, preset, spec, total_balance):
    """Altair reward/penalty deltas split by component (source, target,
    head, inactivity), matching the EF rewards vectors' altair file set."""
    n = len(state.validators)
    previous_epoch = _previous_epoch(state, preset)
    eligible = _eligible_validator_indices(state, preset)
    in_leak = _is_in_inactivity_leak(state, preset, spec)
    incr = spec.effective_balance_increment
    base_per_inc = get_base_reward_per_increment(state, preset, spec)
    active_increments = total_balance // incr

    from .participation import WEIGHT_DENOMINATOR

    out: dict[str, tuple[list[int], list[int]]] = {}
    names = {0: "source", 1: "target", 2: "head"}
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        rewards = [0] * n
        penalties = [0] * n
        participating = _unslashed_participating_indices(
            state, flag_index, previous_epoch, preset
        )
        participating_increments = (
            get_total_balance(state, participating, spec) // incr
        )
        for i in eligible:
            base = (
                state.validators[i].effective_balance // incr * base_per_inc
            )
            if i in participating:
                if not in_leak:
                    rewards[i] += (
                        base
                        * weight
                        * participating_increments
                        // (active_increments * WEIGHT_DENOMINATOR)
                    )
            elif flag_index != TIMELY_HEAD_FLAG_INDEX:
                penalties[i] += base * weight // WEIGHT_DENOMINATOR
        out[names[flag_index]] = (rewards, penalties)

    # inactivity penalties (no rewards)
    penalties = [0] * n
    target = _unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, previous_epoch, preset
    )
    for i in eligible:
        if i not in target:
            penalties[i] += (
                state.validators[i].effective_balance
                * state.inactivity_scores[i]
                // (
                    spec.inactivity_score_bias
                    * spec.inactivity_penalty_quotient_for(state.fork_name)
                )
            )
    out["inactivity"] = ([0] * n, penalties)
    return out


def _flag_deltas(state, preset, spec, total_balance):
    """Altair combined deltas: the component sum."""
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    for r, p in flag_component_deltas(
        state, preset, spec, total_balance
    ).values():
        for i in range(n):
            rewards[i] += r[i]
            penalties[i] += p[i]
    return rewards, penalties


def _process_sync_committee_updates(state, preset, spec):
    next_epoch = _current_epoch(state, preset) + 1
    if next_epoch % preset.epochs_per_sync_committee_period == 0:
        from ..types.sync_committee import compute_sync_committee

        state.current_sync_committee = state.next_sync_committee
        # spec get_next_sync_committee samples at current_epoch + 1
        state.next_sync_committee = compute_sync_committee(
            state, next_epoch, preset, spec
        )

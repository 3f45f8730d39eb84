"""Per-block state transition (reference consensus/state_processing/src/
per_block_processing.rs:91 `per_block_processing`, plus the process_
operations modules). Signature handling follows the reference's
`BlockSignatureStrategy` (per_block_processing.rs:45-56): NoVerification /
VerifyIndividual / VerifyBulk / VerifyRandao -- bulk collects every set and
makes ONE backend call (the batch path on the card).

The port's copy of lighthouse_tpu/state_transition/per_block.py.
"""

from __future__ import annotations

import enum

from ..crypto.bls.api import verify_signature_sets
from ..types import (
    FAR_FUTURE_EPOCH,
    compute_activation_exit_epoch,
    compute_epoch_at_slot,
    get_domain,
    is_active_validator,
    is_slashable_validator,
)
from ..types.chain_spec import DOMAIN_RANDAO
from ..types.containers import BeaconBlockHeader, Validator, types_for
from ..types.helpers import (
    apply_balance_deltas,
    decrease_balance,
    get_block_root,
    get_block_root_at_slot,
    get_randao_mix,
    get_total_active_balance,
    hash32,
    increase_balance,
)
from ..types.presets import Preset
from .context import BlockProcessingError, ConsensusContext
from .participation import (
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    WEIGHT_DENOMINATOR,
    add_flag,
    get_attestation_participation_flag_indices,
    get_base_reward_altair,
    get_base_reward_per_increment,
    has_flag,
)
from .signature_sets import (
    attester_slashing_signature_sets,
    block_proposal_signature_set,
    deposit_signature_set,
    exit_signature_set,
    indexed_attestation_signature_set,
    proposer_slashing_signature_sets,
    randao_signature_set,
    state_pubkey_getter,
    sync_aggregate_signature_set,
)


class BlockSignatureStrategy(enum.Enum):
    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_BULK = "verify_bulk"
    VERIFY_RANDAO = "verify_randao"


class BlockProcessingSignatureError(BlockProcessingError):
    pass


def per_block_processing(
    state,
    signed_block,
    preset: Preset,
    spec,
    strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ctxt: ConsensusContext | None = None,
    verified_proposer_index: int | None = None,
    get_pubkey=None,
    resolve_pubkey=None,
):
    """Mutates `state` by applying `signed_block`. Signature work follows
    `strategy`; bulk mode batches all sets into one verifier call via
    BlockSignatureVerifier. `get_pubkey`/`resolve_pubkey` are the chain's
    pubkey-cache hooks: passing them keeps every set table-tagged, so the
    bulk batch gathers limb rows from the device-resident table instead
    of host-packing -- whole-block import as one device program."""
    ctxt = ctxt or ConsensusContext(preset, spec)

    if strategy in (
        BlockSignatureStrategy.VERIFY_BULK,
        BlockSignatureStrategy.VERIFY_INDIVIDUAL,
    ):
        from .block_signature_verifier import BlockSignatureVerifier

        verifier = BlockSignatureVerifier(
            state, preset, spec, ctxt,
            get_pubkey=get_pubkey, resolve_pubkey=resolve_pubkey,
        )
        verifier.include_all_signatures(signed_block)
        if strategy is BlockSignatureStrategy.VERIFY_BULK:
            if not verifier.verify(slot=int(signed_block.message.slot)):
                raise BlockProcessingSignatureError("bulk signature check failed")
        else:
            for s in verifier.sets:
                if not verify_signature_sets([s]):
                    raise BlockProcessingSignatureError(
                        "individual signature check failed"
                    )
    elif strategy is BlockSignatureStrategy.VERIFY_RANDAO:
        block = signed_block.message
        s = randao_signature_set(
            state,
            state_pubkey_getter(state),
            block.proposer_index,
            block.body.randao_reveal,
            preset,
            spec,
        )
        if not verify_signature_sets([s]):
            raise BlockProcessingSignatureError("randao signature check failed")

    block = signed_block.message
    if verified_proposer_index is not None:
        ctxt.proposer_index = verified_proposer_index
    process_block_header(
        state, block, preset, spec, ctxt.get_proposer_index(state)
    )
    if body_payload(block.body) is not None:
        # spec order: process_execution_payload runs right after the header
        # (if_execution_enabled); randao is checked against the PRE-randao
        # mix, hence before process_randao
        process_execution_payload(
            state, block.body, preset, spec, ctxt.notify_new_payload
        )
    process_randao(state, block.body, preset, spec)
    process_eth1_data(state, block.body.eth1_data, preset)
    process_operations(state, block.body, preset, spec, ctxt)
    if getattr(block.body, "sync_aggregate", None) is not None:
        process_sync_aggregate(
            state, block.body.sync_aggregate, preset, spec, verify=False,
            ctxt=ctxt,
        )
    return ctxt


# --- header / randao / eth1 -------------------------------------------------


def process_block_header(
    state, block, preset, spec, verified_proposer_index=None
):
    if block.slot != state.slot:
        raise BlockProcessingError("block slot != state slot")
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessingError("block not newer than latest header")
    if verified_proposer_index is None:
        from .per_slot import get_beacon_proposer_index

        verified_proposer_index = get_beacon_proposer_index(
            state, preset, spec
        )
    if block.proposer_index != verified_proposer_index:
        raise BlockProcessingError("wrong proposer index")
    if (
        bytes(block.parent_root)
        != state.latest_block_header.tree_hash_root()
    ):
        raise BlockProcessingError("parent root mismatch")
    if state.validators[block.proposer_index].slashed:
        raise BlockProcessingError("proposer is slashed")
    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=bytes(32),  # filled at the next slot transition
        body_root=block.body.tree_hash_root(),
    )


def process_randao(state, body, preset, spec):
    epoch = compute_epoch_at_slot(state.slot, preset)
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(state, epoch, preset),
            hash32(bytes(body.randao_reveal)),
        )
    )
    mixes = list(state.randao_mixes)
    mixes[epoch % preset.epochs_per_historical_vector] = mix
    state.randao_mixes = tuple(mixes)


def process_eth1_data(state, eth1_data, preset: Preset):
    votes = list(state.eth1_data_votes)
    votes.append(eth1_data)
    state.eth1_data_votes = tuple(votes)
    if votes.count(eth1_data) * 2 > preset.slots_per_eth1_voting_period:
        state.eth1_data = eth1_data


# --- operations -------------------------------------------------------------


def process_operations(state, body, preset, spec, ctxt: ConsensusContext):
    expected_deposits = min(
        preset.max_deposits,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    if len(body.deposits) != expected_deposits:
        raise BlockProcessingError(
            f"expected {expected_deposits} deposits, got {len(body.deposits)}"
        )
    for op in body.proposer_slashings:
        process_proposer_slashing(state, op, preset, spec, ctxt)
    for op in body.attester_slashings:
        process_attester_slashing(state, op, preset, spec, ctxt)
    for op in body.attestations:
        process_attestation(state, op, preset, spec, ctxt)
    for op in body.deposits:
        process_deposit(state, op, preset, spec, ctxt)
    for op in body.voluntary_exits:
        process_voluntary_exit(state, op, preset, spec)


def is_slashable_attestation_data(d1, d2) -> bool:
    double = d1 != d2 and d1.target.epoch == d2.target.epoch
    surround = (
        d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    )
    return double or surround


def slash_validator(
    state,
    index: int,
    preset,
    spec,
    whistleblower: int | None = None,
    ctxt=None,
):
    epoch = compute_epoch_at_slot(state.slot, preset)
    initiate_validator_exit(state, index, preset, spec)
    vals = list(state.validators)
    v = vals[index]
    v.slashed = True
    v.withdrawable_epoch = max(
        v.withdrawable_epoch, epoch + preset.epochs_per_slashings_vector
    )
    state.validators = tuple(vals)
    slashings = list(state.slashings)
    slashings[epoch % preset.epochs_per_slashings_vector] += v.effective_balance
    state.slashings = tuple(slashings)
    quotient = spec.min_slashing_penalty_quotient_for(state.fork_name)
    decrease_balance(state, index, v.effective_balance // quotient)

    proposer_index = (
        ctxt.get_proposer_index(state)
        if ctxt is not None
        else _proposer(state, preset, spec)
    )
    if whistleblower is None:
        whistleblower = proposer_index
    whistleblower_reward = (
        v.effective_balance // spec.whistleblower_reward_quotient
    )
    if state.fork_name == "phase0":
        proposer_reward = whistleblower_reward // spec.proposer_reward_quotient
    else:
        proposer_reward = (
            whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
        )
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower, whistleblower_reward - proposer_reward)


def process_proposer_slashing(state, slashing, preset, spec, ctxt=None):
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    if h1.slot != h2.slot:
        raise BlockProcessingError("proposer slashing: slots differ")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessingError("proposer slashing: proposers differ")
    if h1 == h2:
        raise BlockProcessingError("proposer slashing: headers identical")
    proposer = state.validators[h1.proposer_index]
    if not is_slashable_validator(
        proposer, compute_epoch_at_slot(state.slot, preset)
    ):
        raise BlockProcessingError("proposer not slashable")
    slash_validator(state, h1.proposer_index, preset, spec, ctxt=ctxt)


def process_attester_slashing(state, slashing, preset, spec, ctxt):
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not is_slashable_attestation_data(a1.data, a2.data):
        raise BlockProcessingError("attestations not slashable")
    for a in (a1, a2):
        if not _is_valid_indexed_attestation_structure(a, preset):
            raise BlockProcessingError("invalid indexed attestation")
    epoch = compute_epoch_at_slot(state.slot, preset)
    slashed_any = False
    common = set(a1.attesting_indices) & set(a2.attesting_indices)
    for index in sorted(common):
        if is_slashable_validator(state.validators[index], epoch):
            slash_validator(state, index, preset, spec, ctxt=ctxt)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessingError("attester slashing slashed nobody")


def _is_valid_indexed_attestation_structure(indexed, preset) -> bool:
    idx = list(indexed.attesting_indices)
    return bool(idx) and idx == sorted(idx) and len(set(idx)) == len(idx)


def process_attestation(state, attestation, preset, spec, ctxt):
    data = attestation.data
    current_epoch = compute_epoch_at_slot(state.slot, preset)
    previous_epoch = max(current_epoch - 1, 0)
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise BlockProcessingError("attestation target epoch out of range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, preset):
        raise BlockProcessingError("target epoch != slot epoch")
    if not (
        data.slot + spec.min_attestation_inclusion_delay
        <= state.slot
        <= data.slot + preset.slots_per_epoch
    ):
        raise BlockProcessingError("attestation outside inclusion window")
    cache = ctxt.committee_cache(state, data.target.epoch)
    if data.index >= cache.committees_per_slot:
        raise BlockProcessingError("committee index out of range")

    indexed = ctxt.get_indexed_attestation(state, attestation)
    if not _is_valid_indexed_attestation_structure(indexed, preset):
        raise BlockProcessingError("invalid indexed attestation")

    if data.target.epoch == current_epoch:
        justified = state.current_justified_checkpoint
    else:
        justified = state.previous_justified_checkpoint
    if data.source != justified:
        raise BlockProcessingError("attestation source != justified checkpoint")

    if state.fork_name == "phase0":
        pending = types_for(preset).PendingAttestation(
            aggregation_bits=attestation.aggregation_bits,
            data=data,
            inclusion_delay=state.slot - data.slot,
            proposer_index=ctxt.get_proposer_index(state),
        )
        if data.target.epoch == current_epoch:
            state.current_epoch_attestations = (
                *state.current_epoch_attestations,
                pending,
            )
        else:
            state.previous_epoch_attestations = (
                *state.previous_epoch_attestations,
                pending,
            )
    else:
        _process_attestation_altair(state, data, indexed, preset, spec, ctxt)


def _proposer(state, preset, spec):
    from .per_slot import get_beacon_proposer_index

    return get_beacon_proposer_index(state, preset, spec)


def _process_attestation_altair(state, data, indexed, preset, spec, ctxt):
    flags = get_attestation_participation_flag_indices(
        state, data, state.slot - data.slot, preset, spec
    )
    current_epoch = compute_epoch_at_slot(state.slot, preset)
    in_current = data.target.epoch == current_epoch
    participation = list(
        state.current_epoch_participation
        if in_current
        else state.previous_epoch_participation
    )
    base_per_inc = get_base_reward_per_increment(state, preset, spec)
    proposer_reward_numerator = 0
    for index in indexed.attesting_indices:
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in flags and not has_flag(
                participation[index], flag_index
            ):
                participation[index] = add_flag(participation[index], flag_index)
                proposer_reward_numerator += (
                    get_base_reward_altair(
                        state, index, base_per_inc, preset, spec
                    )
                    * weight
                )
    if in_current:
        state.current_epoch_participation = tuple(participation)
    else:
        state.previous_epoch_participation = tuple(participation)
    denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
        * WEIGHT_DENOMINATOR
        // PROPOSER_WEIGHT
    )
    increase_balance(
        state,
        ctxt.get_proposer_index(state),
        proposer_reward_numerator // denominator,
    )


def _verify_merkle_branch(leaf, branch, depth, index, root) -> bool:
    value = leaf
    for i in range(depth):
        sibling = bytes(branch[i])
        if (index >> i) & 1:
            value = hash32(sibling + value)
        else:
            value = hash32(value + sibling)
    return value == bytes(root)


def process_deposit(state, deposit, preset, spec, ctxt=None):
    if not _verify_merkle_branch(
        deposit.data.tree_hash_root(),
        deposit.proof,
        preset.deposit_contract_tree_depth + 1,
        state.eth1_deposit_index,
        state.eth1_data.deposit_root,
    ):
        raise BlockProcessingError("bad deposit merkle proof")
    state.eth1_deposit_index += 1
    apply_deposit(state, deposit.data, preset, spec, ctxt)


def apply_deposit(state, data, preset, spec, ctxt=None):
    pubkey = bytes(data.pubkey)
    if ctxt is not None:
        index = ctxt.pubkey_to_index(state, pubkey)
    else:
        pubkeys = [bytes(v.pubkey) for v in state.validators]
        index = pubkeys.index(pubkey) if pubkey in pubkeys else None
    if index is None:
        # new validator: proof-of-possession must verify, else ignore deposit
        try:
            s = deposit_signature_set(data, spec)
        except Exception:
            return
        if not verify_signature_sets([s]):
            return
        state.validators = (
            *state.validators,
            Validator(
                pubkey=pubkey,
                withdrawal_credentials=bytes(data.withdrawal_credentials),
                effective_balance=min(
                    data.amount - data.amount % spec.effective_balance_increment,
                    spec.max_effective_balance,
                ),
                slashed=False,
                activation_eligibility_epoch=FAR_FUTURE_EPOCH,
                activation_epoch=FAR_FUTURE_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            ),
        )
        state.balances = (*state.balances, data.amount)
        if state.fork_name != "phase0":
            state.previous_epoch_participation = (
                *state.previous_epoch_participation,
                0,
            )
            state.current_epoch_participation = (
                *state.current_epoch_participation,
                0,
            )
            state.inactivity_scores = (*state.inactivity_scores, 0)
    else:
        increase_balance(state, index, data.amount)


def initiate_validator_exit(state, index: int, preset, spec):
    vals = list(state.validators)
    if vals[index].exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [
        v.exit_epoch for v in vals if v.exit_epoch != FAR_FUTURE_EPOCH
    ]
    current_epoch = compute_epoch_at_slot(state.slot, preset)
    exit_queue_epoch = max(
        exit_epochs
        + [compute_activation_exit_epoch(current_epoch, spec)]
    )
    exit_queue_churn = sum(
        1 for v in vals if v.exit_epoch == exit_queue_epoch
    )
    active = sum(
        1 for v in vals if is_active_validator(v, current_epoch)
    )
    churn_limit = max(
        spec.min_per_epoch_churn_limit, active // spec.churn_limit_quotient
    )
    if exit_queue_churn >= churn_limit:
        exit_queue_epoch += 1
    v = vals[index]
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = (
        exit_queue_epoch + spec.min_validator_withdrawability_delay
    )
    state.validators = tuple(vals)


def process_voluntary_exit(state, signed_exit, preset, spec):
    exit_msg = signed_exit.message
    current_epoch = compute_epoch_at_slot(state.slot, preset)
    v = state.validators[exit_msg.validator_index]
    if not is_active_validator(v, current_epoch):
        raise BlockProcessingError("exiting validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessingError("validator already exiting")
    if current_epoch < exit_msg.epoch:
        raise BlockProcessingError("exit epoch in the future")
    if current_epoch < v.activation_epoch + spec.shard_committee_period:
        raise BlockProcessingError("validator too young to exit")
    initiate_validator_exit(state, exit_msg.validator_index, preset, spec)


# --- sync aggregate (altair) ------------------------------------------------


def process_sync_aggregate(
    state, sync_aggregate, preset, spec, verify=True, ctxt=None
):
    if verify:
        root = get_block_root_at_slot(
            state, max(state.slot - 1, 0), preset
        )
        s = sync_aggregate_signature_set(
            state,
            None,
            sync_aggregate,
            state.slot,
            root,
            list(state.current_sync_committee.pubkeys),
            preset,
            spec,
        )
        if s is not None and not verify_signature_sets([s]):
            raise BlockProcessingSignatureError("sync aggregate signature")

    total_active_increments = (
        get_total_active_balance(state, preset, spec)
        // spec.effective_balance_increment
    )
    base_per_inc = get_base_reward_per_increment(state, preset, spec)
    total_base_rewards = base_per_inc * total_active_increments
    max_participant_rewards = (
        total_base_rewards
        * SYNC_REWARD_WEIGHT
        // WEIGHT_DENOMINATOR
        // preset.slots_per_epoch
    )
    participant_reward = max_participant_rewards // preset.sync_committee_size
    proposer_reward = (
        participant_reward
        * PROPOSER_WEIGHT
        // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )

    pubkey_to_index = {
        bytes(v.pubkey): i for i, v in enumerate(state.validators)
    }
    proposer = (
        ctxt.get_proposer_index(state)
        if ctxt is not None
        else _proposer(state, preset, spec)
    )
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    for bit, pk in zip(
        sync_aggregate.sync_committee_bits,
        state.current_sync_committee.pubkeys,
    ):
        index = pubkey_to_index[bytes(pk)]
        if bit:
            rewards[index] += participant_reward
            rewards[proposer] += proposer_reward
        else:
            penalties[index] += participant_reward
    apply_balance_deltas(state, rewards, penalties)


# --- execution payload (bellatrix) ------------------------------------------
# Reference: consensus/state_processing per_block_processing's
# process_execution_payload + is_merge_transition_* helpers; the engine
# round trip mirrors execution_layer/src/lib.rs notify_new_payload.


def is_merge_transition_complete(state) -> bool:
    hdr = getattr(state, "latest_execution_payload_header", None)
    if hdr is None:
        return False
    return any(bytes(hdr.block_hash))


_DEFAULT_PAYLOAD_ROOTS: dict[type, bytes] = {}


def _is_default_payload(payload) -> bool:
    cls = type(payload)
    root = _DEFAULT_PAYLOAD_ROOTS.get(cls)
    if root is None:
        root = _DEFAULT_PAYLOAD_ROOTS[cls] = cls().tree_hash_root()
    return payload.tree_hash_root() == root


def body_payload(body):
    """The body's execution payload OR payload header (blinded blocks
    carry the header only -- the reference's AbstractExecPayload seam over
    FullPayload/BlindedPayload, consensus/types/src/payload.rs)."""
    payload = getattr(body, "execution_payload", None)
    if payload is not None:
        return payload
    return getattr(body, "execution_payload_header", None)


def is_merge_transition_block(state, body) -> bool:
    payload = body_payload(body)
    if payload is None:
        return False
    return not is_merge_transition_complete(state) and not _is_default_payload(
        payload
    )


def is_execution_enabled(state, body) -> bool:
    return is_merge_transition_block(state, body) or (
        is_merge_transition_complete(state) and body_payload(body) is not None
    )


def compute_timestamp_at_slot(state, slot: int, spec) -> int:
    return state.genesis_time + slot * spec.seconds_per_slot


def payload_to_header(payload, preset: Preset):
    """ExecutionPayload -> ExecutionPayloadHeader (transactions list
    replaced by its hash tree root)."""
    from ..types import types_for

    t = types_for(preset)
    kwargs = {
        name: getattr(payload, name)
        for name, _ in payload.ssz_fields
        if name != "transactions"
    }
    tx_field = dict(payload.ssz_fields)["transactions"]
    kwargs["transactions_root"] = tx_field.hash_tree_root(payload.transactions)
    return t.ExecutionPayloadHeader(**kwargs)


def process_execution_payload(
    state, body, preset: Preset, spec, notify_new_payload=None
):
    """Spec process_execution_payload. `notify_new_payload` is the engine
    hook (payload -> bool or PayloadVerificationStatus); None skips the
    engine round trip (the NoVerification analogue used in replay)."""
    from ..types import compute_epoch_at_slot as _epoch_at
    from ..types.helpers import get_randao_mix

    payload = body_payload(body)
    blinded = not hasattr(payload, "transactions")
    if not is_execution_enabled(state, body):
        # pre-merge: payload must be the default one (tree-root compare:
        # SSZ offsets make even a default payload nonzero on the wire)
        if not _is_default_payload(payload):
            raise BlockProcessingError(
                "execution payload present before the merge transition"
            )
        return
    if is_merge_transition_complete(state):
        if bytes(payload.parent_hash) != bytes(
            state.latest_execution_payload_header.block_hash
        ):
            raise BlockProcessingError("payload parent hash mismatch")
    epoch = _epoch_at(state.slot, preset)
    if bytes(payload.prev_randao) != bytes(
        get_randao_mix(state, epoch, preset)
    ):
        raise BlockProcessingError("payload prev_randao mismatch")
    if int(payload.timestamp) != compute_timestamp_at_slot(
        state, state.slot, spec
    ):
        raise BlockProcessingError("payload timestamp mismatch")
    if blinded:
        # blinded processing: the header IS the commitment; there is no
        # payload to send to an engine (the builder reveals it post-signing)
        from ..types import types_for

        t = types_for(preset)
        state.latest_execution_payload_header = t.ExecutionPayloadHeader(
            **{name: getattr(payload, name) for name, _ in payload.ssz_fields}
        )
        return
    if notify_new_payload is not None:
        ok = notify_new_payload(payload)
        if ok is False:
            raise BlockProcessingError("execution engine rejected payload")
    state.latest_execution_payload_header = payload_to_header(payload, preset)

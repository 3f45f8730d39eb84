"""Signature-set builders: one function per signed consensus message kind
(reference consensus/state_processing/src/per_block_processing/
signature_sets.rs:74-573). Every builder returns a `SignatureSet`
{signature, pubkeys, signing_root} ready for the batch verifier -- the
builders never verify anything themselves.

Pubkeys are resolved through a `get_pubkey(validator_index) -> PublicKey`
closure so callers can plug the device-resident pubkey table (the
reference threads its ValidatorPubkeyCache the same way,
block_verification.rs:1858-1890).
"""

from __future__ import annotations

import functools

from ..crypto.bls.api import PublicKey, Signature, SignatureSet
from ..types import (
    ChainSpec,
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
    compute_domain,
    compute_epoch_at_slot,
    compute_signing_root,
    get_domain,
)
from ..types.containers import DepositMessage, SigningData
from ..types.presets import Preset
from ..ssz import uint64


class SignatureSetError(ValueError):
    pass


@functools.lru_cache(maxsize=65536)
def _decompress(pubkey_bytes: bytes) -> PublicKey:
    return PublicKey.from_bytes(pubkey_bytes)


def state_pubkey_getter(state):
    """Default get_pubkey closure: decompress from the state registry with
    an LRU (the cache-less fallback path; production uses PubkeyTable)."""

    def get_pubkey(index: int) -> PublicKey:
        if index >= len(state.validators):
            raise SignatureSetError(f"unknown validator index {index}")
        return _decompress(bytes(state.validators[index].pubkey))

    return get_pubkey


def _sig(signature_bytes: bytes) -> Signature:
    try:
        return Signature.from_bytes(bytes(signature_bytes))
    except Exception as e:
        raise SignatureSetError(f"malformed signature: {e}") from None


# --- block proposal & randao (signature_sets.rs:74-178) --------------------


def block_proposal_signature_set(
    state, get_pubkey, signed_block, preset: Preset, spec: ChainSpec
) -> SignatureSet:
    block = signed_block.message
    epoch = compute_epoch_at_slot(block.slot, preset)
    domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch, preset)
    root = compute_signing_root(block, domain)
    return SignatureSet.single_pubkey(
        _sig(signed_block.signature), get_pubkey(block.proposer_index), root
    )


def randao_signature_set(
    state, get_pubkey, proposer_index: int, randao_reveal, preset, spec
) -> SignatureSet:
    epoch = compute_epoch_at_slot(state.slot, preset)
    domain = get_domain(state, DOMAIN_RANDAO, epoch, preset)
    root = SigningData(
        object_root=uint64.hash_tree_root(epoch), domain=domain
    ).tree_hash_root()
    return SignatureSet.single_pubkey(
        _sig(randao_reveal), get_pubkey(proposer_index), root
    )


# --- slashings (signature_sets.rs:180-260) ---------------------------------


def proposer_slashing_signature_sets(
    state, get_pubkey, slashing, preset, spec
) -> list[SignatureSet]:
    out = []
    for signed_header in (slashing.signed_header_1, slashing.signed_header_2):
        header = signed_header.message
        epoch = compute_epoch_at_slot(header.slot, preset)
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch, preset)
        root = compute_signing_root(header, domain)
        out.append(
            SignatureSet.single_pubkey(
                _sig(signed_header.signature),
                get_pubkey(header.proposer_index),
                root,
            )
        )
    return out


def indexed_attestation_signature_set(
    state, get_pubkey, indexed_attestation, preset, spec
) -> SignatureSet:
    data = indexed_attestation.data
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, data.target.epoch, preset)
    root = compute_signing_root(data, domain)
    pubkeys = [get_pubkey(i) for i in indexed_attestation.attesting_indices]
    if not pubkeys:
        raise SignatureSetError("indexed attestation with no attesters")
    return SignatureSet.multiple_pubkeys(
        _sig(indexed_attestation.signature), pubkeys, root
    )


def attester_slashing_signature_sets(
    state, get_pubkey, slashing, preset, spec
) -> list[SignatureSet]:
    return [
        indexed_attestation_signature_set(
            state, get_pubkey, slashing.attestation_1, preset, spec
        ),
        indexed_attestation_signature_set(
            state, get_pubkey, slashing.attestation_2, preset, spec
        ),
    ]


# --- deposits (signature_sets.rs:262-300) ----------------------------------


def deposit_signature_set(deposit_data, spec: ChainSpec) -> SignatureSet:
    """Deposits sign with the genesis-version domain and NO
    genesis_validators_root (they predate the state)."""
    message = DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    domain = compute_domain(
        DOMAIN_DEPOSIT, spec.genesis_fork_version, bytes(32)
    )
    root = compute_signing_root(message, domain)
    pubkey = PublicKey.from_bytes(bytes(deposit_data.pubkey))
    return SignatureSet.single_pubkey(_sig(deposit_data.signature), pubkey, root)


# --- exits (signature_sets.rs:302-330) -------------------------------------


def exit_signature_set(
    state, get_pubkey, signed_exit, preset, spec
) -> SignatureSet:
    exit_msg = signed_exit.message
    domain = get_domain(state, DOMAIN_VOLUNTARY_EXIT, exit_msg.epoch, preset)
    root = compute_signing_root(exit_msg, domain)
    return SignatureSet.single_pubkey(
        _sig(signed_exit.signature), get_pubkey(exit_msg.validator_index), root
    )


# --- aggregate and proof (signature_sets.rs:332-420) -----------------------


def selection_proof_signature_set(
    state, get_pubkey, signed_aggregate, preset, spec
) -> SignatureSet:
    msg = signed_aggregate.message
    slot = msg.aggregate.data.slot
    domain = get_domain(
        state,
        DOMAIN_SELECTION_PROOF,
        compute_epoch_at_slot(slot, preset),
        preset,
    )
    root = SigningData(
        object_root=uint64.hash_tree_root(slot), domain=domain
    ).tree_hash_root()
    return SignatureSet.single_pubkey(
        _sig(msg.selection_proof), get_pubkey(msg.aggregator_index), root
    )


def aggregate_and_proof_signature_set(
    state, get_pubkey, signed_aggregate, preset, spec
) -> SignatureSet:
    msg = signed_aggregate.message
    epoch = compute_epoch_at_slot(msg.aggregate.data.slot, preset)
    domain = get_domain(state, DOMAIN_AGGREGATE_AND_PROOF, epoch, preset)
    root = compute_signing_root(msg, domain)
    return SignatureSet.single_pubkey(
        _sig(signed_aggregate.signature), get_pubkey(msg.aggregator_index), root
    )


# --- sync committee (signature_sets.rs:422-573) ----------------------------


def sync_committee_message_set(
    state, get_pubkey, message, preset, spec
) -> SignatureSet:
    epoch = compute_epoch_at_slot(message.slot, preset)
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch, preset)
    root = SigningData(
        object_root=bytes(message.beacon_block_root), domain=domain
    ).tree_hash_root()
    return SignatureSet.single_pubkey(
        _sig(message.signature), get_pubkey(message.validator_index), root
    )


def sync_aggregate_signature_set(
    state,
    get_pubkey_bytes,
    sync_aggregate,
    slot: int,
    beacon_block_root: bytes,
    committee_pubkeys: list[bytes],
    preset,
    spec,
) -> SignatureSet | None:
    """Set for a block's sync aggregate: participants are the bit-selected
    subset of the CURRENT sync committee. Signs the PREVIOUS slot's block
    root at the previous slot's epoch domain. Returns None for the empty
    aggregate with the infinity signature (valid by spec)."""
    bits = list(sync_aggregate.sync_committee_bits)
    participants = [
        pk for pk, bit in zip(committee_pubkeys, bits) if bit
    ]
    sig = _sig(sync_aggregate.sync_committee_signature)
    if not participants:
        if sig.is_infinity():
            return None
        raise SignatureSetError("non-infinity signature with no participants")
    prev_slot = max(slot - 1, 0)
    epoch = compute_epoch_at_slot(prev_slot, preset)
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch, preset)
    root = SigningData(
        object_root=bytes(beacon_block_root), domain=domain
    ).tree_hash_root()
    resolve = get_pubkey_bytes or _decompress
    pubkeys = [resolve(bytes(pk)) for pk in participants]
    return SignatureSet.multiple_pubkeys(sig, pubkeys, root)


def sync_selection_proof_signature_set(
    state, get_pubkey, signed_contribution, preset, spec
) -> SignatureSet:
    from ..types.containers import SyncAggregatorSelectionData

    msg = signed_contribution.message
    contribution = msg.contribution
    epoch = compute_epoch_at_slot(contribution.slot, preset)
    domain = get_domain(
        state, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch, preset
    )
    data = SyncAggregatorSelectionData(
        slot=contribution.slot,
        subcommittee_index=contribution.subcommittee_index,
    )
    root = compute_signing_root(data, domain)
    return SignatureSet.single_pubkey(
        _sig(msg.selection_proof), get_pubkey(msg.aggregator_index), root
    )


def contribution_and_proof_signature_set(
    state, get_pubkey, signed_contribution, preset, spec
) -> SignatureSet:
    msg = signed_contribution.message
    epoch = compute_epoch_at_slot(msg.contribution.slot, preset)
    domain = get_domain(state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch, preset)
    root = compute_signing_root(msg, domain)
    return SignatureSet.single_pubkey(
        _sig(signed_contribution.signature), get_pubkey(msg.aggregator_index), root
    )


def sync_committee_contribution_signature_set(
    state, signed_contribution, subcommittee_pubkeys, preset, spec,
    resolve_pubkey=None,
) -> SignatureSet | None:
    contribution = signed_contribution.message.contribution
    bits = list(contribution.aggregation_bits)
    participants = [
        pk for pk, bit in zip(subcommittee_pubkeys, bits) if bit
    ]
    sig = _sig(contribution.signature)
    if not participants:
        if sig.is_infinity():
            return None
        raise SignatureSetError("non-infinity signature with no participants")
    epoch = compute_epoch_at_slot(contribution.slot, preset)
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch, preset)
    root = SigningData(
        object_root=bytes(contribution.beacon_block_root), domain=domain
    ).tree_hash_root()
    resolve = resolve_pubkey or _decompress
    pubkeys = [resolve(bytes(pk)) for pk in participants]
    return SignatureSet.multiple_pubkeys(sig, pubkeys, root)

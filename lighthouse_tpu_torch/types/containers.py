"""Consensus containers, phase0 + altair (reference consensus/types/src/*).

Container classes are generated per compile-time preset by `types_for(preset)`
(the Python equivalent of the reference's `EthSpec` type parameter,
eth_spec.rs:365 -- list limits and vector lengths are baked into the SSZ
descriptors). Multi-fork variants (the reference's superstruct enums,
beacon_state.rs / beacon_block.rs) are separate classes sharing field names,
plus `fork_name` class attributes for dispatch.

NOTE: no `from __future__ import annotations` here -- the @container
decorator consumes annotations as live SSZ descriptors, not strings.
"""

import functools
from types import SimpleNamespace

from ..ssz import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    List,
    Vector,
    boolean,
    container,
    uint8,
    uint64,
    uint256,
)
from .presets import Preset

DEPOSIT_CONTRACT_TREE_DEPTH = 32
JUSTIFICATION_BITS_LENGTH = 4


@container
class Fork:
    previous_version: Bytes4
    current_version: Bytes4
    epoch: uint64


@container
class ForkData:
    current_version: Bytes4
    genesis_validators_root: Bytes32


@container
class Checkpoint:
    epoch: uint64
    root: Bytes32


@container
class SigningData:
    object_root: Bytes32
    domain: Bytes32


@container
class Validator:
    pubkey: Bytes48
    withdrawal_credentials: Bytes32
    effective_balance: uint64
    slashed: boolean
    activation_eligibility_epoch: uint64
    activation_epoch: uint64
    exit_epoch: uint64
    withdrawable_epoch: uint64


@container
class AttestationData:
    slot: uint64
    index: uint64
    beacon_block_root: Bytes32
    source: Checkpoint.ssz_type
    target: Checkpoint.ssz_type


@container
class Eth1Data:
    deposit_root: Bytes32
    deposit_count: uint64
    block_hash: Bytes32


@container
class DepositMessage:
    pubkey: Bytes48
    withdrawal_credentials: Bytes32
    amount: uint64


def header_from_block(message) -> "BeaconBlockHeader":
    """BeaconBlock(.message) -> its header (body replaced by its root) --
    shared by the slasher feed, light-client data, and header routes."""
    return BeaconBlockHeader(
        slot=message.slot,
        proposer_index=message.proposer_index,
        parent_root=bytes(message.parent_root),
        state_root=bytes(message.state_root),
        body_root=message.body.tree_hash_root(),
    )


@container
class ValidatorRegistrationV1:
    """Builder-network validator registration (builder-specs; reference
    consensus/types/src/validator_registration_data.rs), signed with the
    application builder domain by the VC's preparation service."""

    fee_recipient: Bytes20
    gas_limit: uint64
    timestamp: uint64
    pubkey: Bytes48


@container
class SignedValidatorRegistration:
    message: ValidatorRegistrationV1.ssz_type
    signature: Bytes96


@container
class DepositData:
    pubkey: Bytes48
    withdrawal_credentials: Bytes32
    amount: uint64
    signature: Bytes96


@container
class Deposit:
    proof: Vector(Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)
    data: DepositData.ssz_type


@container
class VoluntaryExit:
    epoch: uint64
    validator_index: uint64


@container
class SignedVoluntaryExit:
    message: VoluntaryExit.ssz_type
    signature: Bytes96


@container
class BeaconBlockHeader:
    slot: uint64
    proposer_index: uint64
    parent_root: Bytes32
    state_root: Bytes32
    body_root: Bytes32


@container
class SignedBeaconBlockHeader:
    message: BeaconBlockHeader.ssz_type
    signature: Bytes96


@container
class ProposerSlashing:
    signed_header_1: SignedBeaconBlockHeader.ssz_type
    signed_header_2: SignedBeaconBlockHeader.ssz_type


@container
class SyncAggregatorSelectionData:
    slot: uint64
    subcommittee_index: uint64


@container
class SyncCommitteeMessage:
    slot: uint64
    beacon_block_root: Bytes32
    validator_index: uint64
    signature: Bytes96


@functools.lru_cache(maxsize=None)
def types_for(preset: Preset) -> SimpleNamespace:
    """Generate the preset-sized containers (IndexedAttestation through
    BeaconState). Cached: class identity is stable per preset."""

    @container
    class IndexedAttestation:
        attesting_indices: List(uint64, preset.max_validators_per_committee)
        data: AttestationData.ssz_type
        signature: Bytes96

    @container
    class AttesterSlashing:
        attestation_1: IndexedAttestation.ssz_type
        attestation_2: IndexedAttestation.ssz_type

    @container
    class Attestation:
        aggregation_bits: Bitlist(preset.max_validators_per_committee)
        data: AttestationData.ssz_type
        signature: Bytes96

    @container
    class PendingAttestation:
        aggregation_bits: Bitlist(preset.max_validators_per_committee)
        data: AttestationData.ssz_type
        inclusion_delay: uint64
        proposer_index: uint64

    @container
    class AggregateAndProof:
        aggregator_index: uint64
        aggregate: Attestation.ssz_type
        selection_proof: Bytes96

    @container
    class SignedAggregateAndProof:
        message: AggregateAndProof.ssz_type
        signature: Bytes96

    @container
    class SyncAggregate:
        sync_committee_bits: Bitvector(preset.sync_committee_size)
        sync_committee_signature: Bytes96

    @container
    class SyncCommittee:
        pubkeys: Vector(Bytes48, preset.sync_committee_size)
        aggregate_pubkey: Bytes48

    @container
    class SyncCommitteeContribution:
        slot: uint64
        beacon_block_root: Bytes32
        subcommittee_index: uint64
        aggregation_bits: Bitvector(preset.sync_subcommittee_size)
        signature: Bytes96

    @container
    class ContributionAndProof:
        aggregator_index: uint64
        contribution: SyncCommitteeContribution.ssz_type
        selection_proof: Bytes96

    @container
    class SignedContributionAndProof:
        message: ContributionAndProof.ssz_type
        signature: Bytes96

    @container
    class HistoricalBatch:
        block_roots: Vector(Bytes32, preset.slots_per_historical_root)
        state_roots: Vector(Bytes32, preset.slots_per_historical_root)

    # -- bellatrix execution payloads (reference consensus/types/src/
    #    execution_payload.rs + execution_payload_header.rs) ---------------

    @container
    class ExecutionPayload:
        parent_hash: Bytes32
        fee_recipient: Bytes20
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector(preset.bytes_per_logs_bloom)
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList(preset.max_extra_data_bytes)
        base_fee_per_gas: uint256
        block_hash: Bytes32
        transactions: List(
            ByteList(preset.max_bytes_per_transaction),
            preset.max_transactions_per_payload,
        )

    @container
    class ExecutionPayloadHeader:
        parent_hash: Bytes32
        fee_recipient: Bytes20
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector(preset.bytes_per_logs_bloom)
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList(preset.max_extra_data_bytes)
        base_fee_per_gas: uint256
        block_hash: Bytes32
        transactions_root: Bytes32

    @container
    class BeaconBlockBody:
        randao_reveal: Bytes96
        eth1_data: Eth1Data.ssz_type
        graffiti: Bytes32
        proposer_slashings: List(
            ProposerSlashing.ssz_type, preset.max_proposer_slashings
        )
        attester_slashings: List(
            AttesterSlashing.ssz_type, preset.max_attester_slashings
        )
        attestations: List(Attestation.ssz_type, preset.max_attestations)
        deposits: List(Deposit.ssz_type, preset.max_deposits)
        voluntary_exits: List(
            SignedVoluntaryExit.ssz_type, preset.max_voluntary_exits
        )

    BeaconBlockBody.fork_name = "phase0"

    @container
    class BeaconBlockBodyAltair:
        randao_reveal: Bytes96
        eth1_data: Eth1Data.ssz_type
        graffiti: Bytes32
        proposer_slashings: List(
            ProposerSlashing.ssz_type, preset.max_proposer_slashings
        )
        attester_slashings: List(
            AttesterSlashing.ssz_type, preset.max_attester_slashings
        )
        attestations: List(Attestation.ssz_type, preset.max_attestations)
        deposits: List(Deposit.ssz_type, preset.max_deposits)
        voluntary_exits: List(
            SignedVoluntaryExit.ssz_type, preset.max_voluntary_exits
        )
        sync_aggregate: SyncAggregate.ssz_type

    BeaconBlockBodyAltair.fork_name = "altair"

    @container
    class BeaconBlockBodyBellatrix:
        randao_reveal: Bytes96
        eth1_data: Eth1Data.ssz_type
        graffiti: Bytes32
        proposer_slashings: List(
            ProposerSlashing.ssz_type, preset.max_proposer_slashings
        )
        attester_slashings: List(
            AttesterSlashing.ssz_type, preset.max_attester_slashings
        )
        attestations: List(Attestation.ssz_type, preset.max_attestations)
        deposits: List(Deposit.ssz_type, preset.max_deposits)
        voluntary_exits: List(
            SignedVoluntaryExit.ssz_type, preset.max_voluntary_exits
        )
        sync_aggregate: SyncAggregate.ssz_type
        execution_payload: ExecutionPayload.ssz_type

    BeaconBlockBodyBellatrix.fork_name = "bellatrix"

    def _block_classes(body_cls, fork):
        @container
        class BeaconBlock:
            slot: uint64
            proposer_index: uint64
            parent_root: Bytes32
            state_root: Bytes32
            body: body_cls.ssz_type

        @container
        class SignedBeaconBlock:
            message: BeaconBlock.ssz_type
            signature: Bytes96

        BeaconBlock.fork_name = fork
        SignedBeaconBlock.fork_name = fork
        return BeaconBlock, SignedBeaconBlock

    BeaconBlock, SignedBeaconBlock = _block_classes(BeaconBlockBody, "phase0")
    BeaconBlockAltair, SignedBeaconBlockAltair = _block_classes(
        BeaconBlockBodyAltair, "altair"
    )
    BeaconBlockBellatrix, SignedBeaconBlockBellatrix = _block_classes(
        BeaconBlockBodyBellatrix, "bellatrix"
    )

    # -- blinded blocks + builder bids (mev-boost flow; reference
    # consensus/types/src/{blinded_payload.rs,builder_bid.rs} via the
    # BeaconBlockBody superstruct's BlindedPayload variant) ----------------

    @container
    class BlindedBeaconBlockBody:
        randao_reveal: Bytes96
        eth1_data: Eth1Data.ssz_type
        graffiti: Bytes32
        proposer_slashings: List(
            ProposerSlashing.ssz_type, preset.max_proposer_slashings
        )
        attester_slashings: List(
            AttesterSlashing.ssz_type, preset.max_attester_slashings
        )
        attestations: List(Attestation.ssz_type, preset.max_attestations)
        deposits: List(Deposit.ssz_type, preset.max_deposits)
        voluntary_exits: List(
            SignedVoluntaryExit.ssz_type, preset.max_voluntary_exits
        )
        sync_aggregate: SyncAggregate.ssz_type
        execution_payload_header: ExecutionPayloadHeader.ssz_type

    BlindedBeaconBlockBody.fork_name = "bellatrix"

    BlindedBeaconBlock, SignedBlindedBeaconBlock = _block_classes(
        BlindedBeaconBlockBody, "bellatrix"
    )

    @container
    class BuilderBid:
        header: ExecutionPayloadHeader.ssz_type
        value: uint256
        pubkey: Bytes48

    @container
    class SignedBuilderBid:
        message: BuilderBid.ssz_type
        signature: Bytes96

    _state_common = dict(
        genesis_time=uint64,
        genesis_validators_root=Bytes32,
        slot=uint64,
        fork=Fork.ssz_type,
        latest_block_header=BeaconBlockHeader.ssz_type,
        block_roots=Vector(Bytes32, preset.slots_per_historical_root),
        state_roots=Vector(Bytes32, preset.slots_per_historical_root),
        historical_roots=List(Bytes32, preset.historical_roots_limit),
        eth1_data=Eth1Data.ssz_type,
        eth1_data_votes=List(
            Eth1Data.ssz_type, preset.slots_per_eth1_voting_period
        ),
        eth1_deposit_index=uint64,
        validators=List(Validator.ssz_type, preset.validator_registry_limit),
        balances=List(uint64, preset.validator_registry_limit),
        randao_mixes=Vector(Bytes32, preset.epochs_per_historical_vector),
        slashings=Vector(uint64, preset.epochs_per_slashings_vector),
    )

    def _make_state(name, fork, extra_fields):
        ns = {"__annotations__": {**_state_common, **extra_fields}}
        cls = type(name, (), ns)
        cls = container(cls)
        cls.fork_name = fork
        return cls

    BeaconState = _make_state(
        "BeaconState",
        "phase0",
        dict(
            previous_epoch_attestations=List(
                PendingAttestation.ssz_type,
                preset.max_attestations * preset.slots_per_epoch,
            ),
            current_epoch_attestations=List(
                PendingAttestation.ssz_type,
                preset.max_attestations * preset.slots_per_epoch,
            ),
            justification_bits=Bitvector(JUSTIFICATION_BITS_LENGTH),
            previous_justified_checkpoint=Checkpoint.ssz_type,
            current_justified_checkpoint=Checkpoint.ssz_type,
            finalized_checkpoint=Checkpoint.ssz_type,
        ),
    )

    _altair_state_extra = dict(
        previous_epoch_participation=List(
            uint8, preset.validator_registry_limit
        ),
        current_epoch_participation=List(
            uint8, preset.validator_registry_limit
        ),
        justification_bits=Bitvector(JUSTIFICATION_BITS_LENGTH),
        previous_justified_checkpoint=Checkpoint.ssz_type,
        current_justified_checkpoint=Checkpoint.ssz_type,
        finalized_checkpoint=Checkpoint.ssz_type,
        inactivity_scores=List(uint64, preset.validator_registry_limit),
        current_sync_committee=SyncCommittee.ssz_type,
        next_sync_committee=SyncCommittee.ssz_type,
    )

    BeaconStateAltair = _make_state(
        "BeaconStateAltair", "altair", _altair_state_extra
    )

    BeaconStateBellatrix = _make_state(
        "BeaconStateBellatrix",
        "bellatrix",
        dict(
            **_altair_state_extra,
            latest_execution_payload_header=ExecutionPayloadHeader.ssz_type,
        ),
    )

    return SimpleNamespace(
        preset=preset,
        IndexedAttestation=IndexedAttestation,
        AttesterSlashing=AttesterSlashing,
        Attestation=Attestation,
        PendingAttestation=PendingAttestation,
        AggregateAndProof=AggregateAndProof,
        SignedAggregateAndProof=SignedAggregateAndProof,
        SyncAggregate=SyncAggregate,
        SyncCommittee=SyncCommittee,
        SyncCommitteeContribution=SyncCommitteeContribution,
        ContributionAndProof=ContributionAndProof,
        SignedContributionAndProof=SignedContributionAndProof,
        HistoricalBatch=HistoricalBatch,
        BeaconBlockBody=BeaconBlockBody,
        BeaconBlockBodyAltair=BeaconBlockBodyAltair,
        BeaconBlock=BeaconBlock,
        SignedBeaconBlock=SignedBeaconBlock,
        BeaconBlockAltair=BeaconBlockAltair,
        SignedBeaconBlockAltair=SignedBeaconBlockAltair,
        ExecutionPayload=ExecutionPayload,
        ExecutionPayloadHeader=ExecutionPayloadHeader,
        BeaconBlockBodyBellatrix=BeaconBlockBodyBellatrix,
        BeaconBlockBellatrix=BeaconBlockBellatrix,
        SignedBeaconBlockBellatrix=SignedBeaconBlockBellatrix,
        BlindedBeaconBlockBody=BlindedBeaconBlockBody,
        BlindedBeaconBlock=BlindedBeaconBlock,
        SignedBlindedBeaconBlock=SignedBlindedBeaconBlock,
        BuilderBid=BuilderBid,
        SignedBuilderBid=SignedBuilderBid,
        BeaconState=BeaconState,
        BeaconStateAltair=BeaconStateAltair,
        BeaconStateBellatrix=BeaconStateBellatrix,
    )


def block_classes_for(t: SimpleNamespace, fork: str):
    """(BeaconBlock, SignedBeaconBlock, BeaconBlockBody) for a fork name."""
    if fork == "phase0":
        return t.BeaconBlock, t.SignedBeaconBlock, t.BeaconBlockBody
    if fork == "altair":
        return t.BeaconBlockAltair, t.SignedBeaconBlockAltair, t.BeaconBlockBodyAltair
    if fork == "bellatrix":
        return (
            t.BeaconBlockBellatrix,
            t.SignedBeaconBlockBellatrix,
            t.BeaconBlockBodyBellatrix,
        )
    raise ValueError(f"unsupported fork {fork!r}")


def state_class_for(t: SimpleNamespace, fork: str):
    if fork == "phase0":
        return t.BeaconState
    if fork == "altair":
        return t.BeaconStateAltair
    if fork == "bellatrix":
        return t.BeaconStateBellatrix
    raise ValueError(f"unsupported fork {fork!r}")


def decode_state_any_fork(ssz_bytes: bytes, preset: Preset):
    """Decode a BeaconState of unknown fork by trying newest-first (the
    reference sniffs the fork from the state's slot via superstruct;
    SSZ layouts differ enough that exactly one variant decodes)."""
    t = types_for(preset)
    last_err = None
    for fork in ("bellatrix", "altair", "phase0"):
        try:
            return state_class_for(t, fork).from_ssz_bytes(ssz_bytes)
        except Exception as e:  # noqa: BLE001 -- wrong-fork decode fails
            last_err = e
    raise ValueError(f"undecodable BeaconState: {last_err}")


def decode_block_any_fork(ssz_bytes: bytes, preset: Preset):
    """Decode a SignedBeaconBlock of unknown fork, newest-first."""
    t = types_for(preset)
    last_err = None
    for fork in ("bellatrix", "altair", "phase0"):
        try:
            return block_classes_for(t, fork)[1].from_ssz_bytes(ssz_bytes)
        except Exception as e:  # noqa: BLE001
            last_err = e
    raise ValueError(f"undecodable SignedBeaconBlock: {last_err}")

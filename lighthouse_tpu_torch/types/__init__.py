"""Consensus type system (reference consensus/types, SURVEY.md section 2.2):
compile-time presets, runtime ChainSpec, SSZ containers for phase0+altair,
spec helpers, committee cache, interop keys/genesis."""

from .chain_spec import (  # noqa: F401
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
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    GENESIS_SLOT,
    ChainSpec,
)
from .committee_cache import CommitteeCache  # noqa: F401
from .containers import (  # noqa: F401
    AttestationData,
    BeaconBlockHeader,
    Checkpoint,
    Deposit,
    DepositData,
    DepositMessage,
    Eth1Data,
    Fork,
    ForkData,
    ProposerSlashing,
    SignedBeaconBlockHeader,
    SignedVoluntaryExit,
    SigningData,
    SyncCommitteeMessage,
    Validator,
    VoluntaryExit,
    block_classes_for,
    decode_block_any_fork,
    decode_state_any_fork,
    state_class_for,
    types_for,
)
from .helpers import (  # noqa: F401
    compute_activation_exit_epoch,
    compute_domain,
    compute_epoch_at_slot,
    compute_fork_digest,
    compute_proposer_index,
    compute_signing_root,
    compute_start_slot_at_epoch,
    get_active_validator_indices,
    get_domain,
    get_seed,
    get_total_active_balance,
    is_active_validator,
    is_slashable_validator,
)
from .interop import (  # noqa: F401
    interop_genesis_state,
    interop_keypair,
    interop_secret_key,
)
from .presets import MAINNET, MINIMAL, Preset  # noqa: F401

"""Compile-time spec presets (the reference's EthSpec trait,
consensus/types/src/eth_spec.rs: MainnetEthSpec / MinimalEthSpec size
parameters that fix SSZ list limits and committee geometry)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Preset:
    name: str
    # time
    slots_per_epoch: int
    epochs_per_eth1_voting_period: int
    slots_per_historical_root: int
    # state sizing
    epochs_per_historical_vector: int
    epochs_per_slashings_vector: int
    historical_roots_limit: int
    validator_registry_limit: int
    # committees
    max_committees_per_slot: int
    target_committee_size: int
    max_validators_per_committee: int
    # blocks
    max_proposer_slashings: int
    max_attester_slashings: int
    max_attestations: int
    max_deposits: int
    max_voluntary_exits: int
    # altair
    sync_committee_size: int
    epochs_per_sync_committee_period: int
    sync_committee_subnet_count: int = 4
    # deposit contract tree
    deposit_contract_tree_depth: int = 32
    # bellatrix (execution payload sizing; same on mainnet and minimal)
    bytes_per_logs_bloom: int = 256
    max_bytes_per_transaction: int = 2**30
    max_transactions_per_payload: int = 2**20
    max_extra_data_bytes: int = 32

    @property
    def slots_per_eth1_voting_period(self) -> int:
        return self.epochs_per_eth1_voting_period * self.slots_per_epoch

    @property
    def sync_subcommittee_size(self) -> int:
        return self.sync_committee_size // self.sync_committee_subnet_count


MAINNET = Preset(
    name="mainnet",
    slots_per_epoch=32,
    epochs_per_eth1_voting_period=64,
    slots_per_historical_root=8192,
    epochs_per_historical_vector=65536,
    epochs_per_slashings_vector=8192,
    historical_roots_limit=16_777_216,
    validator_registry_limit=1_099_511_627_776,
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    max_proposer_slashings=16,
    max_attester_slashings=2,
    max_attestations=128,
    max_deposits=16,
    max_voluntary_exits=16,
    sync_committee_size=512,
    epochs_per_sync_committee_period=256,
)

GNOSIS = Preset(
    # the reference's gnosis EthSpec (consensus/types/presets/gnosis/*):
    # mainnet sizing with 16-slot epochs and 512-epoch sync periods
    name="gnosis",
    slots_per_epoch=16,
    epochs_per_eth1_voting_period=64,
    slots_per_historical_root=8192,
    epochs_per_historical_vector=65536,
    epochs_per_slashings_vector=8192,
    historical_roots_limit=16_777_216,
    validator_registry_limit=1_099_511_627_776,
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    max_proposer_slashings=16,
    max_attester_slashings=2,
    max_attestations=128,
    max_deposits=16,
    max_voluntary_exits=16,
    sync_committee_size=512,
    epochs_per_sync_committee_period=512,
)

MINIMAL = Preset(
    name="minimal",
    slots_per_epoch=8,
    epochs_per_eth1_voting_period=4,
    slots_per_historical_root=64,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    historical_roots_limit=16_777_216,
    validator_registry_limit=1_099_511_627_776,
    max_committees_per_slot=4,
    target_committee_size=4,
    max_validators_per_committee=2048,
    max_proposer_slashings=16,
    max_attester_slashings=2,
    max_attestations=128,
    max_deposits=16,
    max_voluntary_exits=16,
    sync_committee_size=32,
    epochs_per_sync_committee_period=8,
)

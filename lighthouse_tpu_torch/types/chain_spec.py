"""Runtime chain parameters (the reference's ChainSpec,
consensus/types/src/chain_spec.rs): fork schedule, domains, gwei amounts,
timing and penalty constants -- everything that can vary per network
without changing SSZ shapes."""

from __future__ import annotations

from dataclasses import dataclass, field

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_SLOT = 0
GENESIS_EPOCH = 0

# BLS signature domains (spec constants)
DOMAIN_BEACON_PROPOSER = (0).to_bytes(4, "little")
DOMAIN_BEACON_ATTESTER = (1).to_bytes(4, "little")
DOMAIN_RANDAO = (2).to_bytes(4, "little")
DOMAIN_DEPOSIT = (3).to_bytes(4, "little")
DOMAIN_VOLUNTARY_EXIT = (4).to_bytes(4, "little")
DOMAIN_SELECTION_PROOF = (5).to_bytes(4, "little")
DOMAIN_AGGREGATE_AND_PROOF = (6).to_bytes(4, "little")
DOMAIN_SYNC_COMMITTEE = (7).to_bytes(4, "little")
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = (8).to_bytes(4, "little")
DOMAIN_CONTRIBUTION_AND_PROOF = (9).to_bytes(4, "little")
# builder-network application domain (builder-specs; reference
# consensus/types/src/chain_spec.rs DOMAIN_APPLICATION_MASK + builder).
# Application domains use the genesis fork version and an empty
# genesis_validators_root in compute_domain.
DOMAIN_APPLICATION_BUILDER = bytes([0, 0, 0, 1])


@dataclass
class ChainSpec:
    config_name: str = "mainnet"

    # forks
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    altair_fork_epoch: int | None = 74240
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    bellatrix_fork_epoch: int | None = 144896

    # time
    seconds_per_slot: int = 12
    min_genesis_time: int = 1606824000
    genesis_delay: int = 604800
    min_genesis_active_validator_count: int = 16384

    # gwei
    max_effective_balance: int = 32 * 10**9
    ejection_balance: int = 16 * 10**9
    effective_balance_increment: int = 10**9
    min_deposit_amount: int = 10**9

    # committees (a config value in the reference's chain_spec.rs:
    # mainnet-preset configs use 90 rounds, minimal-preset configs 10)
    shuffle_round_count: int = 90

    # validator lifecycle
    min_attestation_inclusion_delay: int = 1
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    min_epochs_to_inactivity_penalty: int = 4
    churn_limit_quotient: int = 65536
    min_per_epoch_churn_limit: int = 4

    # rewards & penalties (phase0)
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1

    # rewards & penalties (altair overrides)
    inactivity_penalty_quotient_altair: int = 3 * 2**24
    min_slashing_penalty_quotient_altair: int = 64
    proportional_slashing_multiplier_altair: int = 2
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    # rewards & penalties (bellatrix overrides, chain_spec.rs:142-144)
    inactivity_penalty_quotient_bellatrix: int = 2**24
    min_slashing_penalty_quotient_bellatrix: int = 32
    proportional_slashing_multiplier_bellatrix: int = 3

    # attestation aggregation
    target_aggregators_per_committee: int = 16
    target_aggregators_per_sync_subcommittee: int = 16
    attestation_subnet_count: int = 64

    # deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes(20)

    # misc
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5
    proposer_score_boost: int = 40
    random_subnets_per_validator: int = 1
    epochs_per_random_subnet_subscription: int = 256
    sync_committee_branch_depth: int = 5

    terminal_total_difficulty: int = 2**256 - 2**10
    terminal_block_hash: bytes = bytes(32)
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH
    safe_slots_to_import_optimistically: int = 128

    def fork_version_at_epoch(self, epoch: int) -> bytes:
        if (
            self.bellatrix_fork_epoch is not None
            and epoch >= self.bellatrix_fork_epoch
        ):
            return self.bellatrix_fork_version
        if self.altair_fork_epoch is not None and epoch >= self.altair_fork_epoch:
            return self.altair_fork_version
        return self.genesis_fork_version

    # fork-sensitive penalty parameters (chain_spec.rs:273-295
    # *_for_state helpers; keyed here by the state's fork name)

    def proportional_slashing_multiplier_for(self, fork_name: str) -> int:
        return {
            "phase0": self.proportional_slashing_multiplier,
            "altair": self.proportional_slashing_multiplier_altair,
        }.get(fork_name, self.proportional_slashing_multiplier_bellatrix)

    def inactivity_penalty_quotient_for(self, fork_name: str) -> int:
        return {
            "phase0": self.inactivity_penalty_quotient,
            "altair": self.inactivity_penalty_quotient_altair,
        }.get(fork_name, self.inactivity_penalty_quotient_bellatrix)

    def min_slashing_penalty_quotient_for(self, fork_name: str) -> int:
        return {
            "phase0": self.min_slashing_penalty_quotient,
            "altair": self.min_slashing_penalty_quotient_altair,
        }.get(fork_name, self.min_slashing_penalty_quotient_bellatrix)

    def fork_name_at_epoch(self, epoch: int) -> str:
        if (
            self.bellatrix_fork_epoch is not None
            and epoch >= self.bellatrix_fork_epoch
        ):
            return "bellatrix"
        if self.altair_fork_epoch is not None and epoch >= self.altair_fork_epoch:
            return "altair"
        return "phase0"

    @classmethod
    def mainnet(cls) -> "ChainSpec":
        """Ethereum mainnet (the reference's embedded
        built_in_network_configs/mainnet bundle)."""
        return cls(
            terminal_total_difficulty=58750000000000000000000,
            deposit_contract_address=bytes.fromhex(
                "00000000219ab540356cbb839cbe05303d7705fa"
            ),
        )

    @classmethod
    def sepolia(cls) -> "ChainSpec":
        """Sepolia testnet (built_in_network_configs/sepolia)."""
        return cls(
            config_name="sepolia",
            genesis_fork_version=bytes.fromhex("90000069"),
            altair_fork_version=bytes.fromhex("90000070"),
            altair_fork_epoch=50,
            bellatrix_fork_version=bytes.fromhex("90000071"),
            bellatrix_fork_epoch=100,
            min_genesis_time=1655647200,
            genesis_delay=86400,
            min_genesis_active_validator_count=1300,
            terminal_total_difficulty=17000000000000000,
            deposit_chain_id=11155111,
            deposit_network_id=11155111,
            deposit_contract_address=bytes.fromhex(
                "7f02c3e3c98b133055b8b348b2ac625669ed295d"
            ),
        )

    @classmethod
    def prater(cls) -> "ChainSpec":
        """Goerli/Prater testnet (built_in_network_configs/prater)."""
        return cls(
            config_name="prater",
            genesis_fork_version=bytes.fromhex("00001020"),
            altair_fork_version=bytes.fromhex("01001020"),
            altair_fork_epoch=36660,
            bellatrix_fork_version=bytes.fromhex("02001020"),
            bellatrix_fork_epoch=112260,
            min_genesis_time=1614588812,
            genesis_delay=1919188,
            min_genesis_active_validator_count=16384,
            terminal_total_difficulty=10790000,
            deposit_chain_id=5,
            deposit_network_id=5,
            deposit_contract_address=bytes.fromhex(
                "ff50ed3d0ec03ac01d4c79aad74928bff48a7b2b"
            ),
        )

    @classmethod
    def gnosis(cls) -> "ChainSpec":
        """Gnosis chain (built_in_network_configs/gnosis): 5 s slots,
        16-slot epochs (the GNOSIS preset), its own fork-version family
        and churn limits."""
        return cls(
            config_name="gnosis",
            genesis_fork_version=bytes.fromhex("00000064"),
            altair_fork_version=bytes.fromhex("01000064"),
            altair_fork_epoch=512,
            bellatrix_fork_version=bytes.fromhex("02000064"),
            bellatrix_fork_epoch=385536,
            min_genesis_time=1638968400,
            genesis_delay=6000,
            min_genesis_active_validator_count=4096,
            seconds_per_slot=5,
            base_reward_factor=25,
            churn_limit_quotient=4096,
            min_per_epoch_churn_limit=4,
            terminal_total_difficulty=(
                8626000000000000000000058750000000000000000000
            ),
            deposit_chain_id=100,
            deposit_network_id=100,
            deposit_contract_address=bytes.fromhex(
                "0b98057ea310f4d31f2a452b414647007d1645d9"
            ),
        )

    @classmethod
    def network(cls, name: str) -> "ChainSpec":
        """Embedded per-network bundles (the eth2_network_config seat,
        common/eth2_network_config/src/lib.rs:33-52)."""
        table = {
            "mainnet": cls.mainnet,
            "sepolia": cls.sepolia,
            "prater": cls.prater,
            "goerli": cls.prater,
            "gnosis": cls.gnosis,
            "minimal": cls.minimal,
            "interop": cls.interop,
        }
        if name not in table:
            raise ValueError(
                f"unknown network {name!r} (have {sorted(table)})"
            )
        return table[name]()

    @classmethod
    def minimal(cls) -> "ChainSpec":
        return cls(
            config_name="minimal",
            genesis_fork_version=b"\x00\x00\x00\x01",
            altair_fork_version=b"\x01\x00\x00\x01",
            altair_fork_epoch=None,
            bellatrix_fork_version=b"\x02\x00\x00\x01",
            bellatrix_fork_epoch=None,
            seconds_per_slot=6,
            shuffle_round_count=10,
            min_genesis_active_validator_count=64,
            churn_limit_quotient=32,
            shard_committee_period=64,
            min_validator_withdrawability_delay=256,
        )

    @classmethod
    def interop(
        cls,
        altair_fork_epoch: int | None = None,
        bellatrix_fork_epoch: int | None = None,
    ) -> "ChainSpec":
        """Deterministic local-testing spec (the reference's interop
        genesis path, lcli/environment interop support)."""
        return cls(
            config_name="interop",
            genesis_fork_version=b"\x00\x00\x00\x20",
            altair_fork_version=b"\x01\x00\x00\x20",
            altair_fork_epoch=altair_fork_epoch,
            bellatrix_fork_version=b"\x02\x00\x00\x20",
            bellatrix_fork_epoch=bellatrix_fork_epoch,
            seconds_per_slot=6,
            shuffle_round_count=10,
            min_genesis_active_validator_count=64,
        )

"""Spec genesis: state initialization from eth1 deposits + validity.

Reference consensus/state_processing/src/genesis.rs
(initialize_beacon_state_from_eth1, is_valid_genesis_state) and the
beacon_node/genesis crate's service that watches the deposit contract
until a valid genesis forms. The incremental deposit root recomputed
per applied deposit is the SSZ list root the spec prescribes -- the
same mix-in-count root DepositDataTree produces.

The port's copy of lighthouse_tpu/state_transition/genesis.py.
"""

from __future__ import annotations

from ..eth1.deposit_tree import DepositDataTree
from ..types.chain_spec import ChainSpec
from ..types.containers import BeaconBlockHeader, Eth1Data, Fork, types_for
from ..types.helpers import get_active_validator_indices
from ..types.presets import Preset
from .context import ConsensusContext
from .per_block import process_deposit
from .upgrades import upgrade_to_altair, upgrade_to_bellatrix


def initialize_beacon_state_from_eth1(
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits,
    preset: Preset,
    spec: ChainSpec,
    execution_payload_header=None,
):
    """Spec initialize_beacon_state_from_eth1: a candidate phase0 genesis
    state from an eth1 block + its deposit list. Deposit proofs are
    verified against the incrementally-growing list root, exactly as
    during block processing (genesis.rs builds the same tree)."""
    t = types_for(preset)
    state = t.BeaconState.default()
    state.genesis_time = eth1_timestamp + spec.genesis_delay
    state.fork = Fork(
        previous_version=spec.genesis_fork_version,
        current_version=spec.genesis_fork_version,
        epoch=0,
    )
    state.eth1_data = Eth1Data(
        deposit_root=bytes(32),
        deposit_count=len(deposits),
        block_hash=bytes(eth1_block_hash),
    )
    state.latest_block_header = BeaconBlockHeader(
        body_root=t.BeaconBlockBody.default().tree_hash_root()
    )
    state.randao_mixes = tuple(
        bytes(eth1_block_hash)
        for _ in range(preset.epochs_per_historical_vector)
    )

    tree = DepositDataTree()
    ctxt = ConsensusContext(preset, spec)
    for i, deposit in enumerate(deposits):
        tree.push(deposit.data)
        state.eth1_data = Eth1Data(
            deposit_root=tree.root(i + 1),
            deposit_count=len(deposits),
            block_hash=bytes(eth1_block_hash),
        )
        process_deposit(state, deposit, preset, spec, ctxt)

    # post-deposit fix-up: snap effective balances, activate full stakes
    # (safe to mutate: every Validator here was freshly built by
    # apply_deposit above, nothing aliases them yet)
    for index, v in enumerate(state.validators):
        balance = state.balances[index]
        v.effective_balance = min(
            balance - balance % spec.effective_balance_increment,
            spec.max_effective_balance,
        )
        if v.effective_balance == spec.max_effective_balance:
            v.activation_eligibility_epoch = 0
            v.activation_epoch = 0
    from ..types.helpers import validators_registry_root

    state.genesis_validators_root = validators_registry_root(state)

    # forks active at genesis upgrade the candidate in place
    # (genesis/src/lib.rs upgrades through the schedule before returning)
    name = spec.fork_name_at_epoch(0)
    if name in ("altair", "bellatrix"):
        state = upgrade_to_altair(state, preset, spec)
        # genesis.rs:54-67: a fork active AT genesis has no predecessor;
        # previous_version equals the fork's own version
        state.fork.previous_version = spec.altair_fork_version
    if name == "bellatrix":
        state = upgrade_to_bellatrix(state, preset, spec)
        state.fork.previous_version = spec.bellatrix_fork_version
        if execution_payload_header is not None:
            # merge-at-genesis testnets seed the header directly (spec
            # bellatrix initialize_beacon_state_from_eth1 extension)
            state.latest_execution_payload_header = execution_payload_header
    return state


def is_valid_genesis_state(state, preset: Preset, spec: ChainSpec) -> bool:
    """Spec is_valid_genesis_state: enough time and enough full stakes."""
    if state.genesis_time < spec.min_genesis_time:
        return False
    return (
        len(get_active_validator_indices(state, 0))
        >= spec.min_genesis_active_validator_count
    )


def try_genesis_from_eth1(service, preset: Preset, spec: ChainSpec):
    """Genesis waiter over an Eth1Service: scan cached eth1 blocks oldest-
    first for the first whose deposit snapshot forms a valid genesis
    (beacon_node/genesis/src/lib.rs Eth1GenesisService). Returns the
    genesis state or None if no cached block qualifies yet; call after
    each service.update()."""
    for blk in service.block_cache:
        if blk.timestamp + spec.genesis_delay < spec.min_genesis_time:
            continue
        if blk.deposit_count < spec.min_genesis_active_validator_count:
            # necessary condition for validity; skips the expensive proof
            # rebuild + replay on every poll tick while deposits trickle in
            continue
        # incremental proofs: deposit i proves against root(i + 1), the
        # growing list root initialize verifies step by step
        deposits = [
            service.deposit_tree.deposit(i, service._deposit_data[i], i + 1)
            for i in range(blk.deposit_count)
        ]
        state = initialize_beacon_state_from_eth1(
            blk.hash, blk.timestamp, deposits, preset, spec
        )
        if is_valid_genesis_state(state, preset, spec):
            return state
    return None

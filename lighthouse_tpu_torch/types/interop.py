"""Deterministic interop keypairs + interop genesis state (reference
common/eth2_interop_keypairs and the interop genesis path in
beacon_node/genesis + lcli): the standard insecure test keys
sk_i = int(sha256(le64(i)) || ...) per the eth2 interop scheme, and a
genesis BeaconState seeded from them for harness/simulator runs."""

from __future__ import annotations

import functools
import hashlib

from ..crypto.bls.api import PublicKey, SecretKey
from ..crypto.bls.constants import R
from .chain_spec import ChainSpec
from .containers import (
    BeaconBlockHeader,
    Checkpoint,
    Eth1Data,
    Fork,
    Validator,
    types_for,
)
from .presets import Preset


@functools.lru_cache(maxsize=None)
def interop_secret_key(index: int) -> SecretKey:
    """Insecure deterministic key: sk = int_LE(sha256(le32(index))) mod r
    (the eth2 interop formula used by common/eth2_interop_keypairs)."""
    h = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return SecretKey(int.from_bytes(h, "little") % R)


@functools.lru_cache(maxsize=None)
def interop_keypair(index: int) -> tuple[SecretKey, PublicKey]:
    sk = interop_secret_key(index)
    return sk, sk.public_key()


def interop_genesis_state(
    validator_count: int,
    preset: Preset,
    spec: ChainSpec,
    genesis_time: int = 0,
):
    """Genesis BeaconState with `validator_count` interop validators, all
    active and at max effective balance (the BeaconChainHarness starting
    point; reference beacon_chain/src/test_utils.rs interop_genesis_state).
    Phase0 state unless spec activates altair at genesis."""
    t = types_for(preset)
    fork_name = spec.fork_name_at_epoch(0)
    if fork_name == "phase0":
        state_cls = t.BeaconState
        version = spec.genesis_fork_version
        prev_version = spec.genesis_fork_version
    elif fork_name == "altair":
        state_cls = t.BeaconStateAltair
        version = spec.altair_fork_version
        prev_version = spec.altair_fork_version
    elif fork_name == "bellatrix":
        state_cls = t.BeaconStateBellatrix
        version = spec.bellatrix_fork_version
        prev_version = spec.bellatrix_fork_version
    else:
        raise ValueError(f"unsupported genesis fork {fork_name}")

    validators = []
    balances = []
    for i in range(validator_count):
        _, pk = interop_keypair(i)
        wc = b"\x00" + hashlib.sha256(pk.to_bytes()).digest()[1:]
        validators.append(
            Validator(
                pubkey=pk.to_bytes(),
                withdrawal_credentials=wc,
                effective_balance=spec.max_effective_balance,
                slashed=False,
                activation_eligibility_epoch=0,
                activation_epoch=0,
                exit_epoch=2**64 - 1,
                withdrawable_epoch=2**64 - 1,
            )
        )
        balances.append(spec.max_effective_balance)

    state = state_cls.default()
    state.genesis_time = genesis_time
    state.fork = Fork(previous_version=prev_version, current_version=version, epoch=0)
    state.validators = tuple(validators)
    state.balances = tuple(balances)
    state.latest_block_header = BeaconBlockHeader.default()
    # non-zero randao history so early-epoch seeds differ
    eth1_root = hashlib.sha256(b"interop-eth1").digest()
    state.randao_mixes = tuple(
        eth1_root for _ in range(preset.epochs_per_historical_vector)
    )
    state.eth1_data = Eth1Data(
        deposit_root=hashlib.sha256(b"deposit").digest(),
        deposit_count=validator_count,
        block_hash=eth1_root,
    )
    state.eth1_deposit_index = validator_count
    state.genesis_validators_root = _validators_root(state)

    if fork_name == "altair":
        from .sync_committee import compute_sync_committee

        zeros = tuple(0 for _ in range(validator_count))
        state.previous_epoch_participation = zeros
        state.current_epoch_participation = zeros
        state.inactivity_scores = zeros
        # spec altair genesis: both committees from get_next_sync_committee
        # (sampled at epoch 1)
        committee = compute_sync_committee(state, 1, preset, spec)
        state.current_sync_committee = committee
        state.next_sync_committee = committee
    return state


def _validators_root(state) -> bytes:
    from .helpers import validators_registry_root

    return validators_registry_root(state)

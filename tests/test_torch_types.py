"""The port's consensus types (lighthouse_tpu_torch/types, utils/shuffle.py,
state_transition/per_slot.py) against the JAX package's on the CPU: the
swap-or-not shuffle, the interop keys, interop genesis states (phase0 and
altair, MINIMAL, 64 validators) byte for byte, every committee of epochs 0
and 1, proposer indices, domains, seeds and signing roots, sync
committees, the presets and chain specs, slot processing within and across
epochs, and the SSZ carry of states and blocks (tests/torch_port_util.py).

The JAX genesis takes its public keys from the port's bytes
(`jax_keys_from_port`); the keypair tests hold every secret key and the
first public keys across the packages. No XLA compile."""

import dataclasses
import random

import numpy as np
import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.state_transition import per_slot as JPS
from lighthouse_tpu.types import committee_cache as JCC
from lighthouse_tpu.types import helpers as JHL
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu.utils import shuffle as JSH
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from lighthouse_tpu_torch.types import committee_cache as TCC
from lighthouse_tpu_torch.types import helpers as THL
from lighthouse_tpu_torch.types import sync_committee as TSC
from lighthouse_tpu_torch.utils import shuffle as TSH
from torch_port_util import carry_block, carry_state, jax_keys_from_port

N_VALIDATORS = 64
DOMAINS = [n for n in dir(J) if n.startswith("DOMAIN_")]


@pytest.fixture(scope="module")
def genesis():
    """{fork: (jax state, port state)} at MINIMAL, 64 interop validators."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_keys_from_port(mp)
        for fork, altair in (("phase0", None), ("altair", 0)):
            js = J.interop_genesis_state(
                N_VALIDATORS, J.MINIMAL, J.ChainSpec.interop(altair_fork_epoch=altair))
            ts = T.interop_genesis_state(
                N_VALIDATORS, T.MINIMAL, T.ChainSpec.interop(altair_fork_epoch=altair))
            out[fork] = (js, ts)
    return out


def _spec(pkg, fork):
    return pkg.ChainSpec.interop(altair_fork_epoch=0 if fork == "altair" else None)


@pytest.mark.parametrize("n, rounds", [(1, 10), (7, 10), (64, 10), (300, 90)])
def test_shuffle_equals_jax(n, rounds):
    rng = random.Random(n)
    seed = rng.randbytes(32)
    perm = TSH.shuffle_indices(n, seed, rounds)
    np.testing.assert_array_equal(perm, JSH.shuffle_indices(n, seed, rounds))
    for i in sorted(rng.sample(range(n), min(n, 8))):
        assert TSH.compute_shuffled_index(i, n, seed, rounds) == perm[i]
        assert JSH.compute_shuffled_index(i, n, seed, rounds) == perm[i]
    items = [rng.getrandbits(16) for _ in range(n)]
    for forwards in (False, True):
        assert (TSH.shuffle_list(items, seed, forwards, rounds)
                == JSH.shuffle_list(items, seed, forwards, rounds))
    with pytest.raises(ValueError, match="index out of range"):
        TSH.compute_shuffled_index(n, n, seed, rounds)


def test_interop_keys_equal_jax():
    """Every secret key of the registry, and the first four public keys
    (the JAX oracle's scalar multiplication costs ~0.18 s a key)."""
    for i in range(N_VALIDATORS):
        assert T.interop_secret_key(i).to_bytes() == J.interop_secret_key(i).to_bytes()
    for i in range(4):
        assert (T.interop_keypair(i)[1].to_bytes()
                == J.interop_keypair(i)[1].to_bytes())


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_interop_genesis_state_equals_jax(genesis, fork):
    js, ts = genesis[fork]
    assert ts.fork_name == js.fork_name == fork
    assert ts.as_ssz_bytes() == js.as_ssz_bytes()
    assert ts.tree_hash_root() == js.tree_hash_root()
    assert THL.validators_registry_root(ts) == JHL.validators_registry_root(js)
    assert ts.genesis_validators_root == js.genesis_validators_root


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_carry_helper_round_trips(genesis, fork):
    js, ts = genesis[fork]
    carried = carry_state(js, J.MINIMAL)
    assert type(carried) is type(ts)
    assert carried.tree_hash_root() == js.tree_hash_root()
    assert carried.as_ssz_bytes() == js.as_ssz_bytes()
    jt = J.types_for(J.MINIMAL)
    jblock = J.block_classes_for(jt, fork)[1].default()
    jblock.message.slot = 5
    jblock.message.body.graffiti = b"carried".ljust(32, b"\0")
    tblock = carry_block(jblock, J.MINIMAL)
    assert tblock.fork_name == fork
    assert tblock.tree_hash_root() == jblock.tree_hash_root()
    assert tblock.as_ssz_bytes() == jblock.as_ssz_bytes()


@pytest.mark.parametrize("epoch", [0, 1])
def test_every_committee_equals_jax(genesis, epoch):
    js, ts = genesis["phase0"]
    jcc = JCC.CommitteeCache(js, epoch, J.MINIMAL, _spec(J, "phase0"))
    tcc = TCC.CommitteeCache(ts, epoch, T.MINIMAL, _spec(T, "phase0"))
    assert tcc.shuffling == jcc.shuffling
    assert tcc.committees_per_slot == jcc.committees_per_slot == 2
    seed = THL.get_seed(ts, epoch, T.DOMAIN_BEACON_ATTESTER, T.MINIMAL, _spec(T, "phase0"))
    active = THL.get_active_validator_indices(ts, epoch)
    spe = T.MINIMAL.slots_per_epoch
    for slot in range(epoch * spe, (epoch + 1) * spe):
        committees = tcc.get_all_committees_at_slot(slot)
        assert committees == jcc.get_all_committees_at_slot(slot)
        for index, committee in enumerate(committees):
            k = (slot % spe) * tcc.committees_per_slot + index
            assert committee == THL.compute_committee(
                active, seed, k, spe * tcc.committees_per_slot, rounds=10)
    for v in range(N_VALIDATORS):
        assert tcc.attester_position(v) == jcc.attester_position(v)


def test_proposer_indices_equal_jax(genesis):
    js, ts = (JPS.clone_state(s) for s in genesis["phase0"])
    seen = []
    for slot in range(2 * T.MINIMAL.slots_per_epoch):
        js.slot = ts.slot = slot
        p = TPS.get_beacon_proposer_index(ts, T.MINIMAL, _spec(T, "phase0"))
        assert p == JPS.get_beacon_proposer_index(js, J.MINIMAL, _spec(J, "phase0"))
        seen.append(p)
    assert len(set(seen)) > 4


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_domains_seeds_and_signing_roots_equal_jax(genesis, fork):
    js, ts = genesis[fork]
    assert sorted(n for n in dir(T) if n.startswith("DOMAIN_")) == DOMAINS
    rng = random.Random(fork)
    jdata = J.AttestationData(
        slot=3, index=1, beacon_block_root=rng.randbytes(32),
        source=J.Checkpoint(epoch=0, root=rng.randbytes(32)),
        target=J.Checkpoint(epoch=0, root=rng.randbytes(32)))
    tdata = T.AttestationData.from_ssz_bytes(jdata.as_ssz_bytes())
    for name in DOMAINS:
        for epoch in (0, 1, 2):
            d = T.get_domain(ts, getattr(T, name), epoch, T.MINIMAL)
            assert d == J.get_domain(js, getattr(J, name), epoch, J.MINIMAL)
            assert (T.compute_signing_root(tdata, d)
                    == J.compute_signing_root(jdata, d))
            assert (T.get_seed(ts, epoch, getattr(T, name), T.MINIMAL, _spec(T, fork))
                    == J.get_seed(js, epoch, getattr(J, name), J.MINIMAL, _spec(J, fork)))
    version = rng.randbytes(4)
    assert (T.compute_domain(T.DOMAIN_DEPOSIT, version, bytes(32))
            == J.compute_domain(J.DOMAIN_DEPOSIT, version, bytes(32)))
    assert (T.compute_fork_digest(version, ts.genesis_validators_root)
            == J.compute_fork_digest(version, js.genesis_validators_root))


@pytest.mark.parametrize("base_epoch", [1, 2])
def test_sync_committee_equals_jax(genesis, base_epoch, monkeypatch):
    jax_keys_from_port(monkeypatch)
    js, ts = genesis["altair"]
    tc = TSC.compute_sync_committee(ts, base_epoch, T.MINIMAL, _spec(T, "altair"))
    jc = JSC.compute_sync_committee(js, base_epoch, J.MINIMAL, _spec(J, "altair"))
    assert tc.as_ssz_bytes() == jc.as_ssz_bytes()
    assert (TSC.get_sync_committee_indices(ts, base_epoch, T.MINIMAL, _spec(T, "altair"))
            == JSC.get_sync_committee_indices(js, base_epoch, J.MINIMAL, _spec(J, "altair")))


def test_presets_and_chain_specs_equal_jax():
    for name in ("MAINNET", "MINIMAL"):
        assert dataclasses.asdict(getattr(T, name)) == dataclasses.asdict(getattr(J, name))
    for ctor in ("mainnet", "minimal", "sepolia", "prater", "gnosis", "interop"):
        assert (dataclasses.asdict(getattr(T.ChainSpec, ctor)())
                == dataclasses.asdict(getattr(J.ChainSpec, ctor)()))
    assert (dataclasses.asdict(T.ChainSpec.interop(altair_fork_epoch=0))
            == dataclasses.asdict(J.ChainSpec.interop(altair_fork_epoch=0)))


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_slot_processing_within_an_epoch_equals_jax(genesis, fork):
    """process_slots to the epoch's last slot gives the JAX state's bytes,
    and so does going on across the next two boundaries (epoch
    processing at slots 8 and 16)."""
    js, ts = genesis[fork]
    js = JPS.process_slots(JPS.clone_state(js), 7, J.MINIMAL, _spec(J, fork))
    ts = TPS.process_slots(TPS.clone_state(ts), 7, T.MINIMAL, _spec(T, fork))
    assert ts.as_ssz_bytes() == js.as_ssz_bytes()
    for target in (8, 17):
        js = JPS.process_slots(js, target, J.MINIMAL, _spec(J, fork))
        ts = TPS.process_slots(ts, target, T.MINIMAL, _spec(T, fork))
        assert ts.slot == target
        assert ts.as_ssz_bytes() == js.as_ssz_bytes()

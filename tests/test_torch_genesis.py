"""The port's deposit tree and genesis from eth1 deposits
(lighthouse_tpu_torch/eth1/deposit_tree.py, state_transition/genesis.py)
against the JAX package's on the CPU:

- the deposit tree's root and every branch at every count, and after a
  truncation, byte for byte;
- `initialize_beacon_state_from_eth1` over 64 interop deposits on both
  packages' `fake` backend (and a partial stake and a top-up beside
  them): the same state root, `is_valid_genesis_state` the same;
- 3 deposits on both packages' `cpu` backend, the second one's
  signature forged: the same state root, the forged key absent;
- `try_genesis_from_eth1` over a stub of the three attributes it reads
  (`block_cache`, `deposit_tree`, `_deposit_data`): the same state at the
  first qualifying block, None while no block qualifies.

Deposits are built on the port (chip_smoke.py's builder, interop keys,
signatures from the port's host oracle) and reach the JAX side as SSZ
bytes. The JAX side decompresses the deposit keys without the subgroup
check on the `fake` runs (~0.18 s a key otherwise). No XLA compile."""

import importlib.util
from pathlib import Path

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.eth1 import deposit_tree as JDT
from lighthouse_tpu.state_transition import genesis as JG
from lighthouse_tpu.types import containers as JCON
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.eth1 import deposit_tree as TDT
from lighthouse_tpu_torch.state_transition import genesis as TG
from torch_port_util import carry, jax_keys_decompressed, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

C = CS.consensus_modules()
ETH1_HASH = b"\x42" * 32


@pytest.fixture(autouse=True)
def _backends():
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _jax_deposits(deposits):
    return [carry(d, JCON.Deposit) for d in deposits]


def _both(deposits, spec_t, spec_j, timestamp):
    got = TG.initialize_beacon_state_from_eth1(
        ETH1_HASH, timestamp, deposits, T.MINIMAL, spec_t)
    want = JG.initialize_beacon_state_from_eth1(
        ETH1_HASH, timestamp, _jax_deposits(deposits), J.MINIMAL, spec_j)
    return got, want


def test_deposit_tree_roots_and_branches_equal_jax():
    datas = CS.genesis_deposit_data(C, T.ChainSpec.minimal(), 5, CS.HostCrypto(),
                                    sign=False)
    jt, tt = JDT.DepositDataTree(), TDT.DepositDataTree()
    assert TDT.DEPOSIT_TREE_DEPTH == JDT.DEPOSIT_TREE_DEPTH == 32
    assert tt.root() == jt.root()  # the empty tree
    for d in datas:
        jt.push(carry(d, JCON.DepositData))
        tt.push(d)
    for count in range(6):
        assert tt.root(count) == jt.root(count), count
        for i in range(count):
            assert tt.proof(i, count) == jt.proof(i, count), (i, count)
    dep = tt.deposit(3, datas[3], 5)
    assert dep.as_ssz_bytes() == jt.deposit(3, carry(datas[3], JCON.DepositData),
                                            5).as_ssz_bytes()
    with pytest.raises(IndexError):
        tt.proof(5, 5)
    with pytest.raises(ValueError):
        tt.root(6)
    jt.truncate(2), tt.truncate(2)
    assert tt.leaves == jt.leaves and tt.root() == jt.root()


@pytest.mark.parametrize("extra", ["none", "partial-and-top-up"])
def test_genesis_from_64_deposits_on_fake_equals_jax(monkeypatch, extra):
    jax_keys_decompressed(monkeypatch)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    spec_t, spec_j = T.ChainSpec.minimal(), J.ChainSpec.minimal()
    datas = CS.genesis_deposit_data(C, spec_t, 64, CS.HostCrypto(), sign=False)
    if extra != "none":
        top_up = CS.genesis_deposit_data(C, spec_t, 1, CS.HostCrypto(), sign=False)[0]
        top_up.amount = 10**9
        partial = CS.genesis_deposit_data(C, spec_t, 65, CS.HostCrypto(),
                                          sign=False)[64]
        partial.amount = 17 * 10**9 + 12345
        datas = datas[:10] + [top_up] + datas[10:] + [partial]
    deposits = CS.deposit_list(C, datas)[1]
    got, want = _both(deposits, spec_t, spec_j, spec_t.min_genesis_time)
    assert got.tree_hash_root() == want.tree_hash_root()
    assert got.as_ssz_bytes() == want.as_ssz_bytes()
    assert len(got.validators) == 64 + (extra != "none")
    valid = TG.is_valid_genesis_state(got, T.MINIMAL, spec_t)
    assert valid is JG.is_valid_genesis_state(want, J.MINIMAL, spec_j) is True
    # one second early: not valid on either package
    got.genesis_time = want.genesis_time = spec_t.min_genesis_time - 1
    assert not TG.is_valid_genesis_state(got, T.MINIMAL, spec_t)
    assert not JG.is_valid_genesis_state(want, J.MINIMAL, spec_j)


def test_genesis_on_cpu_with_a_forged_deposit_equals_jax():
    japi.set_backend("cpu")
    tapi.set_backend("cpu")
    spec_t, spec_j = T.ChainSpec.minimal(), J.ChainSpec.minimal()
    datas = CS.genesis_deposit_data(C, spec_t, 3, CS.HostCrypto(), forged=(1,))
    deposits = CS.deposit_list(C, datas)[1]
    got, want = _both(deposits, spec_t, spec_j, spec_t.min_genesis_time)
    assert got.as_ssz_bytes() == want.as_ssz_bytes()
    keys = [bytes(v.pubkey) for v in got.validators]
    assert keys == [bytes(datas[0].pubkey), bytes(datas[2].pubkey)]
    assert got.eth1_deposit_index == 3


def test_try_genesis_from_eth1_over_a_stub_service_equals_jax(monkeypatch):
    jax_keys_decompressed(monkeypatch)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    spec_t, spec_j = T.ChainSpec.minimal(), J.ChainSpec.minimal()
    datas = CS.genesis_deposit_data(C, spec_t, 64, CS.HostCrypto(), sign=False)
    tree, deposits = CS.deposit_list(C, datas)
    jtree = JDT.DepositDataTree()
    jdatas = [carry(d, JCON.DepositData) for d in datas]
    for d in jdatas:
        jtree.push(d)
    blocks = CS.genesis_eth1_blocks(spec_t, ETH1_HASH, len(datas))
    got = TG.try_genesis_from_eth1(CS.genesis_service(tree, datas, blocks),
                                   T.MINIMAL, spec_t)
    want = JG.try_genesis_from_eth1(CS.genesis_service(jtree, jdatas, blocks),
                                    J.MINIMAL, spec_j)
    assert got is not None and got.as_ssz_bytes() == want.as_ssz_bytes()
    # the first qualifying block's: its hash, its time, all its deposits
    assert bytes(got.eth1_data.block_hash) == ETH1_HASH
    assert got.genesis_time == spec_t.min_genesis_time + spec_t.genesis_delay
    assert got.eth1_deposit_index == len(deposits) == 64
    # no block qualifies yet: too early, then too few deposits
    early = blocks[:2]
    assert TG.try_genesis_from_eth1(CS.genesis_service(tree, datas, early),
                                    T.MINIMAL, spec_t) is None
    assert JG.try_genesis_from_eth1(CS.genesis_service(jtree, jdatas, early),
                                    J.MINIMAL, spec_j) is None

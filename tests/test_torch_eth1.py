"""The port's eth1 follower (lighthouse_tpu_torch/eth1/{service,jsonrpc}.py
over utils/jsonrpc.py) against the JAX package's on the CPU, byte for
byte:

- the DepositEvent log ABI both ways on seeded deposits, and the same
  refusal of truncated data;
- an `Eth1Service` over `JsonRpcEth1Provider` over the port's
  `Eth1RpcServer` against the JAX package's service over its in-process
  `MockEth1Provider`, through a reorg that drops a deposit: the same block
  caches, deposit roots, eth1-data votes and owed deposits; a transient
  503 retried and a 4xx refused at once (`JsonRpcClient`); the servers
  stopped in `finally`, every client on a short timeout;
- tests/test_eth1.py's deposit flow on both packages' `fake` backend:
  `InProcessBeaconNode.produce_block` votes eth1 data, and the block that
  wins the vote packs the new deposit: the same inclusion slot, the same
  state root, 17 validators.

The deposits are signed by the port and carried to JAX as SSZ bytes; the
JAX side takes its interop keys from the port's (`jax_keys_from_port`).
No XLA compile."""

import numpy as np
import pytest

from lighthouse_tpu import eth1 as JE
from lighthouse_tpu import types as J
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.harness import BeaconChainHarness as JHarness
from lighthouse_tpu.types import containers as JCT
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu.validator_client.beacon_node import InProcessBeaconNode as JNode
from lighthouse_tpu_torch import eth1 as E
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import BeaconChainHarness
from lighthouse_tpu_torch.ssz import cached_root
from lighthouse_tpu_torch.types import containers as CT
from lighthouse_tpu_torch.utils.jsonrpc import JsonRpcClient, JsonRpcHttpServer
from lighthouse_tpu_torch.validator_client import InProcessBeaconNode
from torch_port_util import carry, jax_keys_from_port, no_xla_compile

GWEI = 32 * 10**9


@pytest.fixture(autouse=True)
def _backends(monkeypatch):
    jax_keys_from_port(monkeypatch)
    monkeypatch.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _deposit(sk, spec, amount=GWEI):
    """A deposit of `sk`'s key, signed over the deposit domain (the port's
    signature: the JAX side gets the same bytes)."""
    msg = CT.DepositMessage(pubkey=sk.public_key().to_bytes(),
                            withdrawal_credentials=b"\x00" * 32, amount=amount)
    domain = T.compute_domain(T.DOMAIN_DEPOSIT, spec.genesis_fork_version, bytes(32))
    return CT.DepositData(pubkey=msg.pubkey, withdrawal_credentials=msg.withdrawal_credentials,
                          amount=amount,
                          signature=sk.sign(T.compute_signing_root(msg, domain)).to_bytes())


def _seeded_data(seed, n):
    rng = np.random.default_rng(seed)

    def b(k):
        return rng.integers(0, 256, k, dtype=np.uint8).tobytes()

    return [CT.DepositData(pubkey=b(48), withdrawal_credentials=b(32),
                           amount=int(rng.integers(1, 2**63)), signature=b(96))
            for _ in range(n)]


def test_deposit_log_abi_equal_both_ways():
    for i, td in enumerate(_seeded_data(5, 4)):
        jd = carry(td, JCT.DepositData)
        data = E.encode_deposit_log_data(td, 1000 + i)
        assert data == JE.encode_deposit_log_data(jd, 1000 + i)
        back, index = JE.decode_deposit_log_data(data)
        assert (back.as_ssz_bytes(), index) == (td.as_ssz_bytes(), 1000 + i)
        back, index = E.decode_deposit_log_data(JE.encode_deposit_log_data(jd, 7))
        assert (back.as_ssz_bytes(), index) == (td.as_ssz_bytes(), 7)
    errors = []
    for decode in (E.decode_deposit_log_data, JE.decode_deposit_log_data):
        with pytest.raises(ValueError) as e:
            decode(data[:100])
        errors.append(str(e.value))
        with pytest.raises(ValueError, match="out of range"):
            decode(data[:-40])
    assert errors[0] == errors[1]


def _chains(datas):
    """The same eth1 chain in both packages' MockEth1Provider: the
    deposits in blocks 1 and 3 of 8."""
    tp, jp = E.MockEth1Provider(), JE.MockEth1Provider()
    for p, ds in ((tp, datas), (jp, [carry(d, JCT.DepositData) for d in datas])):
        for n in range(8):
            p.add_block(100 + n, ds[:3] if n == 1 else ds[3:] if n == 3 else ())
    return tp, jp


def _view(svc, state):
    vote = svc.eth1_data_for_block(state)
    return ([(b.number, b.hash, b.deposit_count) for b in svc.block_cache],
            svc.deposit_tree.root(len(svc.deposit_tree.leaves)), vote.as_ssz_bytes())


def test_service_over_json_rpc_equals_jax_through_a_reorg():
    datas = _seeded_data(9, 5)
    tp, jp = _chains(datas)
    server = E.Eth1RpcServer(tp).start()
    try:
        tsvc = E.Eth1Service(E.JsonRpcEth1Provider(server.url, backoff_s=0.01,
                                                   timeout_s=2.0), follow_distance=2)
        jsvc = JE.Eth1Service(jp, follow_distance=2)
        tstate = T.interop_genesis_state(4, T.MINIMAL, T.ChainSpec.interop())
        jstate = J.interop_genesis_state(4, J.MINIMAL, J.ChainSpec.interop())
        server.fail_next = 1  # the first request answers 503 and is retried
        tsvc.update()
        jsvc.update()
        assert _view(tsvc, tstate) == _view(jsvc, jstate)
        tstate.eth1_deposit_index = jstate.eth1_deposit_index = 0
        for s, vote in ((tstate, tsvc.eth1_data_for_block(tstate)),
                        (jstate, jsvc.eth1_data_for_block(jstate))):
            s.eth1_data = vote
        assert [d.as_ssz_bytes() for d in tsvc.deposits_for_block(tstate, 16)] == \
            [d.as_ssz_bytes() for d in jsvc.deposits_for_block(jstate, 16)]
        # a reorg drops blocks 3-7 (and the deposits of block 3)
        for p in (tp, jp):
            p.reorg(5)
            p.add_block(200)
        tsvc.update()
        jsvc.update()
        assert _view(tsvc, tstate) == _view(jsvc, jstate)
        assert len(tsvc.deposit_tree.leaves) == 3
    finally:
        server.stop()


def test_json_rpc_client_retries_a_503_and_fails_fast_on_4xx():
    calls = []

    def dispatch(method, params):
        calls.append(method)
        if method == "boom":
            raise ValueError("no such thing")
        return params

    server = JsonRpcHttpServer(dispatch, auth_fn=lambda h: h == "Bearer ok").start()
    try:
        good = JsonRpcClient(server.url, headers_fn=lambda: {"Authorization": "Bearer ok"},
                             backoff_s=0.01, timeout_s=2.0)
        server.fail_next = 2
        assert good.call("echo", [1, "x"]) == [1, "x"]
        assert server.requests_seen == 3
        with pytest.raises(RuntimeError, match="no such thing"):
            good.call("boom", [])
        bad = JsonRpcClient(server.url, error_cls=E.Eth1ProviderError, backoff_s=0.01,
                            timeout_s=2.0)
        with pytest.raises(E.Eth1ProviderError, match="HTTP 401"):
            bad.call("echo", [])
        assert server.requests_seen == 5 and calls == ["echo", "boom"]
    finally:
        server.stop()


def test_deposit_flow_into_a_produced_block_equals_jax():
    """tests/test_eth1.py's flow on both packages: 16 genesis deposits and
    one new one on the eth1 chain; the beacon node votes at the follow
    distance each slot, and the block whose vote wins packs the deposit."""
    spec = T.ChainSpec.interop()
    datas = [_deposit(T.interop_secret_key(i), spec) for i in range(16)]
    datas.append(_deposit(tapi.SecretKey(999_001), spec))
    results = []
    for pkg, eth1, harness, node in ((T, E, BeaconChainHarness, InProcessBeaconNode),
                                     (J, JE, JHarness, JNode)):
        kwargs = dict(device="cpu") if pkg is T else {}
        h = harness(16, pkg.MINIMAL, **kwargs)
        provider = eth1.MockEth1Provider()
        ds = datas if pkg is T else [carry(d, JCT.DepositData) for d in datas]
        provider.add_block(100, ds[:16])
        provider.add_block(101, ds[16:])
        for i in range(6):
            provider.add_block(102 + i)
        svc = eth1.Eth1Service(provider)
        svc.update()
        bn = node(h.chain, eth1_service=svc)
        t = pkg.types_for(pkg.MINIMAL)
        roots = []
        for slot in range(1, 20):
            h.chain.slot_clock.set_slot(slot)
            block = bn.produce_block(slot, tapi.INFINITY_SIGNATURE)
            _, signed_cls, _ = (CT if pkg is T else JCT).block_classes_for(
                t, h.chain.head_state.fork_name)
            signed = signed_cls(message=block, signature=tapi.INFINITY_SIGNATURE)
            h.chain.process_block(signed, strategy=h.strategy)
            roots.append(block.tree_hash_root())
            if len(block.body.deposits):
                break
        state = h.chain.head_state
        state_root = cached_root(state) if pkg is T else state.tree_hash_root()
        results.append((slot, roots, state_root, len(state.validators),
                        bytes(state.validators[16].pubkey), int(state.eth1_deposit_index)))
    assert results[0] == results[1]
    slot, _, _, n, pubkey, index = results[0]
    assert slot == T.MINIMAL.slots_per_eth1_voting_period // 2 + 1
    assert (n, pubkey, index) == (17, bytes(datas[16].pubkey), 17)

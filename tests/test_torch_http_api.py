"""The port's beacon API over HTTP (lighthouse_tpu_torch/http_api/) and the
validator client's services (validator_client/services.py) against the
JAX package's on the CPU, on the same harness chain
(`BeaconChainHarness(16, MINIMAL, ChainSpec.interop())`, both packages on
the `fake` backend, the port's chain on `device="cpu"`):

- every GET route of BeaconApiServer answers the same status and the same
  body bytes from both packages' servers (errors included), and so do the
  validator-namespace POSTs; /lighthouse/health the same fields and head,
  /metrics the same chain lines;
- tests/test_http_api.py's TestVcOverHttp scenario for one epoch, through
  BeaconNodeFallback([a client of a closed port, the live client]): the
  same heads after every slot, the same blocks proposed, the same
  publish counts, no duty error, the graffiti across the HTTP boundary,
  the closed port passed over alike;
- the fallback's failover on a failing call (its event log) and
  NoHealthyBeaconNode when no endpoint is reachable, alike.

A `gpu`-marked test posts a signed block and a forged one over HTTP to a
chain on the card and gets the cpu oracle's verdicts. Every server is
stopped in `finally`; every client has a short timeout. No XLA compile."""

import importlib.util
import json
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from lighthouse_tpu import http_api as JH
from lighthouse_tpu import types as J
from lighthouse_tpu import validator_client as JV
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.harness import BeaconChainHarness as JHarness
from lighthouse_tpu.resilience.primitives import EventLog as JEventLog
from lighthouse_tpu.types import interop as JI
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu_torch import http_api as TH
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch import validator_client as TV
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import BeaconChainHarness
from lighthouse_tpu_torch.resilience.primitives import EventLog as TEventLog
from lighthouse_tpu_torch.ssz import cached_root
from torch_port_util import jax_keys_from_port, need_card, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

N = 16
SPE = T.MINIMAL.slots_per_epoch
TIMEOUT_S = 10.0
GRAFFITI = b"over http"
INFINITY = "0x" + bytes([0xC0] + [0] * 95).hex()
# the chain's lines of /metrics (the registry's timings differ run to run)
CHAIN_GAUGES = ("beacon_head_slot", "beacon_finalized_epoch", "beacon_validator_count")
PORT = (T, TH, TV, BeaconChainHarness, dict(device="cpu"))
JAX = (J, JH, JV, JHarness, {})


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


def _raw(url, method="GET", body=None):
    """(status, body bytes) of one request; an HTTP error is returned."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _rig(pkg, H, V, harness, kwargs, blocks=3):
    h = harness(N, pkg.MINIMAL, pkg.ChainSpec.interop(), **kwargs)
    h.extend_chain(blocks)
    server = H.BeaconApiServer(H.BeaconApi(V.InProcessBeaconNode(h.chain)))
    server.start()
    return h, server, f"http://127.0.0.1:{server.port}"


def _get_routes(h):
    """A URL of every GET route (and a few of their errors) on the
    harness chain at slot 3."""
    head = "0x" + bytes(h.chain.head_root).hex()
    state_root = "0x" + bytes(cached_root(h.chain.head_state)).hex()
    pk = "0x" + bytes(h.chain.head_state.validators[3].pubkey).hex()
    return [
        "/eth/v1/beacon/genesis", "/eth/v1/beacon/states/head/root",
        "/eth/v1/beacon/states/genesis/root", "/eth/v1/beacon/states/finalized/root",
        f"/eth/v1/beacon/states/{state_root}/root", "/eth/v1/beacon/states/bogus/root",
        "/eth/v1/beacon/states/head/finality_checkpoints", "/eth/v1/beacon/states/head/fork",
        "/eth/v1/beacon/states/head/validators", "/eth/v1/beacon/states/head/validators/3",
        f"/eth/v1/beacon/states/head/validators/{pk}",
        "/eth/v1/beacon/states/head/validators/99",
        "/eth/v1/beacon/states/head/validator_balances",
        "/eth/v1/beacon/states/head/committees", "/eth/v1/beacon/states/head/committees?epoch=1",
        "/eth/v1/beacon/states/head/sync_committees", "/eth/v1/beacon/states/head/randao",
        "/eth/v1/beacon/states/head/randao?epoch=999", "/eth/v2/beacon/blocks/head",
        "/eth/v2/beacon/blocks/genesis", f"/eth/v2/beacon/blocks/{head}",
        "/eth/v2/beacon/blocks/0x" + "00" * 32, "/eth/v1/beacon/headers/head",
        "/eth/v1/beacon/headers", "/eth/v1/beacon/headers?slot=1",
        "/eth/v1/beacon/headers?slot=9", "/eth/v1/beacon/blocks/head/root",
        "/eth/v1/beacon/blocks/head/attestations", "/eth/v1/validator/duties/proposer/0",
        "/eth/v1/validator/duties/proposer/1",
        f"/eth/v2/validator/blocks/4?randao_reveal={INFINITY}&graffiti=0x" + "61" * 32,
        "/eth/v1/validator/attestation_data?slot=3&committee_index=0",
        "/eth/v1/validator/aggregate_attestation?attestation_data=0x" + "11" * 32,
        "/eth/v1/node/version", "/eth/v1/node/syncing", "/eth/v1/node/identity",
        "/eth/v1/node/peers", "/eth/v1/node/peer_count", "/eth/v1/node/peers/p1",
        "/eth/v1/node/health", "/eth/v1/beacon/pool/voluntary_exits",
        "/eth/v1/beacon/pool/proposer_slashings", "/eth/v1/beacon/pool/attester_slashings",
        "/eth/v1/validator/sync_committee_contribution?slot=3&subcommittee_index=0"
        f"&beacon_block_root={head}",
        f"/eth/v1/validator/blinded_blocks/4?randao_reveal={INFINITY}",
        f"/eth/v1/beacon/light_client/bootstrap/{head}",
        "/eth/v1/beacon/light_client/finality_update",
        "/eth/v1/beacon/light_client/optimistic_update", "/eth/v1/config/spec",
        "/eth/v1/config/fork_schedule", "/eth/v1/config/deposit_contract",
        "/eth/v2/debug/beacon/states/head", "/eth/v1/debug/beacon/heads",
        "/lighthouse/validator_inclusion/0/global", "/lighthouse/validator_inclusion/0/3",
        "/lighthouse/analysis/attestation_performance/3?start_epoch=0&end_epoch=0",
        "/lighthouse/analysis/attestation_performance/3",
        "/lighthouse/database/info", "/lighthouse/syncing", "/lighthouse/staking",
        "/lighthouse/eth1/syncing", "/lighthouse/eth1/block_cache",
        "/lighthouse/eth1/deposit_cache", "/lighthouse/merge_readiness",
        "/lighthouse/proto_array", "/lighthouse/ui/validator_count",
        "/lighthouse/analysis/block_packing?start_slot=1&end_slot=3",
        "/lighthouse/analysis/block_rewards?start_slot=1&end_slot=3",
        "/eth/v1/events", "/eth/v1/no/such/route",
    ]


POSTS = (
    ("/eth/v1/validator/duties/attester/0", [str(i) for i in range(N)]),
    ("/eth/v1/validator/duties/attester/1", ["0", "7", "99"]),
    ("/eth/v1/validator/duties/sync/0", ["0", "1"]),
    ("/eth/v1/validator/prepare_beacon_proposer",
     [{"validator_index": "1", "fee_recipient": "0x" + "ee" * 20}]),
    ("/eth/v1/validator/beacon_committee_subscriptions",
     [{"validator_index": "0", "committee_index": "0", "committees_at_slot": "1",
       "slot": "4", "is_aggregator": False}]),
    ("/eth/v1/validator/sync_committee_subscriptions", []),
    ("/lighthouse/liveness", {"indices": ["0", "5"], "epoch": "0"}),
    ("/lighthouse/liveness", {"indices": "0", "epoch": "0"}),
    ("/lighthouse/ui/validator_metrics", {"indices": [0, 3]}),
    ("/eth/v1/beacon/pool/attestations", []),
    ("/eth/v1/no/such/route", {}),
)


def test_every_get_route_and_duty_post_answers_alike():
    answers = []
    for pkg, H, V, harness, kwargs in (PORT, JAX):
        h, server, base = _rig(pkg, H, V, harness, kwargs)
        try:
            routes = _get_routes(h)
            got = [(url, *_raw(base + url)) for url in routes]
            got += [(url, *_raw(base + url, "POST", body)) for url, body in POSTS]
            health = json.loads(_raw(base + "/lighthouse/health")[1])["data"]
            metrics = _raw(base + "/metrics")[1].decode().splitlines()
        finally:
            server.stop()
        answers.append((got, sorted(health), health["head_slot"],
                        [line for line in metrics if line.split(" ")[0] in CHAIN_GAUGES]))
    port, jax = answers
    for (url, ts, tbody), (_, js, jbody) in zip(port[0], jax[0]):
        assert (ts, tbody) == (js, jbody), url
    assert port[1:] == jax[1:]
    statuses = [s for _, s, _ in port[0]]
    assert statuses.count(200) >= 50 and {400, 404} <= set(statuses)
    assert port[2] == "3" and port[3] == ["beacon_head_slot 3", "beacon_finalized_epoch 0",
                                          "beacon_validator_count 16"]


def _keystores(pkg, V, signed):
    """LocalKeystores of interop keys 0-15. The port's record what they
    sign in `signed` by (key, root); the JAX package's give the port's
    signature over the same root (its own host signing, ~0.4 s a
    signature, is held to the port's by test_torch_validator_client.py)
    and their public keys from the port's bytes (jax_keys_from_port)."""
    out = []
    for i in range(N):
        if pkg is T:
            ks = V.LocalKeystore(T.interop_secret_key(i))

            def sign(root, ks=ks, i=i, own=ks.sign):
                sig = own(root)
                signed[i, bytes(root)] = sig.to_bytes()
                return sig
        else:
            ks = object.__new__(V.LocalKeystore)
            ks.secret_key, ks.pubkey = JI.interop_keypair(i)

            def sign(root, i=i):
                return japi.Signature.from_bytes(signed[i, bytes(root)])
        ks.sign = sign
        out.append(ks)
    return out


def _vc_epoch(pkg, H, V, harness, kwargs, Events, signed):
    h, server, base = _rig(pkg, H, V, harness, kwargs, blocks=0)
    try:
        live = H.BeaconNodeHttpClient(base, pkg.MINIMAL, timeout=TIMEOUT_S)
        dead = H.BeaconNodeHttpClient(f"http://127.0.0.1:{CS.closed_port()}", pkg.MINIMAL,
                                      timeout=TIMEOUT_S)
        probes = []
        healthy = dead.is_healthy
        dead.is_healthy = lambda: probes.append(healthy()) or probes[-1]
        store = V.ValidatorStore(pkg.MINIMAL, h.spec)
        for ks in _keystores(pkg, V, signed):
            store.add_validator(ks)
        events = Events()
        vc = V.ValidatorClient(store, V.BeaconNodeFallback([dead, live], events=events),
                               pkg.MINIMAL, h.spec)
        vc.graffiti = GRAFFITI
        heads = []
        for slot in range(1, SPE + 1):
            h.chain.slot_clock.set_slot(slot)
            h.chain.on_tick()
            vc.on_slot(slot)
            heads.append((bytes(h.chain.head_root), bytes(cached_root(h.chain.head_state))))
        head = h.store.get_block(h.chain.head_root)
        graffiti = bytes(head.message.body.graffiti).rstrip(b"\x00")
    finally:
        server.stop()
    return dict(heads=heads, proposed=[bytes(r) for r in vc.blocks_proposed],
                counts=(vc.attestations_published, vc.aggregates_published,
                        vc.sync_messages_published, vc.sync_contributions_published),
                errors=vc.duty_errors, graffiti=graffiti, probes=probes,
                events=events.events)


def test_validator_client_over_http_for_an_epoch_equals_jax():
    signed = {}
    port = _vc_epoch(*PORT, TEventLog, signed)
    jax = _vc_epoch(*JAX, JEventLog, signed)
    assert port == jax
    assert len(port["proposed"]) == SPE and port["heads"][-1][0] == port["proposed"][-1]
    assert port["counts"][0] >= N and port["counts"][1] > 0
    assert not port["errors"] and port["graffiti"] == GRAFFITI
    # randao and proposal a block, attestation, selection proof, aggregate a validator
    assert len(signed) == 2 * SPE + 3 * N
    # the closed port is probed and passed over at every duty
    assert len(port["probes"]) >= SPE and not any(port["probes"])


def _fallback_run(pkg, H, V, harness, kwargs, Events):
    h, server, base = _rig(pkg, H, V, harness, kwargs, blocks=1)
    try:
        live = H.BeaconNodeHttpClient(base, pkg.MINIMAL, timeout=TIMEOUT_S)
        other = H.BeaconNodeHttpClient(base, pkg.MINIMAL, timeout=TIMEOUT_S)
        dead = [H.BeaconNodeHttpClient(f"http://127.0.0.1:{CS.closed_port()}", pkg.MINIMAL,
                                       timeout=TIMEOUT_S) for _ in range(2)]
        events = Events()
        nodes = V.BeaconNodeFallback([other, live], events=events)

        def fn(node):
            if node is other:
                return node._get("/eth/v1/no/such/route")  # a failing call
            return node.syncing()

        out = [nodes.call(fn), nodes.best() is other, [n is live for n in nodes.ranked()]]
        for fallback in (V.BeaconNodeFallback(dead), V.BeaconNodeFallback([])):
            for call in (fallback.best, lambda: fallback.call(lambda node: node.genesis())):
                with pytest.raises(V.NoHealthyBeaconNode) as e:
                    call()
                out.append(str(e.value))
    finally:
        server.stop()
    return out, events.events


def test_fallback_failover_and_no_healthy_node_alike():
    port = _fallback_run(*PORT, TEventLog)
    jax = _fallback_run(*JAX, JEventLog)
    assert port == jax
    (syncing, *_), events = port
    assert int(syncing["head_slot"]) == 1
    assert events == [("bn_call_failed", ("error", "Eth2ClientError"), ("index", 0))]


@pytest.mark.gpu
def test_a_block_over_http_to_a_chain_on_the_card_gets_the_cpu_oracle_verdict():
    """A signed harness block and one with a forged attestation, posted over
    HTTP to a chain whose table is on the card (torch_cuda): the root and
    the refusal that a chain on the cpu oracle gives."""
    need_card()
    tapi.set_backend("cpu")
    spec = T.ChainSpec.minimal()
    src = BeaconChainHarness(N, T.MINIMAL, spec, sign=True, device="cpu")
    made, produce = [], src.producer.produce_block
    src.producer.produce_block = lambda *a, **k: made.append(produce(*a, **k)[0]) or made[-1:] + [None]
    root1 = src.add_block_at_slot(1)
    block = made[-1]
    C = CS.consensus_modules()
    forged, _ = CS.forged_harness_block(C, src, 2)
    src.chain.slot_clock.set_slot(2)
    with pytest.raises(Exception) as e:
        src.chain.process_block(forged, strategy=src.strategy)
    assert str(e.value) == CS.FORGED_BLOCK_ERROR

    tapi.set_backend("torch_cuda")
    dst = BeaconChainHarness(N, T.MINIMAL, spec, sign=True)
    assert dst.chain.pubkey_cache.device_table().device.type == "cuda"
    server = TH.BeaconApiServer(TH.BeaconApi(TV.InProcessBeaconNode(dst.chain)))
    server.start()
    try:
        client = TH.BeaconNodeHttpClient(f"http://127.0.0.1:{server.port}", T.MINIMAL,
                                         timeout=60.0)
        dst.chain.slot_clock.set_slot(2)
        assert client.publish_block(block) == root1 == dst.chain.head_root
        with pytest.raises(TH.Eth2ClientError, match=CS.FORGED_BLOCK_ERROR):
            client.publish_block(forged)
        assert dst.chain.head_root == root1
    finally:
        server.stop()

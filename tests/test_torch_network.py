"""The port's gossip network (lighthouse_tpu_torch/network/{message_bus,
peer_score,subnet_service,node,sync,simulator}.py) against the JAX
package's on the CPU, exact equality throughout:

- `topic_name` and the bus's delivery order, partitions and req/resp
  over the same seeded publishes;
- peer scores after the same seeded event sequence on a fixed clock
  (`PeerScorer`), and a node's scores and bans after the same penalties;
- `compute_subnet_for_attestation`, `compute_subscribed_subnets` and the
  subnet service's subscriptions over seeded inputs;
- `Simulator(2, 64, MINIMAL)` for 2 epochs on the `fake` backend in both
  packages (the port's with `device="cpu"`): the same head root, head
  state root and finalized checkpoint on every node, and a late joiner
  that range-syncs the same count of blocks to the same head.

The simulator's producer signs nothing (`StateHarness(..., sign=False)`,
as in the JAX package): its crypto is fake in both packages. The JAX
side takes its public keys from the port's bytes (`jax_keys_from_port`).
No XLA compile."""

import types

import numpy as np
import pytest

from lighthouse_tpu import network as JN
from lighthouse_tpu import types as J
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.chain.beacon_chain import BeaconChain as JBeaconChain
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.network import node as JNODE
from lighthouse_tpu.network import peer_score as JPS
from lighthouse_tpu.network import subnet_service as JSUB
from lighthouse_tpu.state_transition import clone_state as jclone
from lighthouse_tpu.store.hot_cold import HotColdDB as JHotColdDB
from lighthouse_tpu.store.kv import MemoryStore as JMemoryStore
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu_torch import network as TN
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain as TBeaconChain
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.network import node as TNODE
from lighthouse_tpu_torch.network import peer_score as TPS
from lighthouse_tpu_torch.network import subnet_service as TSUB
from lighthouse_tpu_torch.ssz import cached_root
from lighthouse_tpu_torch.state_transition import clone_state as tclone
from lighthouse_tpu_torch.store.hot_cold import HotColdDB as THotColdDB
from lighthouse_tpu_torch.store.kv import MemoryStore as TMemoryStore
from torch_port_util import jax_keys_from_port, no_xla_compile

KINDS = ("beacon_block", "beacon_aggregate_and_proof", "beacon_attestation",
         "sync_committee", "voluntary_exit", "proposer_slashing")


@pytest.fixture
def fake_backends():
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topic_names(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        digest = bytes(rng.integers(0, 256, 4, dtype=np.uint8))
        kind = KINDS[int(rng.integers(len(KINDS)))]
        subnet = None if rng.integers(2) else int(rng.integers(64))
        assert TN.topic_name(kind, digest, subnet) == JN.topic_name(kind, digest, subnet)


def _bus_trace(N, seed):
    """The same seeded subscriptions, publishes, partitions and requests on
    one package's MessageBus: what each handler saw, in order, and each
    publish's delivery count."""
    rng = np.random.default_rng(seed)
    bus, seen = N.MessageBus(), []
    peers = [f"p{i}" for i in range(5)]
    topics = [N.topic_name("beacon_attestation", b"\x01\x02\x03\x04", s) for s in range(3)]
    for p in peers:
        for t in topics:
            if rng.integers(3):
                bus.subscribe(p, t, lambda payload, src, p=p, t=t: seen.append(
                    (p, t, payload, src)))
        bus.register_rpc(p, "ping", lambda payload, src, p=p: (p, payload, src))
    counts, replies = [], []
    for step in range(40):
        if step == 15:
            bus.set_partitions([peers[:2], peers[2:4]])
        if step == 30:
            bus.heal()
        src, t = peers[int(rng.integers(5))], topics[int(rng.integers(3))]
        counts.append(bus.publish(src, t, step))
        a, b = peers[int(rng.integers(5))], peers[int(rng.integers(5))]
        try:
            replies.append(bus.request(a, b, "ping", step))
        except ConnectionError as e:
            replies.append(str(e))
    bus.disconnect(peers[0])
    counts.append(bus.publish(peers[1], topics[0], "after"))
    return seen, counts, replies, [m.topic for m in bus.published], bus.peers_on(topics[0])


@pytest.mark.parametrize("seed", [3, 4])
def test_message_bus_delivers_in_the_same_order(seed):
    assert _bus_trace(TN, seed) == _bus_trace(JN, seed)


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("seed", [5, 6])
def test_peer_scores_after_the_same_events(monkeypatch, seed):
    """PeerScorer on a fixed clock: every peer's score, graylist and
    prune verdicts after the same seeded grafts, deliveries, invalid
    messages, behaviour penalties, prunes and clock steps."""
    out = []
    for PS in (JPS, TPS):
        clock = _Clock()
        monkeypatch.setattr(PS, "time", types.SimpleNamespace(monotonic=clock.monotonic))
        rng = np.random.default_rng(seed)
        scorer, trace = PS.PeerScorer(), []
        peers, topics = ["a", "b", "c"], ["t0", "t1"]
        for _ in range(60):
            op = int(rng.integers(6))
            p, t = peers[int(rng.integers(3))], topics[int(rng.integers(2))]
            if op == 0:
                scorer.on_graft(p, t)
            elif op == 1:
                scorer.on_deliver(p, t, bool(rng.integers(2)))
            elif op == 2:
                scorer.on_invalid(p, t)
            elif op == 3:
                scorer.on_behaviour_penalty(p, float(rng.integers(1, 4)) / 2)
            elif op == 4:
                scorer.on_prune(p, t)
            clock.now += float(rng.integers(0, 40))
            trace.append([(round(scorer.score(q), 9), scorer.graylisted(q),
                           scorer.should_prune(q)) for q in peers])
        out.append(trace)
    assert out[0] == out[1]


def test_subnet_computation_over_seeded_inputs():
    rng = np.random.default_rng(7)
    jspec, tspec = J.ChainSpec.interop(), T.ChainSpec.interop()
    for preset in ("MINIMAL", "MAINNET"):
        jp, tp = getattr(J, preset), getattr(T, preset)
        for _ in range(200):
            cps, slot, index = (int(rng.integers(1, 65)), int(rng.integers(0, 1 << 20)),
                                int(rng.integers(0, 64)))
            assert TSUB.compute_subnet_for_attestation(cps, slot, index, tp, tspec) == \
                JSUB.compute_subnet_for_attestation(cps, slot, index, jp, jspec)
    for _ in range(50):
        node_id = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        epoch = int(rng.integers(0, 1 << 16))
        assert TSUB.compute_subscribed_subnets(node_id, epoch, tspec) == \
            JSUB.compute_subscribed_subnets(node_id, epoch, jspec)


def test_subnet_service_subscriptions():
    """The same slot and duty sequence: the same subscribe, unsubscribe and
    ENR-update callbacks, in order."""
    out = []
    for SUB, P, spec in ((JSUB, J.MINIMAL, J.ChainSpec.interop()),
                         (TSUB, T.MINIMAL, T.ChainSpec.interop())):
        log = []
        svc = SUB.AttestationSubnetService(
            b"\x42" * 32, P, spec, subscribe_cb=lambda s: log.append(("sub", s)),
            unsubscribe_cb=lambda s: log.append(("unsub", s)),
            enr_update_cb=lambda subnets: log.append(("enr", tuple(subnets))),
            epochs_per_subscription=2)
        for slot in range(0, 64, 3):
            if slot % 9 == 0:
                log.append(("duty", svc.subscribe_for_duty(slot + 2, 1 + slot % 4, slot % 3)))
            svc.on_slot(slot)
            log.append(("active", tuple(sorted(svc.active_subnets()))))
        out.append((log, dict(svc.stats)))
    assert out[0] == out[1]


def _view(chain, state_root):
    return (chain.head_root, state_root, chain.finalized_checkpoint,
            chain.justified_checkpoint)


def test_simulator_two_epochs_and_a_late_joiner(monkeypatch, fake_backends):
    """Two nodes for 2 epochs of MINIMAL in each package: every node the
    same head, head state root and checkpoints; a late joiner from genesis
    range-syncs from node0 the same count of blocks to the same head; the
    same penalties give the same scores and bans."""
    jax_keys_from_port(monkeypatch)
    monkeypatch.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)
    jsim = JN.Simulator(2, 64, J.MINIMAL, J.ChainSpec.interop())
    tsim = TN.Simulator(2, 64, T.MINIMAL, T.ChainSpec.interop(), device="cpu")
    assert all(n.chain.pubkey_cache.device_table().device.type == "cpu" for n in tsim.nodes)
    jsim.run_epochs(2)
    tsim.run_epochs(2)
    jhead, thead = jsim.check_all_heads_equal(), tsim.check_all_heads_equal()
    assert thead == jhead
    for jn, tn in zip(jsim.nodes, tsim.nodes):
        assert _view(tn.chain, cached_root(tn.chain.head_state)) == _view(
            jn.chain, jn.chain.head_state.tree_hash_root())
    assert tsim.nodes[0].chain.head_state.slot == 2 * T.MINIMAL.slots_per_epoch

    jlate = JN.NetworkNode("late", JBeaconChain(
        JHotColdDB(JMemoryStore(), J.MINIMAL, jsim.spec), jclone(jsim.genesis),
        J.MINIMAL, jsim.spec), jsim.bus)
    tlate = TN.NetworkNode("late", TBeaconChain(
        THotColdDB(TMemoryStore(), T.MINIMAL, tsim.spec), tclone(tsim.genesis),
        T.MINIMAL, tsim.spec, device="cpu"), tsim.bus)
    got = tlate.sync_with("node0")
    assert got == jlate.sync_with("node0") == 2 * T.MINIMAL.slots_per_epoch
    assert tlate.chain.head_root == jlate.chain.head_root == thead

    for node, N in ((jsim.nodes[1], JNODE), (tsim.nodes[1], TNODE)):
        for peer, amount in (("x", None), ("x", -1), ("y", None)) + (("x", None),) * 4:
            node.penalize(peer) if amount is None else node.penalize(peer, amount)
    assert tsim.nodes[1].peer_scores == jsim.nodes[1].peer_scores == {"x": -51, "y": -10}
    assert [tsim.nodes[1].is_banned(p) for p in "xyz"] == [
        jsim.nodes[1].is_banned(p) for p in "xyz"] == [True, False, False]
    assert TNODE.GOSSIP_PENALTY == JNODE.GOSSIP_PENALTY
    assert TNODE.BAN_THRESHOLD == JNODE.BAN_THRESHOLD


def test_simulator_builds_every_chain_on_its_device(monkeypatch):
    """`device` reaches every chain the simulator builds: the nodes, an
    added one and a reopened one; None (the default) is the card."""
    seen = []
    from lighthouse_tpu_torch.network import simulator as TSIM

    real = TSIM.BeaconChain

    class Spy(real):
        def __init__(self, *args, device=None, **kwargs):
            seen.append(device)
            super().__init__(*args, device=device, **kwargs)

        @classmethod
        def from_store(cls, *args, device=None, **kwargs):
            seen.append(("from_store", device))
            return real.from_store(*args, device=device, **kwargs)

    monkeypatch.setattr(TSIM, "BeaconChain", Spy)
    sim = TN.Simulator(1, 16, T.MINIMAL, T.ChainSpec.interop(), device="cpu")
    sim.add_node()
    sim.reopen_node(sim.nodes[0])
    assert seen == ["cpu", "cpu", ("from_store", "cpu")]
    import inspect

    assert inspect.signature(TN.Simulator).parameters["device"].default is None

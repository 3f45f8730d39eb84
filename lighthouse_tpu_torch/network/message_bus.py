"""In-process network fabric (the transport seat of reference
beacon_node/lighthouse_network's libp2p stack, exercised the way the
reference tests distribution: testing/simulator spawns N in-process nodes
on one runtime, node_test_rig/src/lib.rs:32-60 -- not a real cluster).

`MessageBus` provides gossipsub-shaped topics (fork-digest namespaced,
types/topics.rs) with per-peer subscriptions and delivery journals, plus
direct req/resp channels (the rpc/ protocols). A real libp2p wire backend
can replace the bus behind the same Router-facing API; ICI/DCN enters only
for intra-pod signature-batch sharding (SURVEY.md section 5).

The port's copy of lighthouse_tpu/network/message_bus.py.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


def topic_name(kind: str, fork_digest: bytes, subnet: int | None = None) -> str:
    """Gossip topic naming (reference types/topics.rs):
    /eth2/<fork_digest>/<kind>[_<subnet>]/ssz_snappy."""
    base = f"/eth2/{fork_digest.hex()}/{kind}"
    if subnet is not None:
        base += f"_{subnet}"
    return base + "/ssz_snappy"


@dataclass
class GossipMessage:
    topic: str
    payload: object
    source_peer: str


class MessageBus:
    """Broadcast plane + req/resp plane for in-process multi-node tests.

    Supports transport-level network splits (the scenario harness's
    partition phases): while a partition map is installed, gossip only
    delivers and req/resp only connects between peers in the SAME group;
    cross-group requests raise ``ConnectionError`` exactly like a dead
    TCP route, so sync's retry/penalty machinery runs for real. Peers
    absent from the map sit in the default group (healed side)."""

    def __init__(self):
        self._subs: dict[str, dict[str, object]] = defaultdict(dict)
        self._rpc_handlers: dict[str, dict[str, object]] = defaultdict(dict)
        self.published: list[GossipMessage] = []
        # peer -> partition group id; empty dict == fully connected
        self._groups: dict[str, int] = {}

    # -- partitions (scenario harness: bus-level split + heal) ---------------

    def set_partitions(self, groups) -> None:
        """Install a network split: ``groups`` is an iterable of peer-id
        collections; peers in different collections cannot reach each
        other. Replaces any previous split."""
        self._groups = {}
        for gid, peers in enumerate(groups):
            for peer in peers:
                self._groups[peer] = gid

    def heal(self) -> None:
        """Remove the split: every peer reaches every peer again."""
        self._groups = {}

    def partitioned(self) -> bool:
        return bool(self._groups)

    def join_group(self, peer_id: str, like_peer: str) -> None:
        """Place `peer_id` in the same partition group as `like_peer`
        (a Byzantine injector must share its victims' side of a split to
        reach them); no-op while the bus is unpartitioned."""
        if not self._groups:
            return
        gid = self._groups.get(like_peer)
        if gid is None:
            self._groups.pop(peer_id, None)
        else:
            self._groups[peer_id] = gid

    def reachable(self, a: str, b: str) -> bool:
        if not self._groups:
            return True
        return self._groups.get(a, -1) == self._groups.get(b, -1)

    # -- node lifecycle (scenario harness: churn + crash) --------------------

    def disconnect(self, peer_id: str) -> None:
        """Drop a peer entirely: all topic subscriptions and rpc
        registrations (node leave / simulated process death). A later
        re-subscribe under the same peer id rejoins cleanly."""
        for subs in self._subs.values():
            subs.pop(peer_id, None)
        for handlers in self._rpc_handlers.values():
            handlers.pop(peer_id, None)
        self._groups.pop(peer_id, None)

    # -- gossip --------------------------------------------------------------

    def subscribe(self, peer_id: str, topic: str, handler) -> None:
        self._subs[topic][peer_id] = handler

    def unsubscribe(self, peer_id: str, topic: str) -> None:
        self._subs[topic].pop(peer_id, None)

    def publish(self, source_peer: str, topic: str, payload) -> int:
        """Deliver to every reachable subscriber except the source;
        returns the delivery count (gossipsub loopback exclusion)."""
        self.published.append(GossipMessage(topic, payload, source_peer))
        delivered = 0
        for peer_id, handler in list(self._subs.get(topic, {}).items()):
            if peer_id == source_peer:
                continue
            if not self.reachable(source_peer, peer_id):
                continue
            handler(payload, source_peer)
            delivered += 1
        return delivered

    # -- req/resp (rpc/) -----------------------------------------------------

    def register_rpc(self, peer_id: str, protocol: str, handler) -> None:
        self._rpc_handlers[protocol][peer_id] = handler

    def request(self, from_peer: str, to_peer: str, protocol: str, payload):
        if not self.reachable(from_peer, to_peer):
            raise ConnectionError(
                f"peer {to_peer} unreachable from {from_peer} (partition)"
            )
        handler = self._rpc_handlers.get(protocol, {}).get(to_peer)
        if handler is None:
            raise ConnectionError(
                f"peer {to_peer} does not speak {protocol}"
            )
        return handler(payload, from_peer)

    def peers_on(self, topic: str) -> list[str]:
        return list(self._subs.get(topic, {}).keys())

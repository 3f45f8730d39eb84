"""Deterministic socket fabric for the scenario harness: the full
in-process `MessageBus` API (subscribe / publish / request / partitions /
churn) realized over one real `WireBus` TCP endpoint per peer, so every
scenario plan can run with ``transport="wire"`` — same invariants, same
bit-identical replay — while every payload actually crosses a socket as
SSZ + snappy frames through `WireCodec`.

Determinism is the design center, and it comes from ONE rule: gossip is
delivered as a SYNCHRONOUS req/resp exchange (`FABRIC_GOSSIP`), never as
a fire-and-forget push. `publish` walks the fabric's insertion-ordered
subscriber registry and performs one blocking exchange per target; the
receiver's handler runs to completion (on its server thread) before the
ack releases the sender, so the whole network advances one handler at a
time in registry order — exactly the memory bus's schedule, with TCP
framing, snappy, and SSZ decode on the path. The gossipsub mesh
machinery inside `WireBus` stays dormant: peers are cross-registered
with EMPTY topic sets (no GRAFT traffic, no mesh randomness), and the
per-connection token buckets are opened wide (the fabric is a harness
transport, not a DoS surface).

Partitions/heal/join_group are enforced at the fabric layer (the
sockets themselves stay up): an unreachable `request` raises
``ConnectionError`` exactly like the memory bus, so FaultPlan wrapping
and sync's retry/penalty machinery behave identically on both
transports. Synthetic sources ("byz", "byzvc") get a lazily-created
injector endpoint that subscribes to nothing but can dial everyone.

The port's copy of lighthouse_tpu/network/wire_fabric.py.
"""

from __future__ import annotations

import random

from .wire import WireBus

FABRIC_GOSSIP = "/lighthouse-tpu/fabric_gossip/1/ssz_snappy"


class WireFabric:
    """MessageBus-compatible fabric over per-peer WireBus sockets."""

    def __init__(self, seed: int = 0, host: str = "127.0.0.1"):
        self.seed = int(seed)
        self.host = host
        self._preset = None  # bound at first subscribe/register (node ctor)
        self._buses: dict[str, WireBus] = {}
        # topic -> {peer_id -> handler}; insertion order IS the delivery
        # schedule (the memory bus's defaultdict(dict) semantics)
        self._subs: dict[str, dict[str, object]] = {}
        # peer -> partition group id; empty == fully connected
        self._groups: dict[str, int] = {}
        self._spawned = 0

    # -- endpoint lifecycle --------------------------------------------------

    def _bind_preset(self, preset) -> None:
        if self._preset is None:
            self._preset = preset

    def _ensure_bus(self, peer_id: str) -> WireBus:
        bus = self._buses.get(peer_id)
        if bus is not None:
            return bus
        if self._preset is None:
            from ..types import MINIMAL

            self._preset = MINIMAL
        self._spawned += 1
        bus = WireBus(
            self._preset,
            host=self.host,
            # harness transport: rate limiting off (gossip rides req/resp)
            req_burst=1e9,
            req_rate_per_s=1e9,
            # mesh machinery is dormant but its rng must still be seeded
            # (replay) and per-peer (lint rule `nondeterminism`)
            rng=random.Random(self.seed * 1000003 + self._spawned),
        )
        bus.listen(peer_id, port=0)
        bus.register_rpc(peer_id, FABRIC_GOSSIP, self._make_delivery(peer_id))
        # cross-register with every existing endpoint, BOTH directions,
        # with empty topic interests: the fabric owns routing, the bus
        # only dials. Re-records after churn refresh a stale host/port.
        for other_id, other in self._buses.items():
            other._record_peer(
                {
                    "peer_id": peer_id,
                    "host": bus.host,
                    "port": bus.port,
                    "topics": [],
                }
            )
            bus._record_peer(
                {
                    "peer_id": other_id,
                    "host": other.host,
                    "port": other.port,
                    "topics": [],
                }
            )
        self._buses[peer_id] = bus
        return bus

    def _make_delivery(self, peer_id: str):
        def deliver(req: dict, source: str):
            handler = self._subs.get(req["topic"], {}).get(peer_id)
            if handler is not None:
                handler(req["payload"], source)
            return None

        return deliver

    def close(self) -> None:
        for bus in self._buses.values():
            bus.stop()
        self._buses.clear()
        self._subs.clear()
        self._groups.clear()

    # -- partitions (MessageBus API) -----------------------------------------

    def set_partitions(self, groups) -> None:
        self._groups = {}
        for gid, peers in enumerate(groups):
            for peer in peers:
                self._groups[peer] = gid

    def heal(self) -> None:
        self._groups = {}

    def partitioned(self) -> bool:
        return bool(self._groups)

    def join_group(self, peer_id: str, like_peer: str) -> None:
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

    # -- node lifecycle ------------------------------------------------------

    def disconnect(self, peer_id: str) -> None:
        for subs in self._subs.values():
            subs.pop(peer_id, None)
        self._groups.pop(peer_id, None)
        bus = self._buses.pop(peer_id, None)
        if bus is not None:
            bus.stop()

    # -- gossip --------------------------------------------------------------

    def subscribe(self, peer_id: str, topic: str, handler) -> None:
        self._ensure_bus(peer_id)
        self._subs.setdefault(topic, {})[peer_id] = handler

    def unsubscribe(self, peer_id: str, topic: str) -> None:
        self._subs.get(topic, {}).pop(peer_id, None)

    def publish(self, source_peer: str, topic: str, payload) -> int:
        src = self._ensure_bus(source_peer)
        data = src.codec.encode_gossip(topic, payload)
        delivered = 0
        for peer_id in list(self._subs.get(topic, {})):
            if peer_id == source_peer:
                continue
            if not self.reachable(source_peer, peer_id):
                continue
            if peer_id not in self._buses:
                continue  # mid-churn straggler entry
            src.request(
                source_peer,
                peer_id,
                FABRIC_GOSSIP,
                {"topic": topic, "data": data},
            )
            delivered += 1
        return delivered

    # -- req/resp ------------------------------------------------------------

    def register_rpc(self, peer_id: str, protocol: str, handler) -> None:
        self._ensure_bus(peer_id).register_rpc(peer_id, protocol, handler)

    def request(self, from_peer: str, to_peer: str, protocol: str, payload):
        if not self.reachable(from_peer, to_peer):
            raise ConnectionError(
                f"peer {to_peer} unreachable from {from_peer} (partition)"
            )
        if to_peer not in self._buses:
            raise ConnectionError(f"peer {to_peer} does not speak {protocol}")
        return self._ensure_bus(from_peer).request(
            from_peer, to_peer, protocol, payload
        )

    def peers_on(self, topic: str) -> list[str]:
        return list(self._subs.get(topic, {}).keys())

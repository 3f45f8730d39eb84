"""Gossipsub behavioral peer scoring (reference beacon_node/
lighthouse_network/src/service/gossipsub_scoring_parameters.rs +
gossipsub's peer_score.rs): per-peer, per-topic counters combined into
one score that gates mesh membership and message acceptance.

Components (the reference's P-weights, reduced to the counters this wire
stack can observe):
  P1  time in mesh        — small positive, capped
  P2  first deliveries    — positive, decaying, capped (rewards peers
                            that deliver NEW messages fast)
  P3  mesh delivery deficit — squared penalty when a MESH peer delivers
                            fewer messages than the topic's floor
  P4  invalid messages    — squared penalty, heavy (application
                            validation failures reported by the node)
  P7  behaviour penalty   — squared penalty (protocol misbehaviour:
                            graft floods etc.)

Decay is applied lazily from timestamps: no heartbeat thread. Scores
below `graylist_threshold` drop the peer's frames at the door; below
`prune_threshold` the peer is evicted from topic meshes.

The port's copy of lighthouse_tpu/network/peer_score.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class TopicParams:
    topic_weight: float = 1.0
    time_in_mesh_weight: float = 0.033
    time_in_mesh_quantum_s: float = 12.0
    time_in_mesh_cap: float = 300.0
    first_deliveries_weight: float = 1.0
    first_deliveries_decay_s: float = 60.0
    first_deliveries_cap: float = 100.0
    mesh_deliveries_weight: float = -1.0
    mesh_deliveries_floor: float = 4.0
    mesh_deliveries_decay_s: float = 60.0
    mesh_deliveries_activation_s: float = 12.0
    invalid_weight: float = -20.0
    invalid_decay_s: float = 600.0


@dataclass
class _TopicStats:
    mesh_since: float | None = None
    first_deliveries: float = 0.0
    mesh_deliveries: float = 0.0
    invalid: float = 0.0
    last_decay: float = field(default_factory=time.monotonic)


@dataclass
class _PeerStats:
    topics: dict[str, _TopicStats] = field(default_factory=dict)
    behaviour_penalty: float = 0.0
    last_decay: float = field(default_factory=time.monotonic)


BEHAVIOUR_DECAY_S = 600.0


class PeerScorer:
    """Score bookkeeping. Internally locked: events arrive from bus
    reader threads, sync workers, and gossip validators concurrently."""

    def __init__(
        self,
        params: TopicParams | None = None,
        gossip_threshold: float = -10.0,
        prune_threshold: float = -40.0,
        graylist_threshold: float = -80.0,
    ):
        import threading

        self.params = params or TopicParams()
        self.gossip_threshold = gossip_threshold
        self.prune_threshold = prune_threshold
        self.graylist_threshold = graylist_threshold
        self._peers: dict[str, _PeerStats] = {}
        # per-topic last delivery from ANYONE: a quiet topic is the
        # topic's lull, not every mesh peer's fault — P3 deficits only
        # apply while the topic is demonstrably active
        self._topic_last_delivery: dict[str, float] = {}
        self._lock = threading.RLock()

    # -- event feeds ---------------------------------------------------------

    def _peer(self, peer_id: str) -> _PeerStats:
        p = self._peers.get(peer_id)
        if p is None:
            p = self._peers[peer_id] = _PeerStats()
        return p

    def _topic(self, peer_id: str, topic: str) -> _TopicStats:
        p = self._peer(peer_id)
        t = p.topics.get(topic)
        if t is None:
            t = p.topics[topic] = _TopicStats()
        return t

    def on_graft(self, peer_id: str, topic: str) -> None:
        with self._lock:
            t = self._topic(peer_id, topic)
            if t.mesh_since is None:
                t.mesh_since = time.monotonic()

    def on_prune(self, peer_id: str, topic: str) -> None:
        with self._lock:
            t = self._topic(peer_id, topic)
            t.mesh_since = None
            t.mesh_deliveries = 0.0

    def on_deliver(self, peer_id: str, topic: str, first: bool) -> None:
        with self._lock:
            self._topic_last_delivery[topic] = time.monotonic()
            t = self._topic(peer_id, topic)
            self._decay_topic(t)
            if first:
                t.first_deliveries = min(
                    t.first_deliveries + 1.0,
                    self.params.first_deliveries_cap,
                )
            if t.mesh_since is not None:
                t.mesh_deliveries += 1.0

    def on_invalid(self, peer_id: str, topic: str = "") -> None:
        with self._lock:
            t = self._topic(peer_id, topic)
            self._decay_topic(t)
            t.invalid += 1.0

    def on_behaviour_penalty(self, peer_id: str, amount: float = 1.0) -> None:
        with self._lock:
            p = self._peer(peer_id)
            self._decay_behaviour(p)
            p.behaviour_penalty += amount

    def forget(self, peer_id: str) -> None:
        """Disconnected peers release their stats (bounded memory)."""
        with self._lock:
            self._peers.pop(peer_id, None)

    # -- decay (lazy; exponential with per-component half-life) -------------

    @staticmethod
    def _decay(value: float, elapsed: float, half_life: float) -> float:
        if value == 0.0 or elapsed <= 0.0:
            return value
        return value * (0.5 ** (elapsed / half_life))

    def _decay_topic(self, t: _TopicStats) -> None:
        now = time.monotonic()
        dt = now - t.last_decay
        t.last_decay = now
        t.first_deliveries = self._decay(
            t.first_deliveries, dt, self.params.first_deliveries_decay_s
        )
        t.mesh_deliveries = self._decay(
            t.mesh_deliveries, dt, self.params.mesh_deliveries_decay_s
        )
        t.invalid = self._decay(t.invalid, dt, self.params.invalid_decay_s)

    def _decay_behaviour(self, p: _PeerStats) -> None:
        now = time.monotonic()
        p.behaviour_penalty = self._decay(
            p.behaviour_penalty, now - p.last_decay, BEHAVIOUR_DECAY_S
        )
        p.last_decay = now

    # -- the score -----------------------------------------------------------

    def score(self, peer_id: str) -> float:
        with self._lock:
            p = self._peers.get(peer_id)
            if p is None:
                return 0.0
            self._decay_behaviour(p)
            pr = self.params
            now = time.monotonic()
            total = 0.0
            for topic, t in p.topics.items():
                self._decay_topic(t)
                s = 0.0
                if t.mesh_since is not None:
                    in_mesh = now - t.mesh_since
                    s += pr.time_in_mesh_weight * min(
                        in_mesh / pr.time_in_mesh_quantum_s,
                        pr.time_in_mesh_cap,
                    )
                    # P3: an established mesh peer must pull its weight —
                    # but only while the TOPIC is demonstrably active
                    last = self._topic_last_delivery.get(topic)
                    topic_active = (
                        last is not None
                        and now - last < pr.mesh_deliveries_decay_s
                    )
                    if (
                        topic_active
                        and in_mesh > pr.mesh_deliveries_activation_s
                    ):
                        deficit = max(
                            pr.mesh_deliveries_floor - t.mesh_deliveries, 0.0
                        )
                        s += pr.mesh_deliveries_weight * deficit * deficit
                s += pr.first_deliveries_weight * t.first_deliveries
                s += pr.invalid_weight * t.invalid * t.invalid
                total += pr.topic_weight * s
            total += -1.0 * p.behaviour_penalty * p.behaviour_penalty
            return total

    def graylisted(self, peer_id: str) -> bool:
        return self.score(peer_id) < self.graylist_threshold

    def should_prune(self, peer_id: str) -> bool:
        return self.score(peer_id) < self.prune_threshold

"""Bounded SSE fan-out (reference beacon_chain/src/events.rs: a
broadcast channel per event kind with a fixed capacity). Two pieces:

- ``EventRing`` — the bounded replay journal behind ``api.events``: the
  debug view of recent chain events, evicting oldest-first with a drop
  counter instead of growing without bound.
- ``EventBroadcaster``/``Subscriber`` — the live path: each subscriber
  owns a fixed-size ring buffer drained by its HTTP streaming thread; a
  slow consumer loses its own oldest events (counted) and never blocks
  the chain's emit path or any other subscriber. Subscriptions above
  the concurrency cap are refused, so total SSE memory is
  ``max_subscribers * buffer`` events by construction.

The port's copy of lighthouse_tpu/serving/sse.py.
"""

from __future__ import annotations

import threading
from collections import deque

from ..utils import metrics as M


class EventRing:
    """Bounded (kind, payload) journal, oldest-first eviction."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, int(capacity))
        self._items: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, item) -> None:
        with self._lock:
            if len(self._items) == self.capacity:
                self.dropped += 1
                M.SERVING_EVENT_RING_DROPPED.inc()
            self._items.append(item)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._items)

    def __iter__(self):
        return iter(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def __getitem__(self, idx):
        return self.snapshot()[idx]


class Subscriber:
    """One consumer's bounded buffer; pushed by the broadcaster, popped
    by the HTTP streaming thread."""

    def __init__(self, topics: frozenset | None, capacity: int):
        self.topics = topics  # None = all kinds
        self.capacity = max(1, int(capacity))
        self._buf: deque = deque()
        self._cond = threading.Condition()
        self.dropped = 0
        self.closed = False

    def wants(self, kind: str) -> bool:
        return self.topics is None or kind in self.topics

    def push(self, kind: str, payload) -> None:
        with self._cond:
            if self.closed:
                return
            if len(self._buf) >= self.capacity:
                self._buf.popleft()
                self.dropped += 1
                M.SERVING_SSE_DROPPED.inc()
            self._buf.append((kind, payload))
            self._cond.notify()

    def pop(self, timeout: float = 0.25):
        """Next (kind, payload), or None on timeout/close — callers
        check `.closed` to tell the two apart."""
        with self._cond:
            if not self._buf and not self.closed:
                self._cond.wait(timeout)
            if self._buf:
                return self._buf.popleft()
            return None

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()


class EventBroadcaster:
    def __init__(self, max_subscribers: int = 64, buffer: int = 256):
        self.max_subscribers = max(1, int(max_subscribers))
        self.buffer = buffer
        self._subs: list[Subscriber] = []
        self._lock = threading.Lock()
        self.rejected = 0
        self.published = 0

    def subscribe(self, topics=None) -> Subscriber | None:
        """A new subscriber, or None when the cap is reached (the HTTP
        layer answers 503: refusing is cheaper than unbounded memory)."""
        topic_set = frozenset(topics) if topics else None
        with self._lock:
            if len(self._subs) >= self.max_subscribers:
                self.rejected += 1
                M.SERVING_SSE_REJECTED.inc()
                return None
            sub = Subscriber(topic_set, self.buffer)
            self._subs.append(sub)
            M.SERVING_SSE_SUBSCRIBERS.set(len(self._subs))
            return sub

    def unsubscribe(self, sub: Subscriber) -> None:
        sub.close()
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
            M.SERVING_SSE_SUBSCRIBERS.set(len(self._subs))

    def publish(self, kind: str, payload) -> None:
        with self._lock:
            subs = list(self._subs)
            self.published += 1
        for sub in subs:
            if sub.wants(kind):
                sub.push(kind, payload)

    @property
    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def close(self) -> None:
        """Wake and detach every subscriber (server shutdown)."""
        with self._lock:
            subs, self._subs = list(self._subs), []
            M.SERVING_SSE_SUBSCRIBERS.set(0)
        for sub in subs:
            sub.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "subscribers": len(self._subs),
                "rejected": self.rejected,
                "published": self.published,
                "dropped": sum(s.dropped for s in self._subs),
            }

"""Anchored HTTP response cache (the serving tier's read-path fan-out
absorber): entries are keyed on ``(route, normalized params, anchor)``
where the anchor pins the chain view the response was computed against —
the finalized epoch for finalized-data routes, the head root for
head-relative routes, a constant for immutable data (genesis, spec,
root-addressed objects). A head or finality event moves the anchor, so
stale entries are dropped by key-kind instead of by TTL: correctness
comes from the chain's own event stream, not from a clock.

Every cached body carries a deterministic weak ETag so clients can
revalidate with ``If-None-Match`` and be answered ``304 Not Modified``
without a byte of payload.

The port's copy of lighthouse_tpu/serving/cache.py.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass

from ..utils import metrics as M

# anchor kinds
IMMUTABLE = "immutable"
FINALIZED = "finalized"
HEAD = "head"

# routes whose payload is fixed for the life of the process (or is
# content-addressed): cache without any chain anchor
_IMMUTABLE_PATHS = frozenset(
    {
        "/eth/v1/beacon/genesis",
        "/eth/v1/config/spec",
        "/eth/v1/config/fork_schedule",
        "/eth/v1/config/deposit_contract",
        "/eth/v1/node/version",
        "/eth/v1/node/identity",
    }
)

# never cached: mutating surfaces, pool views that change on gossip (no
# chain event fires), validator duty production, node/ops introspection,
# and the streaming/metrics endpoints themselves
_UNCACHEABLE_PREFIXES = (
    "/eth/v1/beacon/pool/",
    "/eth/v1/validator/",
    "/eth/v2/validator/",
    "/eth/v1/node/",
    "/eth/v1/events",
    "/lighthouse/",
    "/metrics",
)


def classify_anchor(method: str, path: str) -> str | None:
    """Which anchor kind governs this route's freshness, or None when
    the route must bypass the cache entirely."""
    if method != "GET":
        return None
    if path in _IMMUTABLE_PATHS:
        return IMMUTABLE
    if path.startswith(_UNCACHEABLE_PREFIXES):
        return None
    segments = path.split("/")
    # root-addressed blocks/states are content-addressed: immutable
    if any(s.startswith("0x") for s in segments):
        return IMMUTABLE
    if "genesis" in segments:
        return IMMUTABLE
    if "finalized" in segments or "finality_update" in segments:
        return FINALIZED
    return HEAD


def make_etag(body: bytes) -> str:
    """Deterministic weak validator over the response bytes."""
    return 'W/"' + hashlib.sha1(body).hexdigest()[:20] + '"'


@dataclass
class CacheEntry:
    body: bytes
    content_type: str
    etag: str
    kind: str
    anchor: object


class _Flight:
    """One in-flight computation of a cache key (singleflight): the
    leader computes, followers wait on the event and read the entry (or
    the error) off the flight object — the flight may outlive its slot
    in the flights dict and the entry may already be LRU-evicted from
    the cache by the time a follower wakes, so the result rides HERE."""

    __slots__ = ("event", "entry", "error")

    def __init__(self):
        self.event = threading.Event()
        self.entry: CacheEntry | None = None
        self.error: BaseException | None = None


class ResponseCache:
    """LRU-bounded map of response bytes, invalidated by anchor moves."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = max(1, int(max_entries))
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.coalesced = 0
        # singleflight: key -> in-flight leader computation
        self._flights: dict[tuple, _Flight] = {}

    @staticmethod
    def key(path: str, params: dict, kind: str, anchor) -> tuple:
        return (path, tuple(sorted(params.items())), kind, anchor)

    def lookup(self, key: tuple) -> CacheEntry | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                M.SERVING_CACHE_MISSES.inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            M.SERVING_CACHE_HITS.inc()
            return entry

    def store(
        self, key: tuple, body: bytes, content_type: str, etag: str
    ) -> None:
        path, _params, kind, anchor = key
        with self._lock:
            self._entries[key] = CacheEntry(
                body, content_type, etag, kind, anchor
            )
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            M.SERVING_CACHE_ENTRIES.set(len(self._entries))

    def get_or_compute(
        self, key: tuple, compute, timeout: float = 10.0
    ) -> tuple[CacheEntry, str]:
        """Singleflight read-through: a hit returns immediately; on a
        miss, N concurrent callers of the same key run ONE `compute()`
        (`() -> (body, content_type, etag)`) — the first caller leads,
        the rest block on its result and are counted as coalesced.
        Returns (entry, outcome) with outcome in {"hit", "miss",
        "coalesced"}. A leader failure (or follower timeout) degrades
        each follower to computing for itself — coalescing is an
        optimization, never a correctness dependency."""
        entry = self.lookup(key)
        if entry is not None:
            return entry, "hit"
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = self._flights[key] = _Flight()
                leader = True
            else:
                leader = False
        if not leader:
            self.coalesced += 1
            M.SERVING_COALESCED.inc()
            flight.event.wait(timeout)
            if flight.entry is not None:
                return flight.entry, "coalesced"
            # leader failed or timed out: compute for ourselves (no
            # flight registration — correctness over dedup here)
            body, content_type, etag = compute()
            self.store(key, body, content_type, etag)
            return (
                CacheEntry(body, content_type, etag, key[2], key[3]),
                "coalesced",
            )
        try:
            body, content_type, etag = compute()
            # entry is built directly and set BEFORE the event fires: a
            # woken follower always sees the result even if the LRU has
            # already evicted the stored copy under churn
            flight.entry = CacheEntry(
                body, content_type, etag, key[2], key[3]
            )
        except BaseException as exc:
            flight.error = exc
            raise
        finally:
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()
        self.store(key, body, content_type, etag)
        return flight.entry, "miss"

    def invalidate(self, kind: str, anchor) -> int:
        """Drop every entry of `kind` whose anchor differs from the new
        one (the event that fired carries the fresh anchor; entries
        already computed against it stay valid)."""
        with self._lock:
            stale = [
                k
                for k, e in self._entries.items()
                if e.kind == kind and e.anchor != anchor
            ]
            for k in stale:
                del self._entries[k]
            n = len(stale)
            self.invalidations += n
            if n:
                M.SERVING_CACHE_INVALIDATIONS.inc(n)
            M.SERVING_CACHE_ENTRIES.set(len(self._entries))
            return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            M.SERVING_CACHE_ENTRIES.set(0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "coalesced": self.coalesced,
            }

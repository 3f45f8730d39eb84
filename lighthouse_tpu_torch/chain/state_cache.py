"""Bounded hot-state cache over the store (reference beacon_chain's
snapshot cache, snapshot_cache.rs + hot_cold_store.rs:48): the chain no
longer pins a full materialized BeaconState per non-finalized block.

Dict-shaped (the chain's `_states` seat): membership tracks every
imported non-finalized block root; only the most recently used
`capacity` states stay materialized, and a miss reconstructs from the
store's snapshot + block-replay path (`HotColdDB.get_state`). At the
500k-validator scale a full state is ~100 MB -- pinning one per block
of a whole non-finality window is what this cache exists to prevent.

The port's copy of lighthouse_tpu/chain/state_cache.py.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class StateCacheError(KeyError):
    """A KNOWN root whose state could not be rebuilt -- store damage, not
    an unknown-parent condition; never silently mapped to None."""


class StateCache:
    def __init__(self, store, capacity: int = 16):
        self.store = store
        self.capacity = capacity
        self._roots: set[bytes] = set()  # all imported non-finalized roots
        self._hot: OrderedDict[bytes, object] = OrderedDict()
        self._cold: OrderedDict[bytes, object] = OrderedDict()
        # the API's ThreadingHTTPServer reads while imports write: the
        # plain dict this replaced was GIL-atomic per op; the LRU's
        # check-then-act sequences need a real lock
        self._lock = threading.RLock()

    # -- dict surface --------------------------------------------------------

    def __contains__(self, block_root: bytes) -> bool:
        return bytes(block_root) in self._roots

    def __len__(self) -> int:
        return len(self._roots)

    def keys(self):
        with self._lock:
            return list(self._roots)

    def hot_count(self) -> int:
        with self._lock:
            return len(self._hot)

    def __setitem__(self, block_root: bytes, state) -> None:
        root = bytes(block_root)
        with self._lock:
            self._roots.add(root)
            self._hot[root] = state
            self._hot.move_to_end(root)
            while len(self._hot) > self.capacity:
                self._hot.popitem(last=False)

    def __delitem__(self, block_root: bytes) -> None:
        root = bytes(block_root)
        with self._lock:
            self._roots.discard(root)
            self._hot.pop(root, None)

    def get(self, block_root: bytes, default=None):
        root = bytes(block_root)
        with self._lock:
            if root not in self._roots:
                return default
            state = self._hot.get(root)
            if state is not None:
                self._hot.move_to_end(root)
                return state
        # reconstruction (store replay) runs outside the lock
        try:
            state = self._reconstruct(root)
        except StateCacheError:
            with self._lock:
                if root not in self._roots:
                    return default  # pruned mid-replay: a benign race
            raise
        with self._lock:
            if root not in self._roots:
                # pruned while we were replaying: do not resurrect it
                return default
            self[root] = state
        return state

    def __getitem__(self, block_root: bytes):
        state = self.get(block_root)
        if state is None:
            raise KeyError(bytes(block_root).hex()[:12])
        return state

    def get_any(self, block_root: bytes):
        """State for a root regardless of membership: known roots via the
        hot cache, FINALIZED roots via store reconstruction memoized in a
        small cold-side LRU (repeated light-client bootstraps for the same
        deep root must not replay per request)."""
        root = bytes(block_root)
        if root in self._roots:
            state = self.get(root)
            if state is not None:
                return state
            # pruned between the membership check and the fetch: fall
            # through to store reconstruction like any finalized root
        with self._lock:
            state = self._cold.get(root)
            if state is not None:
                self._cold.move_to_end(root)
                return state
        try:
            state = self._reconstruct(root)
        except StateCacheError:
            return None
        with self._lock:
            self._cold[root] = state
            while len(self._cold) > 4:
                self._cold.popitem(last=False)
        return state

    # -- reconstruction ------------------------------------------------------

    def _reconstruct(self, block_root: bytes):
        """Cold path: resolve the block's post-state root and rebuild via
        the store's snapshot + replay machinery. A failure here is store
        damage for a root we PROMISED membership of -- raise with the
        diagnostic rather than masquerading as an unknown parent."""
        state_root = self.store.get_chain_item(
            b"block_post_state:" + block_root
        )
        if state_root is None:
            raise StateCacheError(
                f"no post-state mapping for known root "
                f"{bytes(block_root).hex()[:12]}"
            )
        try:
            return self.store.get_state(state_root)
        except KeyError as e:
            raise StateCacheError(
                f"state replay failed for {bytes(block_root).hex()[:12]}: {e}"
            ) from e

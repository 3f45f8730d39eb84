"""Timeout-guarded chain lock (reference beacon_node/beacon_chain/src/
timeout_rw_lock.rs): lock acquisition that raises after a deadline
instead of deadlocking silently, so a stuck holder surfaces as a loud
error with the slow path named.

The reference wraps parking_lot's RwLock; here a reentrant exclusive
lock is the right shape — CPython's GIL already serializes reads, the
hazards are compound read-modify-write sequences interleaving across
threads (gossip workers vs the tick loop vs HTTP handlers), and chain
entry points nest (process_block -> recompute_head).

The port's copy of lighthouse_tpu/utils/timeout_lock.py."""

from __future__ import annotations

import threading


LOCK_TIMEOUT = 30.0  # seconds; reference uses 30s for beacon-chain locks


class LockTimeoutError(RuntimeError):
    pass


class TimeoutRLock:
    """threading.RLock with a timeout-raising context manager."""

    def __init__(self, name: str = "lock", timeout: float = LOCK_TIMEOUT):
        self._lock = threading.RLock()
        self.name = name
        self.timeout = timeout

    def __enter__(self):
        if not self._lock.acquire(timeout=self.timeout):
            raise LockTimeoutError(
                f"{self.name}: lock not acquired within {self.timeout}s "
                "(holder stuck?)"
            )
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

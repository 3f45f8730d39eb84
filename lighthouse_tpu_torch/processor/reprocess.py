"""Work reprocessing: re-queue gossip that arrived before its
prerequisites (reference beacon_node/network/src/beacon_processor/
work_reprocessing_queue.rs).

Two triggers, mirroring the reference:

- **block arrival** — attestations/aggregates referencing an unknown
  beacon block root wait keyed by that root; when the block imports they
  re-enter their processor queues immediately
  (`QueuedUnaggregate`/`QueuedAggregate` + the root-indexed
  `awaiting_attestations_per_root` map);
- **maturity** — anything still waiting past the delay window gets ONE
  timed retry (the reference's `ATTESTATION_DELAY` of 12 s), then is
  dropped with a counter. One retry only: a key that was deferred once
  is refused a second deferral, so re-rejected work cannot cycle.

The queue is clock-injected and synchronously polled (`poll()` from the
node's per-slot tick), matching the repo's manual-clock test style
rather than the reference's tokio `DelayQueue`.

The port's copy of lighthouse_tpu/processor/reprocess.py.
"""

from __future__ import annotations

import time


class ReprocessQueue:
    MAX_WAITING = 16_384  # the reference's attestation queue bound

    def __init__(self, delay_s: float = 12.0, clock=time.monotonic):
        self.delay_s = delay_s
        self.clock = clock
        # block_root -> [(queue_name, item, deadline)]
        self._by_root: dict[bytes, list] = {}
        self._count = 0
        # keys that already went through one defer cycle (refused again)
        self._retried: dict[bytes, None] = {}
        self._retried_cap = 8192
        self.stats = {
            "deferred": 0,
            "flushed_by_block": 0,
            "matured": 0,
            "expired_refused": 0,
            "shed": 0,
        }

    def __len__(self) -> int:
        return self._count

    def _mark_retried(self, key: bytes) -> None:
        self._retried[key] = None
        if len(self._retried) > self._retried_cap:
            for old in list(self._retried)[: self._retried_cap // 2]:
                del self._retried[old]

    def defer(self, queue_name: str, item, block_root: bytes, key: bytes) -> bool:
        """Hold `item` until `block_root` imports or the delay passes.
        `key` identifies the work item across retries (e.g. its tree
        hash); a key that already waited once is refused -- the caller
        drops the item instead of cycling it."""
        block_root = bytes(block_root)
        key = bytes(key)
        if key in self._retried:
            self.stats["expired_refused"] += 1
            return False
        if self._count >= self.MAX_WAITING:
            self.stats["shed"] += 1
            return False
        self._mark_retried(key)
        self._by_root.setdefault(block_root, []).append(
            (queue_name, item, self.clock() + self.delay_s)
        )
        self._count += 1
        self.stats["deferred"] += 1
        return True

    def on_block_imported(self, block_root: bytes) -> list:
        """The awaited block arrived: release everything keyed to it as
        [(queue_name, item)]."""
        waiting = self._by_root.pop(bytes(block_root), None)
        if not waiting:
            return []
        self._count -= len(waiting)
        self.stats["flushed_by_block"] += len(waiting)
        return [(q, item) for q, item, _ in waiting]

    def poll(self) -> list:
        """Release items whose delay matured (the timed second chance)."""
        now = self.clock()
        out = []
        empty_roots = []
        for root, waiting in self._by_root.items():
            keep = []
            for entry in waiting:
                if entry[2] <= now:
                    out.append((entry[0], entry[1]))
                else:
                    keep.append(entry)
            if len(keep) != len(waiting):
                self._count -= len(waiting) - len(keep)
                if keep:
                    self._by_root[root] = keep
                else:
                    empty_roots.append(root)
        for root in empty_roots:
            del self._by_root[root]
        self.stats["matured"] += len(out)
        return out

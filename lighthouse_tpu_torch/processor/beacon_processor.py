"""BeaconProcessor: prioritized, bounded work scheduling that forms
device-sized signature batches (reference beacon_node/network/src/
beacon_processor/mod.rs:1-39,85-190,921,1080-1190).

Differences from the reference are deliberate device-first choices:

  * The batch cap is device-oriented (default 1024 sets vs the reference's
    64, mod.rs:189-190): the batch verifier amortizes fixed overhead over much
    larger batches, and shape bucketing keeps compilation warm.
  * Work execution is synchronous-by-default (`run_until_idle`) with an
    optional background thread: on the card the heavy lifting is one device
    call, not a CPU worker pool, so the scheduler's job is ordering,
    dedup, load-shedding, and batch formation.

Queue semantics mirror the reference: LIFO for attestations (newest are
most useful), FIFO for blocks and aggregates, drop-on-overflow with
counters (load shedding).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

from ..utils import metrics as M
from ..utils import tracing


@dataclass
class DeferredWork:
    """A handler's deferred completion: the batch's signature verdict is
    in flight on the device. ``done()`` polls without blocking;
    ``complete()`` resolves and finishes the batch. Handlers return one
    of these (or any object with the same two callables, e.g.
    chain.attestation_verification.PendingBatch) to free their worker
    while the device computes."""

    done: object
    complete: object


def _is_deferred(out) -> bool:
    return callable(getattr(out, "done", None)) and callable(
        getattr(out, "complete", None)
    )


@dataclass
class WorkQueue:
    name: str
    max_len: int
    lifo: bool = False
    items: deque = field(default_factory=deque)
    dropped: int = 0

    def push(self, item) -> bool:
        if len(self.items) >= self.max_len:
            if self.lifo:
                # LIFO sheds the OLDEST item (queue front is oldest)
                self.items.popleft()
                self.dropped += 1
            else:
                self.dropped += 1
                return False
        self.items.append(item)
        return True

    def pop(self):
        if not self.items:
            return None
        return self.items.pop() if self.lifo else self.items.popleft()

    def drain(self, n: int) -> list:
        out = []
        while len(out) < n and self.items:
            out.append(self.pop())
        return out

    def __len__(self):
        return len(self.items)


class BeaconProcessor:
    """Dispatches queued work to handler callbacks in strict priority
    order; attestation-class queues drain in batches."""

    # priority order mirrors the reference's idle-worker dispatch chain
    # (mod.rs:1080-1140): blocks first, then aggregates, then unaggregated
    # attestations, then everything else.
    PRIORITY = [
        "chain_segment",
        "gossip_block",
        "gossip_aggregate",
        "gossip_attestation",
        "gossip_sync_contribution",
        "gossip_sync_message",
        "sync_contribution",
        "gossip_exit",
        "gossip_proposer_slashing",
        "gossip_attester_slashing",
        "api_request",
    ]

    def __init__(
        self,
        handlers: dict,
        max_batch: int = 1024,
        max_workers: int = 1,
        journal: bool = False,
        max_inflight: int = 2,
    ):
        """handlers: name -> callable(list_of_items) for batch queues or
        callable(item) for singleton queues. A handler may return a
        DeferredWork(-shaped) object: the verdict is then in flight on
        the device and the worker moves on to the next claim (marshal
        batch N+1 while N computes); completions resolve in submit order,
        bounded by `max_inflight` (the classic double buffer at 2).

        `max_workers` bounds the worker pool (mod.rs:85-115 max_workers /
        current_workers accounting): each worker claims the highest-
        priority available work under the lock and executes its handler
        outside it, so slow block imports don't stall attestation batch
        formation. With `journal=True` every claim is recorded as
        (queue_name, n_items) in dispatch order — the scheduling-order
        test surface (mod.rs:1052-1061 work journal)."""
        self.max_batch = max_batch
        self.max_workers = max(1, max_workers)
        self.max_inflight = max(1, max_inflight)
        # FIFO of (queue_name, n_items, deferred, span_ctx) awaiting
        # resolution; span_ctx re-parents the resume span under the work
        # span that dispatched the batch (the DeferredWork boundary)
        self._deferred: deque[tuple[str, int, object, object]] = deque()
        self.journal: list[tuple[str, int]] | None = [] if journal else None
        self.queues = {
            "chain_segment": WorkQueue("chain_segment", 64),
            "gossip_block": WorkQueue("gossip_block", 1024),
            "gossip_aggregate": WorkQueue("gossip_aggregate", 4096),
            "gossip_attestation": WorkQueue(
                "gossip_attestation", 16384, lifo=True
            ),
            "sync_contribution": WorkQueue("sync_contribution", 4096),
            "gossip_sync_message": WorkQueue(
                "gossip_sync_message", 16384, lifo=True
            ),
            "gossip_sync_contribution": WorkQueue(
                "gossip_sync_contribution", 4096
            ),
            "gossip_exit": WorkQueue("gossip_exit", 4096),
            "gossip_proposer_slashing": WorkQueue(
                "gossip_proposer_slashing", 4096
            ),
            "gossip_attester_slashing": WorkQueue(
                "gossip_attester_slashing", 4096
            ),
            "api_request": WorkQueue("api_request", 1024),
        }
        self.batched = {
            "gossip_aggregate",
            "gossip_attestation",
            "gossip_sync_message",
            "gossip_sync_contribution",
        }
        self.handlers = handlers
        # optional idle-time callback (speculate/): invoked when queues
        # are drained and nothing is deferred — see set_idle_task
        self.idle_task = None
        self._lock = threading.Lock()
        self._work_available = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._busy_workers = 0
        self.processed = {name: 0 for name in self.queues}
        self.handler_errors: dict[str, int] = {}
        self.last_error: str | None = None

    def tracer(self):
        # always the PROCESS tracer (tracing.configure() swaps apply
        # everywhere at once): per-component tracer injection would
        # fragment one logical trace across rings at the handler seams
        return tracing.default_tracer()

    def submit(self, queue: str, item) -> bool:
        # items ride the queue with their enqueue stamp AND the clock
        # that took it (tracer clock, so replays see identical waits):
        # the wait is always measured in the SUBMITTING clock's timebase,
        # so a tracing.configure() clock swap mid-flight cannot corrupt
        # the histogram with cross-clock deltas
        clock = self.tracer().clock
        t_enq = clock.now()
        with self._lock:
            q = self.queues[queue]
            dropped_before = q.dropped
            ok = q.push((item, t_enq, clock))
            if ok:
                if q.dropped == dropped_before:
                    # a LIFO shed replaces an already-counted item:
                    # pending depth is unchanged in that case
                    M.PROCESSOR_PENDING.inc()
                self._work_available.notify()
            return ok

    def _next_work(self):
        """Claim the highest-priority available work. Must hold the lock."""
        for name in self.PRIORITY:
            q = self.queues[name]
            if not len(q):
                continue
            if name in self.batched:
                # >=2 queued items repackage into one batch work item
                # (mod.rs:1098-1139), capped at the device batch size
                stamped = q.drain(self.max_batch)
            else:
                stamped = [q.pop()]
            items = [it for it, _, _ in stamped]
            M.PROCESSOR_PENDING.dec(len(items))
            # the OLDEST item's wait bounds the batch's scheduling
            # latency; each stamp resolves against its OWN clock, read
            # once per distinct clock (>= 0: a swapped-in fresh clock
            # must never record a negative wait)
            now_by_clock: dict = {}
            wait = 0.0
            for _, t, c in stamped:
                now = now_by_clock.get(id(c))
                if now is None:
                    now = now_by_clock[id(c)] = c.now()
                wait = max(wait, now - t)
            M.PROCESSOR_QUEUE_WAIT.observe(max(0.0, wait))
            if self.journal is not None:
                self.journal.append((name, len(items)))
            return name, items
        return None, None

    def _execute(self, name: str, items) -> None:
        # backpressure BEFORE dispatching more device work: at the
        # in-flight bound, the oldest verdict resolves first, so there
        # are never more than max_inflight submitted-unresolved batches.
        # Only the batched (deferrable) lanes pay this wait -- a block
        # import must never stall behind an attestation verdict.
        while name in self.batched:
            with self._lock:
                full = len(self._deferred) >= self.max_inflight
            if not full:
                break
            self._complete_deferred(block=True)
        handler = self.handlers.get(name)
        tracer = self.tracer()
        out = None
        ctx = None
        with tracer.span(f"work/{name}", n=len(items)):
            try:
                if handler is not None:
                    if name in self.batched:
                        out = handler(items)
                    else:
                        out = handler(items[0])
            # lint: allow[broad-except] -- worker survival boundary:
            # handlers are arbitrary application callbacks, so the
            # exception type is unknowable here; the failure is counted
            # per-queue and surfaced via last_error, never dropped
            except Exception as exc:  # noqa: BLE001 -- a poisoned work
                # item must not kill its worker (mod.rs workers are
                # respawned per task; here the thread persists, so
                # survive and count)
                self._count_error(name, exc)
            # captured INSIDE the work span: the deferred completion's
            # resume span parents here, whatever thread resolves it
            ctx = tracer.current()
        if _is_deferred(out):
            # verdict in flight: account at completion
            with self._lock:
                self._deferred.append((name, len(items), out, ctx))
            return
        with self._lock:
            self.processed[name] += len(items)

    def _count_error(self, name: str, exc: BaseException) -> None:
        with self._lock:
            self.handler_errors[name] = self.handler_errors.get(name, 0) + 1
            self.last_error = f"{name}: {type(exc).__name__}: {exc}"

    def health_snapshot(self) -> dict:
        """Point-in-time scheduling pressure, taken under the lock: the
        serving tier's admission controller reads `pending` as a
        shed signal; the rest rounds out the ops picture."""
        with self._lock:
            return {
                "pending": sum(len(q) for q in self.queues.values()),
                "dropped": sum(q.dropped for q in self.queues.values()),
                "deferred": len(self._deferred),
                "busy_workers": self._busy_workers,
            }

    def set_idle_task(self, fn) -> None:
        """Register (or clear with None) a callback for idle device time.
        `run_until_idle` fires it once after draining; worker-pool
        deployments call `run_idle_task()` from their tick loop. The task
        runs OUTSIDE the lock and must itself be cheap/abortable — it is
        a scavenger of idle cycles, never a priority class."""
        self.idle_task = fn

    def run_idle_task(self) -> bool:
        """Invoke the idle task iff the processor is genuinely idle
        (empty queues, no deferred verdicts, no busy workers). Returns
        True when the task ran. Exceptions are counted like handler
        failures — idle work must never kill its caller."""
        fn = self.idle_task
        if fn is None:
            return False
        with self._lock:
            idle = (
                self._busy_workers == 0
                and not self._deferred
                and not any(len(q) for q in self.queues.values())
            )
        if not idle:
            return False
        try:
            fn()
        # lint: allow[broad-except] -- same survival boundary as handlers
        except Exception as exc:  # noqa: BLE001 -- idle work is
            # best-effort by contract; count and move on
            self._count_error("idle_task", exc)
        return True

    def _complete_deferred(self, block: bool) -> bool:
        """Resolve the OLDEST deferred batch (submit order). With
        block=False only if its device work already finished. Returns
        True if one completed."""
        with self._lock:
            if not self._deferred:
                return False
            if not block and not self._deferred[0][2].done():
                return False
            name, n, work, ctx = self._deferred.popleft()
        tracer = self.tracer()
        with tracer.attach(ctx), tracer.span(f"resume/{name}", n=n):
            try:
                work.complete()
            # lint: allow[broad-except] -- same worker survival boundary
            # as _execute: completion runs arbitrary application callbacks
            except Exception as exc:  # noqa: BLE001 -- a poisoned
                # completion must not kill its worker; counted exactly
                # like a handler failure
                self._count_error(name, exc)
        with self._lock:
            self.processed[name] += n
        return True

    def run_until_idle(self) -> int:
        """Drain all queues in priority order on the calling thread
        (resolving deferred batch verdicts as they land); returns
        work-item count (synchronous mode: tests, simulator)."""
        done = 0
        idle_ran = False
        while True:
            while self._complete_deferred(block=False):
                pass
            with self._lock:
                name, items = self._next_work()
            if name is None:
                if self._complete_deferred(block=True):
                    continue
                # drained: give the idle task its one shot (speculation
                # etc.), then re-check — it may have submitted work
                if not idle_ran and self.idle_task is not None:
                    idle_ran = True
                    if self.run_idle_task():
                        continue
                return done
            self._execute(name, items)
            done += len(items)

    # -- worker pool (mod.rs manager + blocking-task workers) ---------------

    def start(self, num_workers: int | None = None) -> None:
        """Spawn the worker pool: each worker blocks on the condition
        variable, claims the top-priority work, and executes it outside
        the lock — concurrent handlers up to the pool size."""
        if self._threads:
            return
        n = num_workers or self.max_workers

        def worker():
            while True:
                with self._lock:
                    name, items = self._next_work()
                    while name is None:
                        if self._deferred:
                            break  # resolve a deferred verdict instead
                        if self._stop.is_set():
                            return
                        self._work_available.wait(0.05)
                        name, items = self._next_work()
                    self._busy_workers += 1
                try:
                    if name is None:
                        # queues empty, verdicts in flight: resolving the
                        # oldest IS this worker's work
                        self._complete_deferred(block=True)
                    else:
                        self._execute(name, items)
                finally:
                    with self._lock:
                        self._busy_workers -= 1

        for _ in range(n):
            t = threading.Thread(target=worker, daemon=True)
            t.start()
            self._threads.append(t)

    @property
    def is_running(self) -> bool:
        return bool(self._threads)

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Block until every queue is empty and every worker is idle."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                if (
                    self._busy_workers == 0
                    and not self._deferred
                    and not any(len(q) for q in self.queues.values())
                ):
                    return True
            _time.sleep(0.002)
        return False

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._work_available.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []
        # verdicts still in flight resolve on the stopping thread: a
        # submitted batch is never abandoned half-verified
        while self._complete_deferred(block=True):
            pass

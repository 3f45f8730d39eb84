"""Deadline-aware continuous batching in front of the verification pipeline.

Port of lighthouse_tpu/crypto/bls/scheduler.py. The pipeline (crypto/bls/
pipeline.py) removed the host/device stall; this module removes the
QUEUEING stall. A batch that forms at a caller's seam dispatches whole: a
set arriving a millisecond after dispatch waits a full device round trip,
and batch shape is whatever traffic piled up. Continuous batching merges
arrivals into the next launch, and the warm-bucket shape family makes
that free of capture risk: merged launches pad to the nearest WARMED
bucket capacity (``WARM_CAPACITIES`` are the set buckets of torch_cuda's
``DEFAULT_WARM_BUCKETS``), so re-batching never captures a new stage
graph.

Model:

  * ``submit(sets, lane=..., seed=..., slot=..., device=...)`` lands the
    batch in a per-lane deadline queue and returns a
    :class:`ScheduledVerify` future; nothing dispatches yet unless the
    queued real-set count crosses the launch threshold
    (``LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS``, read per call, 64 by default).
  * At each launch boundary (threshold crossing, a ``result()`` on a
    queued entry, ``drain()``) the scheduler merges everything admitted
    into ONE device launch via ``pipeline.submit(..., pad_to=capacity)``.
    Entries merge only with entries for the same device.
  * Admission is ordered by (lane priority, slot deadline, arrival):
    block proposals > aggregates > unaggregated > sync > speculative.
    Speculative entries are admitted ONLY when no real work is queued --
    a launch boundary with real arrivals preempts them (counted on
    ``speculate_preemptions_total``); preempted entries stay queued and
    ride the next idle launch, never dropped.
  * One merged launch yields one batch verdict. True means every member
    entry's sets verified (the random-linear-combination batch verdict
    is exactly the conjunction). False triggers the merge fallback: each
    member entry is re-verified alone with its OWN seed, so every caller
    observes precisely the verdict the unmerged path would have produced.
    A re-verify runs at the entry's natural bucket, which captures its
    stage graphs if that bucket was never warmed.

Per-lane time-to-verdict is recorded against the INJECTED slot clock
(``observe_slot_delay``) into the ``bls_sched_verdict_delay_seconds_*``
histograms; merge/launch/pad-waste counters make the padding tax visible.
"""

from __future__ import annotations

import os
import threading
from collections import deque

from ...obs import ledger as launch_ledger
from ...utils import metrics, tracing
from . import pipeline as bls_pipeline

# lane admission priority, outermost deadline first: block proposals
# gate fork choice, aggregates gate attestation pools, unaggregated and
# sync-committee traffic degrade gracefully, speculation is free work
LANES = ("block", "aggregate", "unaggregated", "sync", "speculative")
LANE_PRIORITY = {lane: i for i, lane in enumerate(LANES)}

# the warmed set-bucket capacities of DEFAULT_WARM_BUCKETS (backends/
# torch_cuda.py): merged launches pad to the smallest one that fits, so
# the shape key always lands in the family warm_compile captured. Above
# the largest capacity the launch rides its natural power-of-two bucket.
WARM_CAPACITIES = (4, 16, 64, 256, 512)
MAX_LAUNCH_SETS = WARM_CAPACITIES[-1]

_FAR_DEADLINE = 1 << 62  # slot=None sorts after every real deadline


def _max_sets() -> int:
    """Queued real-set count that triggers an immediate launch; read per
    call so benches/tests retune without reconfiguring."""
    return int(os.environ.get("LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS", "64"))


def enabled() -> bool:
    """Continuous batching is opt-in (`LIGHTHOUSE_TPU_CONT_BATCH=1`);
    read per call so tests and operators flip it without reimport."""
    return os.environ.get("LIGHTHOUSE_TPU_CONT_BATCH", "0") == "1"


def warm_capacity(n: int) -> int | None:
    """Smallest warmed capacity holding `n` sets, or None past the warm
    family (the launch then pads nothing and takes its natural bucket)."""
    for cap in WARM_CAPACITIES:
        if n <= cap:
            return cap
    return None


class _Entry:
    """One submitted batch waiting in (or launched from) a lane queue."""

    __slots__ = (
        "sets", "lane", "seed", "slot", "seq", "launch", "verdict", "error",
        "device",
    )

    def __init__(self, sets, lane: str, seed, slot, seq: int, device=None):
        self.sets = sets
        self.lane = lane
        self.seed = seed
        self.slot = slot
        self.seq = seq
        self.device = device
        self.launch = None  # _Launch once admitted
        self.verdict = None  # bool once resolved
        self.error = None

    def sort_key(self):
        deadline = _FAR_DEADLINE if self.slot is None else int(self.slot)
        return (LANE_PRIORITY[self.lane], deadline, self.seq)


class _Launch:
    """One admitted device program: the merged entries plus the pipeline
    future that carries their shared batch verdict. ``audit`` is the
    admission record built in `_admit` -- it lands verbatim on the
    launch ledger's "sched" record, which is how the preemption facts
    (`speculative_withheld`, `real_queued_before`) reach every exported
    surface instead of living only in the in-process launch_log."""

    __slots__ = ("entries", "future", "ready", "settled", "lock", "audit")

    def __init__(self, entries, audit=None):
        self.entries = entries
        self.audit = audit or {}
        self.future = None
        # set once `future` is attached: a concurrent result() caller
        # that saw the entry admitted mid-flush parks here instead of
        # spinning on the queue lock
        self.ready = threading.Event()
        # settle-once guard (LOCK_ORDER `_Launch.lock`, leaf): two
        # members resolved from different threads must not both run the
        # merge fallback
        self.settled = False
        self.lock = threading.Lock()


class ScheduledVerify:
    """Future for one scheduler submission; duck-types VerifyFuture
    (``done()`` / ``result()``) so PendingBatch callers never branch."""

    __slots__ = ("_scheduler", "_entry")

    def __init__(self, scheduler: "ContinuousBatchScheduler", entry: _Entry):
        self._scheduler = scheduler
        self._entry = entry

    def done(self) -> bool:
        e = self._entry
        if e.verdict is not None or e.error is not None:
            return True
        if e.launch is None or not e.launch.ready.is_set():
            return False  # still queued: a verdict needs a launch boundary
        return e.launch.future.done()

    def result(self) -> bool:
        return self._scheduler._resolve(self._entry)


class ContinuousBatchScheduler:
    """Per-lane deadline queues + merge-at-launch in front of a
    :class:`VerifyPipeline`.

    ``pipeline`` defaults to the module-level pipeline at every launch
    (so ``bls_pipeline.configure`` keeps applying mid-process);
    ``slot_clock`` is the injected chain clock the per-lane verdict-delay
    histograms are measured against (None disables the observation, the
    counters still run).
    """

    def __init__(self, pipeline=None, slot_clock=None):
        self._pipeline = pipeline
        self.slot_clock = slot_clock
        # launch serialization (LOCK_ORDER
        # `ContinuousBatchScheduler._launch_lock`): one flush admits and
        # dispatches at a time -- the pipeline's submit path is not
        # reentrant, and concurrent result() callers all funnel through
        # flush()
        self._launch_lock = threading.Lock()
        # admission lock (LOCK_ORDER `ContinuousBatchScheduler._lock`):
        # held only around queue admission; pipeline dispatch and
        # verdict materialisation happen OUTSIDE it
        self._lock = threading.Lock()
        self._queued: deque[_Entry] = deque()
        self._next_seq = 0
        self.stats = {
            "launches": 0,
            "merges": 0,
            "merge_fallbacks": 0,
            "preemptions": 0,
            "pad_sets": 0,
            "real_sets": 0,
        }
        # per-launch admission audit: lanes admitted (deadline order),
        # their (priority, deadline) sort keys, and how much real work
        # was queued when the admission ran -- the machine-checked
        # surface for "speculation never preempts validator lanes" and
        # "admission follows deadline order" (scenario harness + tests)
        self.launch_log: deque[dict] = deque(maxlen=4096)

    # -- introspection -------------------------------------------------------

    def _active_pipeline(self):
        return (
            self._pipeline
            if self._pipeline is not None
            else bls_pipeline.default_pipeline()
        )

    def queued_depth(self, lane: str | None = None) -> int:
        with self._lock:
            if lane is None:
                return len(self._queued)
            return sum(1 for e in self._queued if e.lane == lane)

    def _sample_depths(self) -> None:
        # caller holds the lock
        depths = {lane: 0 for lane in LANES}
        for e in self._queued:
            depths[e.lane] += 1
        for lane, d in depths.items():
            metrics.BLS_SCHED_QUEUE_DEPTH.set(lane, d)

    # -- submission ----------------------------------------------------------

    def submit(self, sets, lane: str, seed=None, slot=None,
               device=None) -> ScheduledVerify:
        """Queue one batch on `lane`; launches immediately only when the
        queued real-set count crosses the launch threshold. `device`
        is the api's device keyword (None: the api's own)."""
        if lane not in LANE_PRIORITY:
            raise ValueError(f"unknown scheduler lane: {lane!r}")
        sets = list(sets)
        entry = _Entry(sets, lane, seed, slot, 0, device)
        if not sets:
            # empty batch: the sync api's pinned verdict, no device work
            entry.verdict = False
            return ScheduledVerify(self, entry)
        with self._lock:
            entry.seq = self._next_seq
            self._next_seq += 1
            self._queued.append(entry)
            real_queued = sum(
                len(e.sets) for e in self._queued if e.lane != "speculative"
            )
            self._sample_depths()
        if real_queued >= _max_sets():
            self.flush()
        return ScheduledVerify(self, entry)

    # -- launch boundary -----------------------------------------------------

    def _admit(self):
        """One launch boundary's admission (caller must NOT hold the
        lock): deadline-ordered real entries up to the largest warm
        capacity; speculative entries only when nothing real is queued;
        entries for another device than the first admitted one stay
        queued for a later boundary."""
        with self._lock:
            real = sorted(
                (e for e in self._queued if e.lane != "speculative"),
                key=_Entry.sort_key,
            )
            speculative = [
                e for e in self._queued if e.lane == "speculative"
            ]
            admitted: list[_Entry] = []
            total = 0
            pool = real if real else sorted(
                speculative, key=_Entry.sort_key
            )
            for e in pool:
                if admitted and e.device != admitted[0].device:
                    continue
                if admitted and total + len(e.sets) > MAX_LAUNCH_SETS:
                    break  # stays queued for the next boundary
                admitted.append(e)
                total += len(e.sets)
            if real and speculative:
                # the preemption audit trail: withheld speculative work
                # is COUNTED and stays queued -- never dropped
                self.stats["preemptions"] += len(speculative)
                metrics.SPECULATE_PREEMPTIONS.inc(len(speculative))
            if not admitted:
                return None
            audit = {
                "lanes": tuple(e.lane for e in admitted),
                "keys": tuple(e.sort_key()[:2] for e in admitted),
                "real_queued_before": len(real),
                "speculative_withheld": (
                    len(speculative) if real else 0
                ),
            }
            launch = _Launch(admitted, audit)
            for e in admitted:
                e.launch = launch
                self._queued.remove(e)
            self.launch_log.append(audit)
            self._sample_depths()
            return launch

    def flush(self) -> bool:
        """Run one launch boundary: admit, merge, pad, dispatch. Returns
        True when a launch happened (False on an empty queue)."""
        with self._launch_lock:
            return self._flush_locked()

    def _flush_locked(self) -> bool:
        launch = self._admit()
        if launch is None:
            return False
        entries = launch.entries
        merged = [s for e in entries for s in e.sets]
        n = len(merged)
        cap = warm_capacity(n)
        pad = (cap - n) if cap is not None else 0
        # the merged launch draws ONE weight seed; per-entry seeds are
        # honoured exactly on the fallback path, which is the only place
        # a per-entry verdict is ever derived from them
        seed = next((e.seed for e in entries if e.seed is not None), None)
        self.stats["launches"] += 1
        self.stats["real_sets"] += n
        self.stats["pad_sets"] += pad
        metrics.BLS_SCHED_LAUNCHES.inc()
        metrics.BLS_SCHED_REAL_SETS.inc(n)
        if pad:
            metrics.BLS_SCHED_PAD_SETS.inc(pad)
        if len(entries) > 1:
            self.stats["merges"] += 1
            metrics.BLS_SCHED_MERGES.inc()
        lane_sets: dict[str, int] = {}
        for e in entries:
            lane_sets[e.lane] = lane_sets.get(e.lane, 0) + len(e.sets)
        with tracing.span(
            "sched_launch", entries=len(entries), sets=n, pad=pad
        ):
            # the merged-launch ledger record, inside the sched_launch
            # span (cross-links) and BEFORE the pipeline submit (so the
            # sched record precedes the pipeline record it causes)
            launch_ledger.record(
                "sched",
                bucket=cap,
                real_sets=n,
                padded_sets=n + pad,
                entries=len(entries),
                lanes=launch.audit.get("lanes"),
                lane_sets=lane_sets,
                slot=min(
                    (int(e.slot) for e in entries if e.slot is not None),
                    default=None,
                ),
                speculative_withheld=launch.audit.get(
                    "speculative_withheld"
                ),
                real_queued_before=launch.audit.get("real_queued_before"),
            )
            launch.future = self._active_pipeline().submit(
                merged, seed=seed, pad_to=cap, device=entries[0].device
            )
        launch.ready.set()
        return True

    def drain(self) -> None:
        """Launch + resolve everything queued (shutdown/idle barrier)."""
        while self.flush():
            pass
        for lane in LANES:
            metrics.BLS_SCHED_QUEUE_DEPTH.set(lane, 0)
        self._active_pipeline().drain()

    # -- resolution ----------------------------------------------------------

    def _resolve(self, entry: _Entry) -> bool:
        """Block until `entry` has a verdict. A queued entry forces
        launch boundaries until it is admitted -- real work drains first,
        so a speculative entry's result() launches every queued real
        batch ahead of it (preemption), then its own idle launch."""
        while entry.verdict is None and entry.error is None:
            if entry.launch is None:
                if not self.flush():
                    # raced: another thread admitted it mid-flush
                    if entry.launch is None:
                        continue
            if entry.launch is not None:
                entry.launch.ready.wait()
                self._settle(entry.launch)
        if entry.error is not None:
            raise entry.error
        return entry.verdict

    def _settle(self, launch: _Launch) -> None:
        """Materialise one launch's batch verdict and fan it out to the
        member entries (merge fallback on a False merged batch). Runs
        once per launch; concurrent resolvers of sibling entries wait on
        the launch lock and find it settled."""
        with launch.lock:
            if not launch.settled:
                self._settle_locked(launch)
                launch.settled = True

    def _settle_locked(self, launch: _Launch) -> None:
        try:
            batch_ok = launch.future.result()
        except Exception as e:  # noqa: BLE001 -- a device fault poisons
            # the whole launch; every member surfaces it exactly like the
            # unmerged future would have
            for entry in launch.entries:
                if entry.verdict is None and entry.error is None:
                    entry.error = e
            return
        if batch_ok or len(launch.entries) == 1:
            for entry in launch.entries:
                if entry.verdict is None:
                    entry.verdict = bool(batch_ok)
                    self._observe(entry)
            return
        # merged batch False: recover exact per-entry verdicts with each
        # entry's OWN seed (the verdict the unmerged path would produce;
        # downstream bisection invariants depend on this)
        self.stats["merge_fallbacks"] += 1
        metrics.BLS_SCHED_MERGE_FALLBACKS.inc()
        from . import api

        for entry in launch.entries:
            if entry.verdict is None:
                entry.verdict = bool(
                    api.verify_signature_sets(
                        entry.sets, seed=entry.seed, device=entry.device
                    )
                )
                self._observe(entry)

    def _observe(self, entry: _Entry) -> None:
        if self.slot_clock is None or entry.slot is None:
            return
        metrics.observe_slot_delay(
            metrics.SCHEDULER_VERDICT_DELAY[entry.lane],
            self.slot_clock,
            int(entry.slot),
        )


# -- module-level default (the api.verify_signature_sets_async seat) ---------

_DEFAULT: ContinuousBatchScheduler | None = None


def default_scheduler() -> ContinuousBatchScheduler:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ContinuousBatchScheduler()
    return _DEFAULT


def configure(**kwargs) -> ContinuousBatchScheduler:
    """Replace the module-level scheduler (tests/scenario runs inject a
    pipeline/slot_clock here, mirroring pipeline.configure)."""
    global _DEFAULT
    if _DEFAULT is not None:
        _DEFAULT.drain()
    _DEFAULT = ContinuousBatchScheduler(**kwargs)
    return _DEFAULT


def set_slot_clock(slot_clock) -> None:
    """Point the default scheduler's verdict-delay histograms at the
    chain's injected slot clock (BeaconChain construction seat)."""
    default_scheduler().slot_clock = slot_clock

"""Deterministic span tracer: a copy of lighthouse_tpu/utils/tracing.py.

Spans carry (trace_id, span_id, parent_id) and nest through a per-thread
stack; ``Tracer.current()`` captures the ambient context and
``Tracer.attach(ctx)`` re-establishes it at a future's resolution, so a
pipeline's resolve span nests under the span that submitted the batch.
Time comes from an injected clock with ``now()`` and ids from an injected
``random.Random(seed)``: a seeded run under a stepping clock exports a
bit-identical trace. Finished spans land in a bounded ring (overflow
drops the oldest and counts) and export as Chrome trace-event JSON.
``sample_rate`` keeps 1-in-N traces, decided from the root span's trace
id; ``LIGHTHOUSE_TPU_TRACE_SAMPLE`` seeds the process default (1.0, every
trace), and tests pass their own rate to :func:`configure`.

The verification seam opens the same spans as the JAX package:
``pipeline_submit`` and ``pipeline_resolve`` (crypto/bls/pipeline.py),
``bls_aggregate``, ``bls_marshal`` and ``bls_dispatch`` (the pipeline and
backends/torch_cuda.py), and ``sched_launch`` (crypto/bls/scheduler.py).
The default process tracer uses a :class:`StepClock` (each read advances
a fixed synthetic step): no wall-clock read, and still ordered.
"""

from __future__ import annotations

import json
import random
import threading
from collections import deque
from contextlib import contextmanager

_CHROME_CAT = "lighthouse"


class StepClock:
    """Deterministic fallback clock: every ``now()`` advances a fixed
    synthetic step, so span ordering (and strictly positive durations)
    exist without a single wall-clock read."""

    def __init__(self, start: float = 0.0, step: float = 1e-6):
        self._now = float(start)
        self._step = float(step)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            t = self._now
            self._now += self._step
            return t


class TickingClock:
    """Wraps a manually-advanced clock (resilience ``VirtualClock``),
    advancing it a fixed step per read: replays stay deterministic AND
    span durations are non-zero, without the test hand-advancing around
    every instrumented call."""

    def __init__(self, inner, step: float = 1e-6):
        self.inner = inner
        self.step = float(step)
        self._lock = threading.Lock()

    def now(self) -> float:
        # the read-advance pair is atomic (like StepClock): concurrent
        # readers must never observe the same instant
        with self._lock:
            t = self.inner.now()
            self.inner.advance(self.step)
            return t


class SpanContext:
    """The propagable half of a span: enough to parent remote children."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "start", "end", "attrs", "tid",
    )

    def __init__(self, name, trace_id, span_id, parent_id, start, tid, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end = None
        self.tid = tid
        self.attrs = attrs

    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)


class Tracer:
    """Bounded, injectable span recorder. Thread-safe; the ambient span
    stack is per-thread, the finished ring and id draws share one lock."""

    def __init__(self, clock=None, rng=None, capacity: int = 4096,
                 enabled: bool = True, sample_rate: float = 1.0):
        self.clock = clock if clock is not None else StepClock()
        self.rng = rng if rng is not None else random.Random(0)
        self.capacity = int(capacity)
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self.finished: deque[Span] = deque(maxlen=self.capacity)
        self.dropped = 0
        self.sampled_out = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        # thread ident -> stable small tid, first-seen order: chrome trace
        # tids stay deterministic under seeded single-thread replays and
        # merely small under real worker pools
        self._tids: dict[int, int] = {}

    # -- ambient context ----------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            return tid

    def _new_id(self) -> int:
        with self._lock:
            return self.rng.getrandbits(64) or 1

    def current(self) -> SpanContext | None:
        """The ambient context on THIS thread (capture it before handing
        work to another thread/future; re-establish with ``attach``)."""
        st = self._stack()
        if not st:
            return None
        top = st[-1]
        return SpanContext(top.trace_id, top.span_id)

    @contextmanager
    def attach(self, ctx: SpanContext | None):
        """Make ``ctx`` the ambient parent on this thread: the cross-
        thread / cross-future propagation seat (DeferredWork resume,
        VerifyFuture resolution)."""
        if ctx is None or not self.enabled:
            yield
            return
        st = self._stack()
        st.append(ctx)
        try:
            yield
        finally:
            if st and st[-1] is ctx:
                st.pop()
            elif ctx in st:
                st.remove(ctx)

    # -- spans --------------------------------------------------------------

    def start_span(self, name: str, parent: SpanContext | None = None,
                   **attrs) -> Span | None:
        if not self.enabled:
            return None
        if parent is None:
            parent = self.current()
        if parent is None:
            trace_id, parent_id = self._new_id(), 0
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        s = Span(
            name, trace_id, self._new_id(), parent_id,
            self.clock.now(), self._tid(), attrs,
        )
        self._stack().append(s)
        return s

    def end_span(self, span: Span | None) -> None:
        if span is None:
            return
        span.end = self.clock.now()
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:  # mis-nested end: drop it wherever it sits
            st.remove(span)
        self._record(span)

    @contextmanager
    def span(self, name: str, parent: SpanContext | None = None, **attrs):
        s = self.start_span(name, parent=parent, **attrs)
        try:
            yield s
        finally:
            self.end_span(s)

    def instant(self, name: str, parent: SpanContext | None = None,
                **attrs) -> None:
        """A zero-duration event (gossip arrival, dispatch edges)."""
        if not self.enabled:
            return
        if parent is None:
            parent = self.current()
        if parent is None:
            trace_id, parent_id = self._new_id(), 0
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        s = Span(
            name, trace_id, self._new_id(), parent_id,
            self.clock.now(), self._tid(), attrs,
        )
        s.end = s.start
        self._record(s)

    def trace_sampled(self, trace_id: int) -> bool:
        """The per-trace sampling verdict: a pure function of the trace
        id (drawn at the ROOT span), so it is decided exactly once per
        trace and every descendant span -- on any thread, through any
        ``attach`` -- agrees without propagating a flag. Full-precision
        against the 64-bit id range: any positive rate keeps a positive
        fraction of traces (1e-6 keeps ~1-in-a-million, not zero)."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return trace_id < self.sample_rate * 2.0**64

    def _record(self, span: Span) -> None:
        with self._lock:
            if not self.trace_sampled(span.trace_id):
                self.sampled_out += 1
                return
            if len(self.finished) == self.finished.maxlen:
                self.dropped += 1
            self.finished.append(span)

    # -- export -------------------------------------------------------------

    def finished_spans(self) -> list[Span]:
        """Snapshot of the finished ring (monitoring's trace-derived
        health fields and the scenario SLO checker read through this)."""
        with self._lock:
            return list(self.finished)

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "recorded": len(self.finished),
                "dropped": self.dropped,
                "sample_rate": self.sample_rate,
                "sampled_out": self.sampled_out,
                "threads": len(self._tids),
            }

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing loadable):
        one "X" complete event per finished span, microsecond units,
        span/trace/parent ids in ``args`` so nesting survives the export.
        Sorted by (ts, trace_id, span_id): a replayed ring exports a
        byte-identical document regardless of resolution interleaving."""
        with self._lock:
            spans = list(self.finished)
        spans.sort(key=lambda s: (s.start, s.trace_id, s.span_id))
        events = []
        for s in spans:
            args = {str(k): v for k, v in sorted(s.attrs.items())}
            args["trace_id"] = f"{s.trace_id:016x}"
            args["span_id"] = f"{s.span_id:016x}"
            if s.parent_id:
                args["parent_id"] = f"{s.parent_id:016x}"
            events.append({
                "name": s.name,
                "cat": _CHROME_CAT,
                "ph": "X",
                "ts": round(s.start * 1e6, 3),
                "dur": round(s.duration() * 1e6, 3),
                "pid": 1,
                "tid": s.tid,
                "args": args,
            })
        return {
            "displayTimeUnit": "ms",
            "traceEvents": events,
        }

    def dump_json(self) -> str:
        return json.dumps(self.chrome_trace(), sort_keys=True)

    def reset(self) -> None:
        """Clear recorded spans + thread table; clock/rng keep their
        state (a reset mid-run must not replay old ids)."""
        with self._lock:
            self.finished.clear()
            self.dropped = 0
            self.sampled_out = 0
            self._tids.clear()


# -- module-level default (the seat instrumented code consults) --------------

_DEFAULT: Tracer | None = None


def default_tracer() -> Tracer:
    global _DEFAULT
    if _DEFAULT is None:
        import os

        try:
            rate = float(os.environ.get("LIGHTHOUSE_TPU_TRACE_SAMPLE", "1"))
        except ValueError:
            rate = 1.0
        _DEFAULT = Tracer(sample_rate=rate)
    return _DEFAULT


def configure(**kwargs) -> Tracer:
    """Replace the process tracer (tests inject clock/rng/capacity here,
    mirroring crypto.bls.pipeline.configure)."""
    global _DEFAULT
    _DEFAULT = Tracer(**kwargs)
    return _DEFAULT


# thin wrappers: instrumented call sites consult the CURRENT default at
# every call, so configure() swaps take effect mid-process
def span(name: str, parent: SpanContext | None = None, **attrs):
    return default_tracer().span(name, parent=parent, **attrs)


def instant(name: str, parent: SpanContext | None = None, **attrs) -> None:
    default_tracer().instant(name, parent=parent, **attrs)


def current() -> SpanContext | None:
    return default_tracer().current()


def attach(ctx: SpanContext | None):
    return default_tracer().attach(ctx)

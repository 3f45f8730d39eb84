"""Resilience primitives: retry, timeout, circuit breaker, health scores.

Everything here is deterministic by construction:

  * time comes from an injected clock object exposing ``now()`` (the
    slot clocks in utils/slot_clock.py qualify, as does the local
    ``VirtualClock``) -- wall time never enters (lint rule `wallclock`);
  * randomness (backoff jitter) comes from an injected
    ``random.Random(seed)``;
  * every decision -- retry, backoff delay, breaker transition, health
    demotion -- can be recorded into an ``EventLog``, so two runs with
    the same seed produce byte-identical event sequences (the replay
    contract tests/test_resilience.py asserts).

The reference spreads these behaviors across beacon_node_fallback.rs
(candidate ranking + re-probe), eth1's multi-endpoint cache, and the
engine-API retry loops; here they are one reusable layer.

The port's copy of lighthouse_tpu/resilience/primitives.py.
"""

from __future__ import annotations

import random
from collections import deque

from ..utils import metrics


class VirtualClock:
    """A manually-advanced clock: the deterministic stand-in for wall
    time. ``FaultPlan`` delay/hang injections advance it, so injected
    latency is visible to ``Timeout`` and ``CircuitBreaker`` without a
    single real sleep."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += float(seconds)


class EventLog:
    """Append-only record of resilience decisions, comparable across
    runs: the determinism contract is ``log_a.events == log_b.events``."""

    def __init__(self):
        self.events: list[tuple] = []

    def record(self, kind: str, **detail) -> None:
        self.events.append((kind,) + tuple(sorted(detail.items())))

    def kinds(self) -> list[str]:
        return [e[0] for e in self.events]

    def __len__(self) -> int:
        return len(self.events)

    def __eq__(self, other) -> bool:
        if isinstance(other, EventLog):
            return self.events == other.events
        return NotImplemented


class RetryExhausted(ConnectionError):
    """Every attempt of a retried operation failed."""


class RetryPolicy:
    """Bounded retries with exponential backoff + jitter from an
    injected rng (the anti-thundering-herd shape the `retry-no-backoff`
    lint rule enforces repo-wide).

    ``sleep`` is an injected callable; the default advances ``clock``
    when it can (VirtualClock) and otherwise just records the delay --
    the policy never blocks a real thread, so tests replay instantly.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay_s: float = 0.05,
        factor: float = 2.0,
        max_delay_s: float = 2.0,
        jitter: float = 0.25,
        rng: random.Random | None = None,
        clock=None,
        sleep=None,
        events: EventLog | None = None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.factor = factor
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.rng = rng if rng is not None else random.Random(0)
        self.clock = clock
        self._sleep_fn = sleep
        self.events = events

    def delay_for(self, attempt: int) -> float:
        """Deterministic (given the injected rng) backoff for `attempt`
        (0-based): min(cap, base * factor^attempt) * (1 + jitter*U[0,1))."""
        d = min(self.max_delay_s, self.base_delay_s * self.factor**attempt)
        return d * (1.0 + self.jitter * self.rng.random())

    def _sleep(self, seconds: float) -> None:
        if self._sleep_fn is not None:
            self._sleep_fn(seconds)
        elif self.clock is not None and hasattr(self.clock, "advance"):
            self.clock.advance(seconds)

    def pause(self, attempt: int) -> float:
        """One backoff pause for callers running their own attempt loop
        (e.g. the engine's SYNCING re-poll); returns the delay taken."""
        delay = self.delay_for(attempt)
        if self.events is not None:
            self.events.record(
                "backoff", attempt=attempt, delay_ms=int(delay * 1000)
            )
        self._sleep(delay)
        return delay

    def call(self, fn, retry_on=(ConnectionError, OSError), on_retry=None):
        """Run ``fn()`` with up to ``max_attempts`` tries; backs off
        between attempts and raises ``RetryExhausted`` (chaining the
        last error) when the budget runs out."""
        last = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on as e:
                last = e
                metrics.RETRY_ATTEMPTS.inc()
                if self.events is not None:
                    self.events.record(
                        "retry", attempt=attempt, error=type(e).__name__
                    )
                if on_retry is not None:
                    on_retry(attempt, e)
                if attempt + 1 < self.max_attempts:
                    delay = self.delay_for(attempt)
                    if self.events is not None:
                        self.events.record(
                            "backoff", attempt=attempt,
                            delay_ms=int(delay * 1000),
                        )
                    self._sleep(delay)
        raise RetryExhausted(
            f"operation failed after {self.max_attempts} attempts: {last!r}"
        ) from last


class TimeoutExceeded(TimeoutError):
    """An operation overran its deadline on the injected clock."""


class Timeout:
    """Cooperative deadline against the injected clock: the wrapped call
    runs to completion, then the elapsed *injected* time is checked --
    FaultPlan delay/hang injections advance the same clock, so an
    injected hang deterministically trips the deadline."""

    def __init__(self, clock, timeout_s: float):
        self.clock = clock
        self.timeout_s = timeout_s

    def call(self, fn, *args, **kwargs):
        t0 = self.clock.now()
        out = fn(*args, **kwargs)
        elapsed = self.clock.now() - t0
        if elapsed > self.timeout_s:
            raise TimeoutExceeded(
                f"operation took {elapsed:.3f}s > {self.timeout_s:.3f}s"
            )
        return out


class BreakerOpen(ConnectionError):
    """The circuit breaker is open; the protected call was not made."""


class CircuitBreaker:
    """closed -> open -> half-open breaker with a re-probe budget
    (reference: the engine/eth1 endpoint state machines that stop
    hammering a dead dependency but keep probing for recovery).

    Re-probe triggers either by injected-clock timeout
    (``reset_timeout_s`` after opening) or -- clock-free, for embedding
    in layers with no clock to thread -- after ``denied_budget``
    rejected ``allow()`` calls. Both are deterministic. The denied
    budget defaults ON so a breaker constructed with no clock still
    matures to half-open instead of denying forever; pass
    ``denied_budget=None`` with a clock for pure-timeout behavior.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        clock=None,
        failure_threshold: int = 3,
        reset_timeout_s: float = 30.0,
        half_open_probes: int = 1,
        denied_budget: int | None = 8,
        events: EventLog | None = None,
        name: str = "breaker",
    ):
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_probes = half_open_probes
        self.denied_budget = denied_budget
        self.events = events
        self.name = name
        self.state = self.CLOSED
        self.transitions: list[tuple[str, str]] = []
        self._failures = 0
        self._denied = 0
        self._probes_left = 0
        self._opened_at = 0.0

    def _transition(self, new_state: str) -> None:
        old, self.state = self.state, new_state
        self.transitions.append((old, new_state))
        metrics.BREAKER_TRANSITIONS.inc()
        if self.events is not None:
            self.events.record(
                "breaker", name=self.name, frm=old, to=new_state
            )

    def allow(self) -> bool:
        """May the protected operation run right now? Open breakers deny
        until the re-probe budget matures, then admit a half-open probe."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            matured = False
            if self.clock is not None:
                matured = (
                    self.clock.now() - self._opened_at >= self.reset_timeout_s
                )
            if not matured and self.denied_budget is not None:
                self._denied += 1
                matured = self._denied >= self.denied_budget
            if not matured:
                return False
            self._transition(self.HALF_OPEN)
            self._probes_left = self.half_open_probes
        # half-open: admit probes while the budget lasts
        if self._probes_left > 0:
            self._probes_left -= 1
            return True
        return False

    def record_success(self) -> None:
        self._failures = 0
        if self.state != self.CLOSED:
            self._transition(self.CLOSED)
        self._denied = 0

    def record_failure(self) -> None:
        if self.state == self.HALF_OPEN:
            self._reopen()
            return
        self._failures += 1
        if self.state == self.CLOSED and self._failures >= self.failure_threshold:
            self._reopen()

    def _reopen(self) -> None:
        if self.state != self.OPEN:
            self._transition(self.OPEN)
        self._failures = 0
        self._denied = 0
        self._probes_left = 0
        if self.clock is not None:
            self._opened_at = self.clock.now()

    def call(self, fn, failure_types=(ConnectionError, OSError)):
        """Run ``fn()`` under the breaker: raises ``BreakerOpen`` without
        calling when open; records the outcome otherwise."""
        if not self.allow():
            raise BreakerOpen(f"{self.name} is {self.state}")
        try:
            out = fn()
        except failure_types:
            self.record_failure()
            raise
        self.record_success()
        return out


class AllEndpointsFailed(ConnectionError):
    """Every ranked endpoint failed (or was skipped) in a failover pass.
    ``last`` carries the final endpoint error, None if nothing was
    attempted."""

    def __init__(self, msg: str, last: BaseException | None = None):
        super().__init__(msg)
        self.last = last


class HealthTracker:
    """Per-endpoint health scores over a sliding window of recent call
    outcomes (the beacon_node_fallback.rs candidate-ranking seat).

    * ``score`` is the success fraction of the last ``window`` outcomes;
      unknown endpoints score 1.0 (optimistic -- a fresh endpoint is
      tried before a known-bad one).
    * ``ranked`` keeps eligible endpoints in input (priority) order and
      sinks demoted ones (score < threshold) to the back until their
      re-probe budget matures -- by injected-clock time
      (``reprobe_after_s``) or, clock-free, after being passed over
      ``reprobe_after_skips`` times -- so a recovered endpoint wins its
      priority slot back instead of being demoted forever.
    """

    def __init__(
        self,
        clock=None,
        window: int = 8,
        threshold: float = 0.5,
        reprobe_after_s: float | None = None,
        reprobe_after_skips: int = 4,
        events: EventLog | None = None,
        name: str = "endpoints",
    ):
        self.clock = clock
        self.window = window
        self.threshold = threshold
        self.reprobe_after_s = reprobe_after_s
        self.reprobe_after_skips = reprobe_after_skips
        self.events = events
        self.name = name
        self._outcomes: dict = {}
        self._last_failure: dict = {}
        self._skips: dict = {}

    def record(self, key, ok: bool) -> None:
        dq = self._outcomes.get(key)
        if dq is None:
            dq = self._outcomes[key] = deque(maxlen=self.window)
        was_healthy = self.is_healthy(key)
        dq.append(bool(ok))
        self._skips[key] = 0
        if not ok and self.clock is not None:
            self._last_failure[key] = self.clock.now()
        metrics.ENDPOINT_HEALTH.set(f"{self.name}/{key}", self.score(key))
        if self.events is not None and was_healthy and not self.is_healthy(key):
            self.events.record("demoted", name=self.name, key=str(key))

    def score(self, key) -> float:
        dq = self._outcomes.get(key)
        if not dq:
            return 1.0
        return sum(dq) / len(dq)

    def is_healthy(self, key) -> bool:
        return self.score(key) >= self.threshold

    def reprobe_due(self, key) -> bool:
        """A demoted endpoint's re-probe budget has matured."""
        if self.clock is not None and self.reprobe_after_s is not None:
            last = self._last_failure.get(key)
            return (
                last is None
                or self.clock.now() - last >= self.reprobe_after_s
            )
        return self._skips.get(key, 0) >= self.reprobe_after_skips

    def eligible(self, key) -> bool:
        return self.is_healthy(key) or self.reprobe_due(key)

    def ranked(self, keys) -> list:
        """Keys ordered best-first: ELIGIBLE endpoints in input order
        (input order is the operator's priority list -- a recovered
        primary must win its slot back from a healthy-but-lagging
        fallback, so scores demote and re-probe, they never permanently
        reorder the healthy set), then demoted-and-not-yet-reprobable
        endpoints by descending score as a last resort. A matured
        re-probe is eligible, so it actually receives a probe whose
        outcome immediately re-scores it. Each pass over a demoted key
        spends one skip of its clock-free re-probe budget."""
        keys = list(keys)
        eligible, demoted = [], []
        for k in keys:
            (eligible if self.eligible(k) else demoted).append(k)
        for k in demoted:
            self._skips[k] = self._skips.get(k, 0) + 1
        return eligible + sorted(demoted, key=lambda k: -self.score(k))

    def failover(
        self,
        targets,
        fn,
        retry_on=(ConnectionError, OSError),
        skip=None,
        on_error=None,
    ):
        """THE ranked-failover loop (shared by the eth1 multi-provider
        and the VC beacon-node fallback): try ``fn(target)`` over
        targets in ranked order, recording each outcome by index.
        Returns ``(index, result)`` of the first success; raises
        ``AllEndpointsFailed`` (carrying the last error) when every
        target failed or was skipped."""
        targets = list(targets)
        last = None
        for i in self.ranked(range(len(targets))):
            target = targets[i]
            if skip is not None and skip(target):
                continue
            try:
                out = fn(target)
            except retry_on as e:
                self.record(i, False)
                if on_error is not None:
                    on_error(i, e)
                last = e
                continue
            self.record(i, True)
            return i, out
        raise AllEndpointsFailed(
            f"all {len(targets)} endpoints failed or were skipped",
            last=last,
        ) from last

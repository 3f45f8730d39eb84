"""Resilience primitives the fallback backend uses: a copy of
``VirtualClock``, ``EventLog``, ``BreakerOpen`` and ``CircuitBreaker``
from lighthouse_tpu/resilience/primitives.py.

Deterministic by construction: time comes from an injected clock with
``now()`` (wall time never enters), and every breaker transition can be
recorded into an ``EventLog``, so two runs of one failure script give
equal event sequences.
"""

from __future__ import annotations

from ..utils import metrics


class VirtualClock:
    """A manually-advanced clock: the deterministic stand-in for wall
    time, so a clocked ``CircuitBreaker`` re-probes without a single
    real sleep."""

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

"""Deterministic fault injection: seeded schedules of errors, delays,
and hangs wrappable around any provider/backend/engine duck type.

``FaultPlan`` decides, per intercepted call and in call order, whether
to pass through, raise, inject latency, or hang. Decisions come from a
``random.Random(seed)`` plus optional per-operation scripts, so the
same seed and the same call sequence replay the same fault schedule --
the determinism contract the chaos tests assert.

Fault types deliberately subclass the stdlib transport errors
(``ConnectionError`` / ``TimeoutError``) so every existing narrow
handler in the stack -- sync's ``except (ConnectionError, OSError)``,
the eth1/engine retry paths -- treats injected faults exactly like real
ones, with no test-only branches in production code.

The port's copy of lighthouse_tpu/resilience/faults.py.
"""

from __future__ import annotations

import random

from .primitives import EventLog


class FaultInjected(ConnectionError):
    """An injected transport/backend error."""


class InjectedHang(TimeoutError):
    """An injected hang: the call never completes within any deadline.
    The plan advances the injected clock past ``hang_s`` first, so
    ``Timeout``-style deadline checks see the elapsed time too."""


OK = "ok"
ERROR = "error"
DELAY = "delay"
HANG = "hang"


class FaultPlan:
    """A seeded schedule of faults.

    Random mode: each intercepted call draws once from the seeded rng
    and maps the draw onto (error | delay | hang | ok) by the configured
    rates. Scripted mode: ``script(op, [ERROR, OK, DELAY, ...])`` pins
    the first N decisions for one operation (matched by exact
    ``"name.method"`` or bare proxy ``name``); the rng covers the rest.

    ``clock`` (a VirtualClock or anything with ``advance``) absorbs
    injected latency; ``events`` records every non-ok decision for
    replay comparison.
    """

    def __init__(
        self,
        seed: int = 0,
        error_rate: float = 0.0,
        delay_rate: float = 0.0,
        hang_rate: float = 0.0,
        delay_s: float = 0.1,
        hang_s: float = 60.0,
        clock=None,
        events: EventLog | None = None,
    ):
        self.seed = seed
        self.rng = random.Random(seed)
        self.error_rate = error_rate
        self.delay_rate = delay_rate
        self.hang_rate = hang_rate
        self.delay_s = delay_s
        self.hang_s = hang_s
        self.clock = clock
        self.events = events if events is not None else EventLog()
        self._scripts: dict[str, list[str]] = {}
        self.calls = 0
        self.injected = 0

    # -- schedule ------------------------------------------------------------

    def script(self, op: str, actions) -> "FaultPlan":
        """Pin the next decisions for `op` ("name.method" or bare proxy
        name); entries may also be ``("delay", seconds)`` tuples."""
        self._scripts.setdefault(op, []).extend(actions)
        return self

    def fail_next(self, op: str, n: int = 1) -> "FaultPlan":
        return self.script(op, [ERROR] * n)

    def set_rates(
        self,
        error_rate: float = 0.0,
        delay_rate: float = 0.0,
        hang_rate: float = 0.0,
    ) -> "FaultPlan":
        """Phase-scoped rate swap (the scenario harness composes ONE plan
        across adversarial phases instead of re-wrapping transports
        mid-run). Determinism is preserved across phases: every
        intercepted call draws from the seeded rng exactly once whatever
        the rates, so changing a phase's rates never shifts the schedule
        of later phases."""
        self.error_rate = float(error_rate)
        self.delay_rate = float(delay_rate)
        self.hang_rate = float(hang_rate)
        return self

    def clear_scripts(self) -> None:
        """Drop all pending scripted decisions ("the outage ends"); the
        seeded rng keeps scheduling."""
        self._scripts.clear()

    def _draw(self) -> str:
        r = self.rng.random()
        if r < self.error_rate:
            return ERROR
        if r < self.error_rate + self.delay_rate:
            return DELAY
        if r < self.error_rate + self.delay_rate + self.hang_rate:
            return HANG
        return OK

    def decide(self, op: str):
        """The (action, detail) for the next call of `op`. Scripted
        decisions are consumed first; otherwise the seeded rng draws."""
        self.calls += 1
        action = None
        for key in (op, op.split(".", 1)[0]):
            queue = self._scripts.get(key)
            if queue:
                action = queue.pop(0)
                break
        if action is None:
            action = self._draw()
        seconds = None
        if isinstance(action, tuple):
            action, seconds = action
        if action == DELAY and seconds is None:
            seconds = self.delay_s
        if action == HANG and seconds is None:
            seconds = self.hang_s
        if action != OK:
            self.injected += 1
            self.events.record("fault", op=op, action=action)
        return action, seconds

    def apply(self, op: str) -> None:
        """Consume one decision for `op` and enact it (raise / advance
        the clock / pass). Called by the proxy before the real method."""
        action, seconds = self.decide(op)
        if action == OK:
            return
        if action == DELAY:
            if self.clock is not None:
                self.clock.advance(seconds)
            return
        if action == HANG:
            if self.clock is not None:
                self.clock.advance(seconds)
            raise InjectedHang(f"injected hang in {op}")
        raise FaultInjected(f"injected fault in {op}")

    # -- wrapping ------------------------------------------------------------

    def wrap(self, target, name: str, methods=None) -> "FaultyProxy":
        """A proxy over `target` whose method calls consult this plan.
        `methods` restricts interception to the named methods (all
        public callables by default)."""
        return FaultyProxy(self, target, name, methods)


class FaultyProxy:
    """Duck-type-preserving wrapper: attribute access passes through to
    the target; intercepted method calls first run the plan's decision
    for ``"{name}.{method}"``."""

    def __init__(self, plan: FaultPlan, target, name: str, methods=None):
        object.__setattr__(self, "_plan", plan)
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_name", name)
        object.__setattr__(
            self, "_methods", set(methods) if methods is not None else None
        )

    def __getattr__(self, attr):
        value = getattr(self._target, attr)
        if not callable(value) or attr.startswith("_"):
            return value
        if self._methods is not None and attr not in self._methods:
            return value
        plan, name = self._plan, self._name

        def intercepted(*args, **kwargs):
            plan.apply(f"{name}.{attr}")
            return value(*args, **kwargs)

        return intercepted

    def __setattr__(self, attr, value):
        setattr(self._target, attr, value)

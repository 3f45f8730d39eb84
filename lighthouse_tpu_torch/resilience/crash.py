"""Deterministic crash injection for the store layer: the process-death
counterpart of ``faults.FaultPlan``.

A seeded ``CrashPlan`` decides, per intercepted kv mutation and in op
order, whether the "process" survives the op, dies before it, dies
right after it, or tears it (a partial, unsynced write reaches the
store and THEN the process dies — the torn-FileStore-batch case). Same
seed => same crash schedule, the same determinism contract the chaos
suite asserts for FaultPlan.

``CrashingStore`` wraps any ``KeyValueStore`` and routes every put and
delete through the plan. It inherits the journaled ``do_atomically``
from the base class, so crash indices land exactly where a real crash
would: on the write-ahead intent record, between applied ops, and on
the commit-marker delete. Tests crash at EVERY op index of a batch,
"reopen" the inner store the way a restarted node would
(``HotColdDB(inner, ...)`` runs journal recovery), and assert the
result is byte-identical to either the pre-batch or post-batch state.

``InjectedCrash`` subclasses BaseException ON PURPOSE: a process death
must not be swallowable by any ``except Exception`` recovery path in
production code — only the test harness catches it.

The port's copy of lighthouse_tpu/resilience/crash.py.
"""

from __future__ import annotations

import random

from ..store.kv import KeyValueStore
from .primitives import EventLog


class InjectedCrash(BaseException):
    """The simulated process death (uncatchable by `except Exception`)."""


OK = "ok"
CRASH = "crash"  # die BEFORE the op: nothing reaches the store
TORN = "torn"  # half the value reaches the store, then die
AFTER = "after"  # the op completes, then die


class CrashPlan:
    """A seeded schedule of process deaths, counted in store ops.

    Pinned mode: ``crash_at=N`` kills the Nth intercepted mutation with
    ``action`` (CRASH/TORN/AFTER) — the exhaustive-matrix driver.
    Random mode: each op draws from the seeded rng and dies with
    probability ``crash_rate``. Every death is recorded in ``events``
    for replay comparison; after the first death the plan passes
    everything through (the "process" is already gone — a reopened
    store must not re-crash on recovery's own writes).
    """

    def __init__(
        self,
        seed: int = 0,
        crash_at: int | None = None,
        action: str = CRASH,
        crash_rate: float = 0.0,
        events: EventLog | None = None,
    ):
        self.seed = seed
        self.rng = random.Random(seed)
        self.crash_at = crash_at
        self.action = action
        self.crash_rate = crash_rate
        self.events = events if events is not None else EventLog()
        self.ops = 0
        self.crashed = False

    def arm(self, ops_from_now: int, action: str | None = None) -> "CrashPlan":
        """Phase-scoped (re-)arming: schedule the next death
        `ops_from_now` intercepted mutations from NOW. The scenario
        harness composes one plan across phases (arm it when the
        crash-recovery phase starts) instead of wrapping a fresh store
        mid-run; re-arming after a death models a node that dies again."""
        self.crash_at = self.ops + int(ops_from_now)
        if action is not None:
            self.action = action
        self.crashed = False
        return self

    def decide(self, op: str) -> str:
        index = self.ops
        self.ops += 1
        if self.crashed:
            return OK
        verdict = OK
        if self.crash_at is not None:
            if index == self.crash_at:
                verdict = self.action
        elif self.crash_rate and self.rng.random() < self.crash_rate:
            verdict = self.action
        if verdict != OK:
            self.crashed = True
            self.events.record("crash", op=op, index=index, action=verdict)
        return verdict


class CrashingStore(KeyValueStore):
    """KeyValueStore wrapper that dies at the Nth mutation op.

    Reads (`get`/`keys`) pass through uncounted — a crash schedule in
    store ops must not shift when a code path adds a lookup. The
    journaled base `do_atomically` is inherited unchanged, so batch
    crash points are exactly the journal write, each applied op, and
    the commit-marker delete."""

    def __init__(self, inner: KeyValueStore, plan: CrashPlan):
        self.inner = inner
        self.plan = plan

    def get(self, column, key):
        return self.inner.get(column, key)

    def keys(self, column):
        return self.inner.keys(column)

    def put(self, column, key, value):
        verdict = self.plan.decide("put")
        if verdict == CRASH:
            raise InjectedCrash(f"died before put (op {self.plan.ops - 1})")
        if verdict == TORN:
            value = bytes(value)
            self.inner.put(column, key, value[: len(value) // 2])
            raise InjectedCrash(f"torn put (op {self.plan.ops - 1})")
        self.inner.put(column, key, value)
        if verdict == AFTER:
            raise InjectedCrash(f"died after put (op {self.plan.ops - 1})")

    def delete(self, column, key):
        verdict = self.plan.decide("delete")
        if verdict in (CRASH, TORN):
            # a delete has no partial form: torn == died before
            raise InjectedCrash(f"died before delete (op {self.plan.ops - 1})")
        self.inner.delete(column, key)
        if verdict == AFTER:
            raise InjectedCrash(f"died after delete (op {self.plan.ops - 1})")

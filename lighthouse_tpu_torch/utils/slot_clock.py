"""Slot clocks (reference common/slot_clock: SystemTimeSlotClock +
manual_slot_clock.rs for tests).

This module is the ONE place consensus time enters the system: chain /
fork-choice / state-transition code takes a clock (or a timestamp) as a
parameter and never reads the wall clock directly -- that invariant is
enforced by `python -m tools.lint` (rule `wallclock`).
"""
# lint: allow-file[wallclock] -- the slot clock IS the injection boundary
# (The port's copy of lighthouse_tpu/utils/slot_clock.py.)

from __future__ import annotations

import time


class SystemSlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> float:
        """Seconds since the unix epoch; the only wall-clock read."""
        return time.time()

    def current_slot(self) -> int:
        now = self.now()
        if now < self.genesis_time:
            return 0
        return int(now - self.genesis_time) // self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        now = self.now()
        return (now - self.genesis_time) % self.seconds_per_slot


class ManualSlotClock:
    """Test clock advanced by hand (manual_slot_clock.rs)."""

    def __init__(self, genesis_time: int = 0, seconds_per_slot: int = 12):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self._slot = 0

    def now(self) -> float:
        """Deterministic: the start of the manually-set slot."""
        return float(self.genesis_time + self._slot * self.seconds_per_slot)

    def current_slot(self) -> int:
        return self._slot

    def set_slot(self, slot: int) -> None:
        self._slot = slot

    def advance_slot(self) -> None:
        self._slot += 1

    def seconds_into_slot(self) -> float:
        return 0.0

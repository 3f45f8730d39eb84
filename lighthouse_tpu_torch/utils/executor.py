"""Task executor with shutdown broadcast (reference common/task_executor/
src/lib.rs:181-291 + environment/src/lib.rs:418-520): every service
thread spawns through one executor that tracks it, a shutdown sender any
task can trigger (fatal errors), and a blocking wait that joins all
tasks — the graceful-shutdown spine the reference builds on tokio.

The port's copy of lighthouse_tpu/utils/executor.py.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field

from . import metrics


@dataclass
class ShutdownReason:
    message: str
    failure: bool = False


class TaskExecutor:
    def __init__(self, name: str = "env"):
        self.name = name
        self._threads: list[threading.Thread] = []
        self._shutdown = threading.Event()
        self._reason: ShutdownReason | None = None
        self._lock = threading.Lock()
        # families live in utils/metrics.py (metric-origin rule)
        self._tasks_total = metrics.EXECUTOR_TASKS_SPAWNED
        self._panics = metrics.EXECUTOR_TASK_PANICS

    # -- spawn (task_executor spawn / spawn_blocking) -----------------------

    def spawn(self, fn, name: str, *args, **kwargs) -> threading.Thread:
        """Run fn on a tracked daemon thread; an escaped exception triggers
        a failure shutdown (the reference logs + optionally exits)."""

        def run():
            try:
                fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 -- task boundary
                traceback.print_exc()
                self._panics.inc()
                self.shutdown(f"task {name!r} failed: {e}", failure=True)

        t = threading.Thread(target=run, name=f"{self.name}/{name}", daemon=True)
        with self._lock:
            if self._shutdown.is_set():
                raise RuntimeError("executor is shut down")
            self._threads.append(t)
        self._tasks_total.inc()
        t.start()
        return t

    def spawn_loop(self, fn, name: str, interval_s: float) -> threading.Thread:
        """Periodic task: fn() every interval until shutdown (the slot-timer
        and notifier pattern, timer/src/lib.rs:12-35)."""

        def loop():
            while not self._shutdown.wait(interval_s):
                fn()

        return self.spawn(loop, name)

    # -- shutdown broadcast --------------------------------------------------

    def shutdown(self, message: str = "requested", failure: bool = False) -> None:
        with self._lock:
            if self._reason is None:
                self._reason = ShutdownReason(message, failure)
        self._shutdown.set()

    @property
    def is_shutdown(self) -> bool:
        return self._shutdown.is_set()

    def shutdown_reason(self) -> ShutdownReason | None:
        return self._reason

    def wait_shutdown(self, timeout: float | None = None) -> bool:
        return self._shutdown.wait(timeout)

    def join_all(self, timeout: float = 5.0) -> None:
        """Join tracked tasks after shutdown (environment's block-until-
        shutdown + drain). `timeout` is a SHARED budget across all
        threads, not per-thread."""
        import time as _time

        deadline = _time.monotonic() + timeout
        for t in list(self._threads):
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                break
            t.join(remaining)

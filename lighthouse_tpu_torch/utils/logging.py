"""Structured logging (reference common/logging + environment's slog
setup, environment/src/lib.rs:155-279): leveled key=value records to a
stream and/or file, optional JSON lines, per-service child loggers with
bound context — the slog `o!(...)` pattern.

The port's copy of lighthouse_tpu/utils/logging.py."""

from __future__ import annotations

import json
import sys
import threading
import time

LEVELS = {"trace": 5, "debug": 10, "info": 20, "warn": 30, "error": 40, "crit": 50}


class Logger:
    def __init__(
        self,
        level: str = "info",
        stream=None,
        path: str | None = None,
        json_lines: bool = False,
    ):
        self.level = LEVELS[level]
        self.context: dict = {}
        # child() is the ONLY other construction path (via __new__), and
        # it shares this sink dict + lock
        self._shared = {
            "stream": stream if stream is not None else sys.stderr,
            "file": open(path, "a") if path else None,
            "json": json_lines,
            "lock": threading.Lock(),
        }

    def child(self, **context) -> "Logger":
        """Bound-context child (slog o!): service loggers carry their
        service name on every record."""
        merged = {**self.context, **context}
        out = Logger.__new__(Logger)
        out.level = self.level
        out.context = merged
        out._shared = self._shared
        return out

    def _emit(self, level: str, msg: str, kv: dict) -> None:
        if LEVELS[level] < self.level:
            return
        record = {
            # lint: allow[wallclock] -- log timestamps are wall time by
            # definition; nothing downstream consumes them
            "ts": round(time.time(), 3),
            "level": level,
            "msg": msg,
            **self.context,
            **kv,
        }
        if self._shared["json"]:
            line = json.dumps(record)
        else:
            pairs = " ".join(
                f"{k}={v}" for k, v in record.items() if k not in ("ts", "level", "msg")
            )
            line = f"{record['ts']} {level.upper():5s} {msg}" + (
                f" | {pairs}" if pairs else ""
            )
        with self._shared["lock"]:
            print(line, file=self._shared["stream"])
            if self._shared["file"] is not None:
                print(line, file=self._shared["file"])
                self._shared["file"].flush()

    def trace(self, msg, **kv):
        self._emit("trace", msg, kv)

    def debug(self, msg, **kv):
        self._emit("debug", msg, kv)

    def info(self, msg, **kv):
        self._emit("info", msg, kv)

    def warn(self, msg, **kv):
        self._emit("warn", msg, kv)

    def error(self, msg, **kv):
        self._emit("error", msg, kv)

    def crit(self, msg, **kv):
        self._emit("crit", msg, kv)

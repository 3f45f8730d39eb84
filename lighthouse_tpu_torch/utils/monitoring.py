"""Remote monitoring push (reference common/monitoring_api/src/lib.rs):
periodically POST process/system/chain health JSON to a configured
endpoint (the beaconcha.in-style "remote monitoring" integration).

Payload shape mirrors the reference: a list of per-process records
`{sub_type, timestamp_s, data}` for the beacon node and/or validator
client, where `data` carries version metadata, process metrics
(cpu/memory/fds from getrusage + /proc), system metrics (load, total
memory, disk), and whatever chain gauges the caller wires in via
`data_sources` (head slot, sync state, validator count -- the fields
process_beacon_node/process_validator attach in lib.rs:218-268).

Transport is plain HTTP POST with bounded exponential-backoff retries,
failing fast on 4xx (a bad monitoring token is configuration, not an
outage) -- the same policy as the repo's JSON-RPC boundaries. The
in-process `MonitoringRig` receives pushes in tests.

The port's copy of lighthouse_tpu/utils/monitoring.py.
"""

from __future__ import annotations

import json
import os
import resource
import shutil
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

VERSION = "lighthouse-tpu/4.0"


class MonitoringError(RuntimeError):
    pass


def process_metrics() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        fds = -1
    return {
        "cpu_process_seconds_total": round(ru.ru_utime + ru.ru_stime, 3),
        "memory_process_bytes": ru.ru_maxrss * 1024,
        "process_open_fds": fds,
    }


def system_metrics() -> dict:
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:
        load1 = load5 = load15 = 0.0
    try:
        total_mem = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        total_mem = 0
    disk = shutil.disk_usage(os.getcwd())
    return {
        "cpu_cores": os.cpu_count() or 0,
        "system_load_1": round(load1, 3),
        "system_load_5": round(load5, 3),
        "system_load_15": round(load15, 3),
        "memory_total_bytes": total_mem,
        "disk_total_bytes": disk.total,
        "disk_free_bytes": disk.free,
    }


class MonitoringService:
    """Collect-and-push loop. `data_sources` maps sub_type
    ("beacon_node" / "validator") to a zero-arg callable returning that
    process's chain-level fields; system metrics ride along once."""

    def __init__(
        self,
        endpoint: str,
        data_sources: dict | None = None,
        update_period_s: float = 60.0,
        retries: int = 3,
        backoff_s: float = 0.05,
        timeout_s: float = 5.0,
        clock=time.time,
    ):
        self.endpoint = endpoint
        self.data_sources = dict(data_sources or {"beacon_node": dict})
        self.update_period_s = update_period_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.clock = clock
        self.stats = {"sent": 0, "failed": 0}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- payload ---------------------------------------------------------------

    def collect(self) -> list:
        now = int(self.clock())
        records = []
        for sub_type, source in self.data_sources.items():
            data = {"version": VERSION}
            data.update(process_metrics())
            try:
                data.update(source() or {})
            except Exception as e:  # noqa: BLE001 -- a sick chain still reports
                data["source_error"] = str(e)[:200]
            records.append(
                {"sub_type": "process", "process": sub_type,
                 "timestamp_s": now, "data": data}
            )
        records.append(
            {"sub_type": "system", "timestamp_s": now, "data": system_metrics()}
        )
        return records

    # -- transport -------------------------------------------------------------

    def send_once(self) -> None:
        payload = json.dumps(self.collect()).encode()
        last = None
        for attempt in range(self.retries):
            try:
                req = urllib.request.Request(
                    self.endpoint,
                    data=payload,
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    self.stats["sent"] += 1
                    return
            except urllib.error.HTTPError as e:
                if 400 <= e.code < 500:
                    self.stats["failed"] += 1
                    raise MonitoringError(
                        f"monitoring endpoint rejected push: HTTP {e.code}"
                    ) from None
                last = e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last = e
            if attempt < self.retries - 1:
                time.sleep(self.backoff_s * (2**attempt))
        self.stats["failed"] += 1
        raise MonitoringError(f"monitoring push failed after retries: {last}")

    # -- loop ------------------------------------------------------------------

    def start(self) -> "MonitoringService":
        def loop():
            while not self._stop.is_set():
                try:
                    self.send_once()
                except MonitoringError:
                    pass  # counted; the loop keeps its cadence
                self._stop.wait(self.update_period_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class MonitoringRig:
    """In-process receiver for pushes (test stand-in for the remote
    service): records bodies, can inject transient 503s or a hard 401."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.received: list = []
        self.fail_next = 0
        self.reject_all = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                if outer.reject_all:
                    self.send_error(401)
                    return
                if outer.fail_next > 0:
                    outer.fail_next -= 1
                    self.send_error(503)
                    return
                length = int(self.headers.get("Content-Length", "0"))
                outer.received.append(json.loads(self.rfile.read(length)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.url = f"http://{host}:{self._server.server_address[1]}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def start(self) -> "MonitoringRig":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# the process registry's histograms that `trace_health_fields` reads: each
# health field and the histogram's name in utils/metrics. Named here so
# that a caller that must start them fresh (the scenario phase of
# chip_smoke.py, the tests) reads the same list.
HEALTH_HISTOGRAMS = (
    ("queue_wait", "PROCESSOR_QUEUE_WAIT"),
    ("block_observed_delay", "BLOCK_OBSERVED_DELAY"),
    ("block_imported_delay", "BLOCK_IMPORTED_DELAY"),
    ("block_head_delay", "BLOCK_HEAD_DELAY"),
)


def trace_health_fields(tracer=None) -> dict:
    """Trace/metrics-derived health: p95 work-span durations per
    processor lane (from the span ring) plus queue-wait and slot-delay
    p95s (from the shared registry's histograms). This is the ONE code
    path for these numbers — the remote monitoring push attaches them
    and the scenario harness's SLO checker asserts against them."""
    from . import metrics as M
    from . import tracing

    t = tracer if tracer is not None else tracing.default_tracer()
    work: dict[str, list[float]] = {}
    for s in t.finished_spans():
        if s.name.startswith("work/") and s.end is not None:
            work.setdefault(s.name[len("work/"):], []).append(s.duration())
    fields: dict = {}
    for lane, durs in sorted(work.items()):
        durs.sort()
        idx = min(len(durs) - 1, int(0.95 * len(durs)))
        fields[f"work_p95_{lane}_seconds"] = round(durs[idx], 9)
    for name, metric in HEALTH_HISTOGRAMS:
        v = getattr(M, metric).quantile(0.95)
        if v is not None:
            fields[f"{name}_p95_seconds"] = v
    return fields


def ledger_health_fields(ledger=None) -> dict:
    """Launch-ledger-derived health: merged-launch occupancy, the
    pad-waste ratio, compile tax, and withheld-speculation counts from
    the per-launch flight recorder (obs/ledger.py). Like
    trace_health_fields, this is the ONE code path — the remote
    monitoring push attaches it and the scenario harness's SLO report
    carries the same numbers."""
    from ..obs import ledger as launch_ledger

    led = ledger if ledger is not None else launch_ledger.default_ledger()
    stats = led.stats()
    fields: dict = {
        "launch_records": stats["records"],
        "launch_dropped": stats["dropped"],
        "cold_dispatches": stats["compile_tax_s"]["cold_dispatches"],
        "warm_compile_s_total": stats["compile_tax_s"]["total_s"],
        "speculative_withheld_total": stats["speculative_withheld_total"],
    }
    kind = stats.get("pad_waste_kind")
    occ = stats["occupancy"].get(kind) if kind else None
    if occ is not None:
        fields["launch_occupancy"] = occ["ratio"]
        fields["pad_waste_ratio"] = round(1.0 - occ["ratio"], 4)
    return fields


def beacon_node_source(chain, serving=None) -> dict:
    """Chain-level fields for the beacon_node record (lib.rs:218-243),
    plus the trace-derived health block, the
    launch-ledger health block, and — when a serving tier is wired —
    its cache/SSE/admission counters."""
    head_root, head_state = chain.head()
    fin_epoch, _ = chain.finalized_checkpoint
    health = trace_health_fields()
    health["ledger"] = ledger_health_fields()
    fields = {
        "slot": int(chain.current_slot),
        "head_slot": int(head_state.slot),
        "head_root": "0x" + bytes(head_root).hex(),
        "finalized_epoch": int(fin_epoch),
        "validator_count": len(head_state.validators),
        "is_synced": int(chain.current_slot) <= int(head_state.slot) + 1,
        "health": health,
    }
    if serving is not None:
        fields["serving"] = serving.stats()
    return fields

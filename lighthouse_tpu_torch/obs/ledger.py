"""Launch ledger: a deterministic per-launch flight recorder, a copy of
lighthouse_tpu/obs/ledger.py.

Each seam that launches device work appends one :class:`LaunchRecord`:

  * ``"pipeline"`` -- a VerifyPipeline batch dispatch (crypto/bls/
    pipeline.py), real set count vs the padded capacity it was asked
    to take;
  * ``"sched"`` -- a continuous-batching merged launch (crypto/bls/
    scheduler.py), with the admission audit: lane mix, per-lane set
    counts, the deadline slot, and the ``speculative_withheld`` /
    ``real_queued_before`` preemption facts;
  * ``"dispatch"`` -- a torch_cuda backend dispatch (backends/
    torch_cuda.py): bucketed shape, distinct-message count, Miller-pair
    count, and whether its stage graphs were already captured;
  * ``"mesh"`` -- a sharded launch (kept for the JAX package's record
    layout; the port has no mesh yet);
  * ``"warm"`` -- one warm_compile bucket, its shape and capture seconds.

Records land in a bounded ring (overflow drops the oldest, counted);
timestamps come from the process tracer's injected clock and trace/span
ids from the ambient span context, so a seeded run exports a
byte-identical dump. Derived stats are pure functions of a record list
(:func:`stats_from_records`), rendered by :func:`format_report`.

``LIGHTHOUSE_TPU_LEDGER=0`` disables recording (the seams early-out);
``LIGHTHOUSE_TPU_LEDGER_CAPACITY`` sizes the ring (default
``DEFAULT_CAPACITY``, 4096); both are read per call, as the JAX package
reads them. :func:`configure` replaces the process ledger (a clock, a
capacity, ``enabled=False``).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque

_CHROME_CAT = "lighthouse"

#: the process ledger's ring size
DEFAULT_CAPACITY = 4096

#: the seam kinds, in the order a merged launch flows through them. A
#: single scheduler launch produces one record PER seam it crosses
#: ("sched" -> "pipeline" -> "dispatch" [-> "mesh"]), so derived stats
#: always group by kind and never sum across kinds.
KINDS = ("pipeline", "sched", "dispatch", "mesh", "warm")

_FIELDS = (
    "seq", "ts", "kind", "bucket", "real_sets", "padded_sets", "entries",
    "lanes", "lane_sets", "slot", "n_messages", "miller_pairs",
    "cache_hit", "compile_seconds", "chip_seconds", "devices",
    "speculative_withheld", "real_queued_before", "trace_id", "span_id",
)


class LaunchRecord:
    """One device program launch. Fields a seam cannot know are None
    (e.g. the pipeline does not know the Miller-pair count; the mesh
    does not know the lane mix)."""

    __slots__ = _FIELDS

    def __init__(self, seq, ts, kind, **fields):
        self.seq = seq
        self.ts = ts
        self.kind = kind
        for name in _FIELDS[3:]:
            setattr(self, name, fields.pop(name, None))
        if fields:
            raise TypeError(f"unknown LaunchRecord fields: {sorted(fields)}")

    def to_dict(self) -> dict:
        d = {name: getattr(self, name) for name in _FIELDS}
        # ids render like the chrome-trace export (16-hex) so a dump
        # cross-links into a trace dump of the same run by string match
        for key in ("trace_id", "span_id"):
            if d[key] is not None:
                d[key] = f"{d[key]:016x}"
        if d["lanes"] is not None:
            d["lanes"] = list(d["lanes"])
        return d


class Ledger:
    """Bounded, drop-counted launch ring.

    ``clock`` defaults to reading the PROCESS tracer's injected clock at
    every record, so scenario/bench clock injection covers the ledger
    with no extra wiring. ``Ledger._lock`` is a LEAF lock (LOCK_ORDER):
    seams record while holding scheduler/launch locks, so nothing --
    no clock read, no tracer call, no metric -- happens inside it.
    """

    def __init__(self, clock=None, capacity: int | None = None,
                 enabled: bool = True):
        if capacity is None:
            capacity = _default_capacity()
        self._clock = clock
        self.capacity = int(capacity)
        self.enabled = enabled
        self._records: deque[LaunchRecord] = deque(maxlen=self.capacity)
        self._next_seq = 0
        self.dropped = 0
        self._lock = threading.Lock()

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock.now()
        from ..utils import tracing

        return tracing.default_tracer().clock.now()

    def record(self, kind: str, **fields) -> LaunchRecord | None:
        if not self.enabled:
            return None
        if kind not in KINDS:
            raise ValueError(f"unknown ledger kind: {kind!r}")
        from ..utils import tracing

        # clock + ambient span context are read BEFORE the leaf lock:
        # the tracer has its own lock and the clocks have theirs
        ts = self._now()
        ctx = tracing.current()
        if ctx is not None:
            fields.setdefault("trace_id", ctx.trace_id)
            fields.setdefault("span_id", ctx.span_id)
        with self._lock:
            rec = LaunchRecord(self._next_seq, ts, kind, **fields)
            self._next_seq += 1
            if len(self._records) == self._records.maxlen:
                self.dropped += 1  # overflow sheds the OLDEST record
            self._records.append(rec)
            return rec

    # -- reads ---------------------------------------------------------------

    def records(self) -> list[LaunchRecord]:
        with self._lock:
            return list(self._records)

    def status(self) -> dict:
        with self._lock:
            kinds: dict[str, int] = {}
            for r in self._records:
                kinds[r.kind] = kinds.get(r.kind, 0) + 1
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "recorded": len(self._records),
                "dropped": self.dropped,
                "kinds": kinds,
            }

    def stats(self, window_s: float | None = None) -> dict:
        recs = self.records()
        if window_s is not None and recs:
            horizon = recs[-1].ts - float(window_s)
            recs = [r for r in recs if r.ts >= horizon]
        return stats_from_records(recs, dropped=self.dropped)

    def report_text(self) -> str:
        return format_report(self.stats())

    # -- export --------------------------------------------------------------

    def dump(self) -> dict:
        with self._lock:
            recs = list(self._records)
        recs.sort(key=lambda r: (r.ts, r.seq))
        return {
            "capacity": self.capacity,
            "dropped": self.dropped,
            "records": [r.to_dict() for r in recs],
        }

    def dump_json(self) -> str:
        """Sorted-keys JSON of the whole ring: the byte-comparable
        replay surface (`assert_bit_identical_replay`)."""
        return json.dumps(self.dump(), sort_keys=True)

    def chrome_counter_events(self) -> list[dict]:
        """Chrome trace "C" counter events, one track per kind: the
        real/pad split of every launch, mergeable into a span dump's
        `traceEvents` so Perfetto draws occupancy next to the spans."""
        events = []
        for r in sorted(self.records(), key=lambda r: (r.ts, r.seq)):
            if r.real_sets is None and r.padded_sets is None:
                continue
            real = r.real_sets or 0
            padded = r.padded_sets if r.padded_sets is not None else real
            events.append({
                "name": f"ledger/{r.kind}",
                "cat": _CHROME_CAT,
                "ph": "C",
                "ts": round(r.ts * 1e6, 3),
                "pid": 1,
                "args": {"real": real, "pad": max(0, padded - real)},
            })
        return events

    def reset(self) -> None:
        """Clear the ring; seq keeps counting (a reset mid-run must not
        replay old sequence numbers), mirroring Tracer.reset."""
        with self._lock:
            self._records.clear()
            self.dropped = 0


# -- derived stats (pure: a record list in, a stats dict out) -----------------


def _as_dict(rec) -> dict:
    return rec if isinstance(rec, dict) else rec.to_dict()


def stats_from_records(records, dropped: int = 0) -> dict:
    """Rolling-window stats over `records` (LaunchRecords or dump
    dicts). Grouped BY KIND throughout: one merged launch crosses
    several seams, so summing across kinds would double-count it."""
    recs = [_as_dict(r) for r in records]
    occupancy: dict[str, dict] = {}
    for r in recs:
        if r["real_sets"] is None and r["padded_sets"] is None:
            continue
        real = r["real_sets"] or 0
        padded = r["padded_sets"] if r["padded_sets"] is not None else real
        o = occupancy.setdefault(
            r["kind"], {"launches": 0, "real": 0, "padded": 0}
        )
        o["launches"] += 1
        o["real"] += real
        o["padded"] += padded
    for o in occupancy.values():
        o["ratio"] = round(o["real"] / o["padded"], 4) if o["padded"] else 0.0

    # pad-waste per bucket from the most upstream kind present: the
    # scheduler chose the padding, so its records are authoritative;
    # without a scheduler the backend's bucketing is the padding source
    waste_kind = next(
        (k for k in ("sched", "dispatch", "pipeline") if k in occupancy),
        None,
    )
    pad_waste: dict[str, dict] = {}
    for r in recs:
        if r["kind"] != waste_kind or r["bucket"] is None:
            continue
        real = r["real_sets"] or 0
        padded = r["padded_sets"] if r["padded_sets"] is not None else real
        b = pad_waste.setdefault(
            str(r["bucket"]), {"launches": 0, "real": 0, "padded": 0}
        )
        b["launches"] += 1
        b["real"] += real
        b["padded"] += padded
    for b in pad_waste.values():
        b["waste_ratio"] = (
            round((b["padded"] - b["real"]) / b["padded"], 4)
            if b["padded"] else 0.0
        )

    launch_kind = "sched" if "sched" in occupancy else waste_kind
    slots = sorted({
        r["slot"] for r in recs
        if r["kind"] == launch_kind and r["slot"] is not None
    })
    slot_launches = sum(
        1 for r in recs
        if r["kind"] == launch_kind and r["slot"] is not None
    )
    launches_per_slot = {
        "slots": len(slots),
        "launches": slot_launches,
        "mean": round(slot_launches / len(slots), 4) if slots else 0.0,
    }

    per_shape: dict[str, float] = {}
    for r in recs:
        if r["kind"] == "warm" and r["compile_seconds"] is not None:
            key = str(r["bucket"])
            per_shape[key] = round(
                per_shape.get(key, 0.0) + r["compile_seconds"], 6
            )
    compile_tax = {
        "per_shape_s": per_shape,
        "total_s": round(sum(per_shape.values()), 6),
        # dispatches whose shape family was COLD (a stage-graph capture
        # on the hot path -- the warm-bucket contract's violation counter)
        "cold_dispatches": sum(
            1 for r in recs
            if r["kind"] == "dispatch" and r["cache_hit"] is False
        ),
    }

    lane_sets: dict[str, int] = {}
    for r in recs:
        if r["kind"] == "sched" and r["lane_sets"]:
            for lane, n in r["lane_sets"].items():
                lane_sets[lane] = lane_sets.get(lane, 0) + int(n)
    total_lane = sum(lane_sets.values())
    lane_share = {
        lane: round(n / total_lane, 4)
        for lane, n in sorted(lane_sets.items())
    } if total_lane else {}

    return {
        "records": len(recs),
        "dropped": int(dropped),
        "occupancy": occupancy,
        "pad_waste_per_bucket": pad_waste,
        "pad_waste_kind": waste_kind,
        "launches_per_slot": launches_per_slot,
        "compile_tax_s": compile_tax,
        "lane_share": lane_share,
        "speculative_withheld_total": sum(
            r["speculative_withheld"] or 0
            for r in recs if r["kind"] == "sched"
        ),
    }


def format_report(stats: dict, lanes: dict | None = None) -> str:
    """The occupancy / pad-waste / compile-tax table. `lanes` is an
    optional per-lane p50/p95 block ({lane: {"p50_ms": ...,
    "p95_ms": ...}}); the JAX package's renderer, line for line."""
    lines = [
        f"launch ledger: {stats['records']} records"
        f" ({stats['dropped']} dropped)",
        "",
        f"{'kind':<10}{'launches':>9}{'real':>8}{'padded':>8}{'occupancy':>11}",
    ]
    for kind in KINDS:
        o = stats["occupancy"].get(kind)
        if o is None:
            continue
        lines.append(
            f"{kind:<10}{o['launches']:>9}{o['real']:>8}"
            f"{o['padded']:>8}{o['ratio']:>11.4f}"
        )
    lines += [
        "",
        f"pad waste per bucket ({stats.get('pad_waste_kind')} launches):",
        f"{'bucket':<10}{'launches':>9}{'real':>8}{'padded':>8}{'waste':>9}",
    ]
    for bucket, b in sorted(
        stats["pad_waste_per_bucket"].items(),
        key=lambda kv: (len(kv[0]), kv[0]),
    ):
        lines.append(
            f"{bucket:<10}{b['launches']:>9}{b['real']:>8}"
            f"{b['padded']:>8}{b['waste_ratio']:>9.4f}"
        )
    lps = stats["launches_per_slot"]
    lines += [
        "",
        f"launches/slot: {lps['mean']}"
        f" ({lps['launches']} launches over {lps['slots']} slots)",
        "",
        f"compile tax: {stats['compile_tax_s']['total_s']}s warm,"
        f" {stats['compile_tax_s']['cold_dispatches']} cold dispatches",
    ]
    for shape, s in sorted(stats["compile_tax_s"]["per_shape_s"].items()):
        lines.append(f"  {shape:<16}{s:>10.4f}s")
    if stats["lane_share"]:
        lines.append("")
        lines.append("lane share (real sets per merged launch):")
        for lane, share in stats["lane_share"].items():
            lines.append(f"  {lane:<14}{share:>8.4f}")
    if stats.get("speculative_withheld_total"):
        lines.append(
            "speculation withheld at real launches: "
            f"{stats['speculative_withheld_total']}"
        )
    if lanes:
        lines += [
            "",
            "per-lane time-to-verdict:",
            f"{'lane':<14}{'p50_ms':>9}{'p95_ms':>9}",
        ]
        for lane, row in sorted(lanes.items()):
            p50 = row.get("p50_ms")
            p95 = row.get("p95_ms")
            if p50 is None and p95 is None:
                continue
            lines.append(f"{lane:<14}{p50:>9}{p95:>9}")
    return "\n".join(lines)


# -- module-level default (the seat the seams consult) ------------------------


def _default_capacity() -> int:
    try:
        return int(os.environ.get("LIGHTHOUSE_TPU_LEDGER_CAPACITY",
                                  str(DEFAULT_CAPACITY)))
    except ValueError:
        return DEFAULT_CAPACITY


def enabled() -> bool:
    """The ledger records unless explicitly disabled
    (`LIGHTHOUSE_TPU_LEDGER=0`); read per call so operators and tests
    flip it without reimport."""
    return os.environ.get("LIGHTHOUSE_TPU_LEDGER", "1") != "0"


_DEFAULT: Ledger | None = None


def default_ledger() -> Ledger:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Ledger()
    return _DEFAULT


def configure(**kwargs) -> Ledger:
    """Replace the process ledger (scenario runs / benches inject
    clock/capacity here, mirroring tracing.configure)."""
    global _DEFAULT
    _DEFAULT = Ledger(**kwargs)
    return _DEFAULT


def record(kind: str, **fields) -> None:
    """The seam entry point: append one launch record to the CURRENT
    default ledger (looked up per call, so configure() swaps apply
    mid-process); no-op when disabled."""
    if not enabled():
        return
    default_ledger().record(kind, **fields)

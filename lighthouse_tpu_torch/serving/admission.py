"""Load-shedding admission control for the HTTP API. Routes are
classified into three lanes:

- ``validator`` — duty-critical traffic (validator namespace, block and
  pool publication, liveness probes). NEVER shed: a 503 here is a
  missed attestation, strictly worse than any latency.
- ``read_only`` — standard beacon reads (explorers, dashboards). Shed
  once backpressure exceeds ``read_only_factor`` x threshold.
- ``debug`` — lighthouse/ and debug/ introspection. Shed first, at
  1x threshold.

The backpressure signal reuses the processor's telemetry: the windowed p95 of
``beacon_processor_queue_wait_seconds`` and the block-import slot-delay
p95, plus (optionally) the beacon processor's live pending depth. Shed
responses carry ``Retry-After`` so well-behaved clients back off
instead of hammering an overloaded node.

The port's copy of lighthouse_tpu/serving/admission.py.
"""

from __future__ import annotations

import threading

VALIDATOR = "validator"
READ_ONLY = "read_only"
DEBUG = "debug"

# non-validator-namespace paths that still serve the duty cycle: block
# and operation publication, plus the probes VCs gate duties on
_VALIDATOR_POST_PATHS = (
    "/eth/v1/beacon/blocks",
    "/eth/v1/beacon/blinded_blocks",
    "/eth/v1/beacon/pool/",
)
_VALIDATOR_ALWAYS = (
    "/eth/v1/node/health",
    "/eth/v1/node/syncing",
    "/metrics",
)


def classify_lane(method: str, path: str) -> str:
    if path.startswith(("/eth/v1/validator/", "/eth/v2/validator/")):
        return VALIDATOR
    if path in _VALIDATOR_ALWAYS:
        return VALIDATOR
    if method == "POST" and path.startswith(_VALIDATOR_POST_PATHS):
        return VALIDATOR
    if path.startswith(
        ("/lighthouse/", "/eth/v1/debug/", "/eth/v2/debug/")
    ):
        return DEBUG
    return READ_ONLY


class MetricsHealthSource:
    """Windowed p95s over the shared registry's backpressure histograms.

    Baselines are snapshotted at construction so process-global history
    (earlier load, other components) doesn't bleed into this server's
    shedding decisions, and each baseline rolls forward once `window`
    new samples have landed so pressure that has drained ages out."""

    def __init__(self, window: int = 512):
        from ..utils import metrics as M

        self._hists = {
            "queue_wait_p95_seconds": M.PROCESSOR_QUEUE_WAIT,
            "slot_delay_p95_seconds": M.BLOCK_IMPORTED_DELAY,
        }
        self.window = max(1, int(window))
        self._base = {n: h.snapshot() for n, h in self._hists.items()}
        self._lock = threading.Lock()

    def __call__(self) -> dict:
        out = {}
        with self._lock:
            for name, hist in self._hists.items():
                base = self._base[name]
                out[name] = hist.quantile(0.95, since=base)
                if hist.count - base[1] >= self.window:
                    self._base[name] = hist.snapshot()
        return out


class AdmissionController:
    def __init__(self, config, health_source=None, processor=None):
        self.config = config
        self.health_source = (
            health_source
            if health_source is not None
            else MetricsHealthSource()
        )
        self.processor = processor
        self._lock = threading.Lock()
        self.shed = {READ_ONLY: 0, DEBUG: 0}

    def pressure(self) -> float:
        """Worst signal/threshold ratio across the wired signals; 0.0
        when everything is under threshold or no signal has data."""
        cfg = self.config
        health = self.health_source() or {}
        ratios = [0.0]
        qw = health.get("queue_wait_p95_seconds")
        if qw is not None and cfg.queue_wait_p95_threshold_s > 0:
            ratios.append(qw / cfg.queue_wait_p95_threshold_s)
        sd = health.get("slot_delay_p95_seconds")
        if sd is not None and cfg.slot_delay_p95_threshold_s > 0:
            ratios.append(sd / cfg.slot_delay_p95_threshold_s)
        if self.processor is not None and cfg.pending_limit > 0:
            snap = self.processor.health_snapshot()
            ratios.append(snap["pending"] / cfg.pending_limit)
        return max(ratios)

    def admit(self, lane: str) -> tuple[bool, int]:
        """(admitted, retry_after_seconds). Validator traffic is always
        admitted; debug sheds at 1x threshold, read-only holds on until
        ``read_only_factor`` x."""
        if lane == VALIDATOR:
            return True, 0
        pressure = self.pressure()
        limit = 1.0 if lane == DEBUG else self.config.read_only_factor
        if pressure >= limit:
            from ..utils import metrics as M

            with self._lock:
                self.shed[lane] += 1
            if lane == DEBUG:
                M.SERVING_SHED_DEBUG.inc()
            else:
                M.SERVING_SHED_READ_ONLY.inc()
            return False, self.config.retry_after_s
        return True, 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "shed_read_only": self.shed[READ_ONLY],
                "shed_debug": self.shed[DEBUG],
                "pressure": round(self.pressure(), 6),
            }

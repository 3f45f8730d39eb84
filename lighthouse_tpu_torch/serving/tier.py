"""The serving tier: one object wiring the response cache, the live SSE
broadcaster, and the admission controller between ``BeaconApiServer``
and ``BeaconApi``. It registers a single sink on the chain's
``event_sinks`` so head/finality events simultaneously (a) invalidate
the cache entries their anchor governs and (b) fan out to every live
SSE subscriber.

The port's copy of lighthouse_tpu/serving/tier.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from .admission import AdmissionController
from .cache import FINALIZED, HEAD, IMMUTABLE, ResponseCache
from .sse import EventBroadcaster


@dataclass
class ServingConfig:
    cache_enabled: bool = True
    cache_max_entries: int = 512
    sse_max_subscribers: int = 64
    sse_buffer: int = 256
    # admission thresholds (the processor's backpressure signals)
    queue_wait_p95_threshold_s: float = 0.5
    slot_delay_p95_threshold_s: float = 4.0
    pending_limit: int = 0  # 0 = pending-depth signal disabled
    read_only_factor: float = 2.0
    retry_after_s: int = 1


class ServingTier:
    def __init__(
        self,
        chain=None,
        config: ServingConfig | None = None,
        health_source=None,
        processor=None,
    ):
        self.config = config or ServingConfig()
        self.cache = ResponseCache(self.config.cache_max_entries)
        self.broadcaster = EventBroadcaster(
            self.config.sse_max_subscribers, self.config.sse_buffer
        )
        self.admission = AdmissionController(
            self.config, health_source=health_source, processor=processor
        )
        self.chain = None
        if chain is not None:
            self.attach(chain)

    def attach(self, chain) -> "ServingTier":
        self.chain = chain
        chain.event_sinks.append(self._on_event)
        return self

    def _on_event(self, kind: str, payload) -> None:
        # invalidate BEFORE fan-out: a subscriber reacting to the event
        # with a GET must not race a stale cached body
        if kind == "head":
            self.cache.invalidate(HEAD, (payload or {}).get("block"))
        elif kind == "finalized_checkpoint":
            self.cache.invalidate(
                FINALIZED, int((payload or {}).get("epoch", -1))
            )
        self.broadcaster.publish(kind, payload)

    def anchor_for(self, kind: str):
        """The current anchor value for an anchor kind, or None when it
        cannot be resolved (no chain attached)."""
        if kind == IMMUTABLE:
            return "static"
        if self.chain is None:
            return None
        if kind == FINALIZED:
            return int(self.chain.finalized_checkpoint[0])
        if kind == HEAD:
            return "0x" + bytes(self.chain.head_root).hex()
        return None

    def close(self) -> None:
        self.broadcaster.close()

    def stats(self) -> dict:
        return {
            "cache": self.cache.stats(),
            "sse": self.broadcaster.stats(),
            "admission": self.admission.stats(),
        }

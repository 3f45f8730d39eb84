"""Serving tier between the HTTP adapter and the BeaconApi handlers:
finality/head-anchored response caching with ETag revalidation, bounded
live SSE fan-out, and lane-aware load-shedding admission control.

The port's copy of lighthouse_tpu/serving/__init__.py.
"""

from .admission import (
    DEBUG,
    READ_ONLY,
    VALIDATOR,
    AdmissionController,
    MetricsHealthSource,
    classify_lane,
)
from .cache import (
    FINALIZED,
    HEAD,
    IMMUTABLE,
    ResponseCache,
    classify_anchor,
    make_etag,
)
from .sse import EventBroadcaster, EventRing, Subscriber
from .tier import ServingConfig, ServingTier

__all__ = [
    "DEBUG",
    "READ_ONLY",
    "VALIDATOR",
    "FINALIZED",
    "HEAD",
    "IMMUTABLE",
    "AdmissionController",
    "MetricsHealthSource",
    "classify_lane",
    "ResponseCache",
    "classify_anchor",
    "make_etag",
    "EventBroadcaster",
    "EventRing",
    "Subscriber",
    "ServingConfig",
    "ServingTier",
]

"""Pools & dedup caches (reference beacon_node/operation_pool +
beacon_chain's observed_* caches, SURVEY.md section 2.3): the port has the
observed-gossip dedup caches so far; the operation and naive-aggregation
pools wait (ROADMAP Queue 1 item 14.6)."""

from .observed import (  # noqa: F401
    ObservedAggregates,
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
    ObservedOperations,
)

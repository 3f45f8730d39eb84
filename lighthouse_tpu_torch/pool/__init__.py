"""Pools & dedup caches (reference beacon_node/operation_pool +
beacon_chain's naive_aggregation_pool and observed_* caches, SURVEY.md
sections 2.3): the port's copy of lighthouse_tpu/pool."""

from .max_cover import max_cover  # noqa: F401
from .naive_aggregation import NaiveAggregationPool  # noqa: F401
from .observed import (  # noqa: F401
    ObservedAggregates,
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
    ObservedOperations,
)
from .operation_pool import OperationPool  # noqa: F401

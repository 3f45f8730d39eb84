"""Work scheduling (reference beacon_node/network/src/beacon_processor):
prioritized bounded queues forming device-sized verification batches."""

from .beacon_processor import (  # noqa: F401
    BeaconProcessor,
    DeferredWork,
    WorkQueue,
)

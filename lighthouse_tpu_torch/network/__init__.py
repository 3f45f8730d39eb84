"""Networking (reference beacon_node/lighthouse_network +
beacon_node/network, SURVEY.md section 2.3): gossip topics, req/resp
protocols, router, sync, peer scoring -- over either transport: the
in-process message bus (simulator-style multi-node) or the TCP wire
stack (wire.py: ssz_snappy framing, bootnode discovery, flood gossip
with seen-cache relay) behind the same API.

The port's copy of lighthouse_tpu/network, whole. Every signature a node
checks on its data path (gossip blocks, attestation and sync batches,
slashings, exits, range-sync segments) goes through the port's
verifier, on the card under torch_cuda. The control plane's checks (the
ENR signature, the secure handshake's transcript, the bootnode's
registration proof) stay pinned to the port's cpu oracle, as the JAX
package pins them to its own."""

from .message_bus import GossipMessage, MessageBus, topic_name  # noqa: F401
from .node import (  # noqa: F401
    BLOCKS_BY_RANGE,
    BLOCKS_BY_ROOT,
    STATUS_PROTOCOL,
    NetworkNode,
)
from .simulator import Simulator  # noqa: F401
from .sync import SyncManager  # noqa: F401
from .wire import Bootnode, WireBus, WireCodec  # noqa: F401

"""Eth1 interface (reference beacon_node/eth1, SURVEY.md section 2.3):
deposit tree/cache, block cache, eth1-data voting, JSON-RPC provider +
in-process RPC server test rig, mock provider.

The port's copy of lighthouse_tpu/eth1/__init__.py."""

from .deposit_tree import DEPOSIT_TREE_DEPTH, DepositDataTree  # noqa: F401
from .jsonrpc import (  # noqa: F401
    Eth1RpcServer,
    JsonRpcEth1Provider,
    decode_deposit_log_data,
    encode_deposit_log_data,
)
from .service import (  # noqa: F401
    Eth1Block,
    Eth1ProviderError,
    Eth1Service,
    FallbackEth1Provider,
    MockEth1Provider,
    NoEth1ProviderAvailable,
)

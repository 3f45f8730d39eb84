"""Execution-layer interface: engine API types, the ExecutionLayer facade,
the JWT-authenticated HTTP transport, payload block-hash verification, and
the in-process mock engine (reference beacon_node/execution_layer).

The port's copy of lighthouse_tpu/execution_layer/__init__.py."""

from .auth import JwtError, JwtKey, generate_token, validate_token
from .builder import (
    BuilderError,
    BuilderHttpClient,
    BuilderHttpServer,
    MockBuilder,
    NoBidAvailable,
    make_validator_registration,
    unblind_signed_block,
    verify_bid,
)
from .block_hash import (
    calculate_execution_block_hash,
    calculate_transactions_root,
    verify_payload_block_hash,
)
from .engine_api import (
    EngineApiError,
    ExecutionEngine,
    ForkchoiceState,
    ForkchoiceUpdatedResponse,
    PayloadAttributes,
    PayloadStatusV1,
    PayloadStatusV1Status,
)
from .execution_layer import (
    ExecutionLayer,
    PayloadInvalid,
    PayloadVerificationStatus,
)
from .http_engine import EngineRpcServer, HttpJsonRpcEngine
from .mock_engine import MockExecutionEngine

__all__ = [
    "BuilderError",
    "BuilderHttpClient",
    "BuilderHttpServer",
    "EngineApiError",
    "EngineRpcServer",
    "MockBuilder",
    "NoBidAvailable",
    "make_validator_registration",
    "unblind_signed_block",
    "verify_bid",
    "ExecutionEngine",
    "ExecutionLayer",
    "ForkchoiceState",
    "ForkchoiceUpdatedResponse",
    "HttpJsonRpcEngine",
    "JwtError",
    "JwtKey",
    "MockExecutionEngine",
    "PayloadAttributes",
    "PayloadInvalid",
    "PayloadStatusV1",
    "PayloadStatusV1Status",
    "PayloadVerificationStatus",
    "calculate_execution_block_hash",
    "calculate_transactions_root",
    "generate_token",
    "validate_token",
    "verify_payload_block_hash",
]

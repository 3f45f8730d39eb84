"""Engine-API surface (reference beacon_node/execution_layer/src/
engine_api/mod.rs + json_structures.rs): the verb set a consensus client
speaks to an execution engine, with payload-status semantics from
engine_api/payload_status.rs.

The transport here is an in-process call interface; the wire JSON-RPC
framing lives in `http_jsonrpc.py` style adapters (and the test double,
MockExecutionEngine, implements the same protocol the way the reference's
mock server does, execution_layer/src/test_utils/mock_execution_layer.rs).

The port's copy of lighthouse_tpu/execution_layer/engine_api.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class PayloadStatusV1Status(str, enum.Enum):
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"
    INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"


@dataclass
class PayloadStatusV1:
    status: PayloadStatusV1Status
    latest_valid_hash: bytes | None = None
    validation_error: str | None = None


@dataclass
class ForkchoiceState:
    head_block_hash: bytes = b"\x00" * 32
    safe_block_hash: bytes = b"\x00" * 32
    finalized_block_hash: bytes = b"\x00" * 32


@dataclass
class PayloadAttributes:
    timestamp: int = 0
    prev_randao: bytes = b"\x00" * 32
    suggested_fee_recipient: bytes = b"\x00" * 20


@dataclass
class ForkchoiceUpdatedResponse:
    payload_status: PayloadStatusV1
    payload_id: bytes | None = None


class EngineApiError(RuntimeError):
    pass


class ExecutionEngine:
    """Protocol: what an engine implementation must provide."""

    def new_payload(self, payload) -> PayloadStatusV1:  # engine_newPayloadV1
        raise NotImplementedError

    def forkchoice_updated(
        self,
        state: ForkchoiceState,
        attributes: PayloadAttributes | None = None,
    ) -> ForkchoiceUpdatedResponse:  # engine_forkchoiceUpdatedV1
        raise NotImplementedError

    def get_payload(self, payload_id: bytes):  # engine_getPayloadV1
        raise NotImplementedError

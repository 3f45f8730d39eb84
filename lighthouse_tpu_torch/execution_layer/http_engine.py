"""Engine-API JSON-RPC over HTTP with JWT auth (reference
execution_layer/src/engine_api/http.rs + auth.rs): the transport between
the beacon node and its execution engine.

Mirrors the eth1 boundary's client/rig split (eth1/jsonrpc.py): a real
HTTP client speaking the engine dialect, and an in-process
`EngineRpcServer` that fronts any in-process `ExecutionEngine` (usually
the fault-injecting mock) behind an actual socket with real JWT
validation — so transport, auth, serialization, and retry paths are all
exercised without an external geth.

Wire encoding follows engine_api/json_structures.rs: QUANTITY fields are
minimal 0x-hex strings, DATA fields 0x-prefixed even-length hex.

The port's copy of lighthouse_tpu/execution_layer/http_engine.py.
"""

from __future__ import annotations

from ..utils.jsonrpc import JsonRpcClient, JsonRpcHttpServer
from .auth import JwtError, JwtKey, generate_token, validate_token
from .engine_api import (
    EngineApiError,
    ExecutionEngine,
    ForkchoiceState,
    ForkchoiceUpdatedResponse,
    PayloadAttributes,
    PayloadStatusV1,
    PayloadStatusV1Status,
)


def _q(n: int) -> str:  # QUANTITY
    return hex(int(n))


def _d(b: bytes) -> str:  # DATA
    return "0x" + bytes(b).hex()


def _un_q(s: str) -> int:
    return int(s, 16)


def _un_d(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def payload_to_json(payload) -> dict:
    return {
        "parentHash": _d(payload.parent_hash),
        "feeRecipient": _d(payload.fee_recipient),
        "stateRoot": _d(payload.state_root),
        "receiptsRoot": _d(payload.receipts_root),
        "logsBloom": _d(payload.logs_bloom),
        "prevRandao": _d(payload.prev_randao),
        "blockNumber": _q(payload.block_number),
        "gasLimit": _q(payload.gas_limit),
        "gasUsed": _q(payload.gas_used),
        "timestamp": _q(payload.timestamp),
        "extraData": _d(payload.extra_data),
        "baseFeePerGas": _q(payload.base_fee_per_gas),
        "blockHash": _d(payload.block_hash),
        "transactions": [_d(tx) for tx in payload.transactions],
    }


def payload_from_json(obj: dict, payload_cls):
    return payload_cls(
        parent_hash=_un_d(obj["parentHash"]),
        fee_recipient=_un_d(obj["feeRecipient"]),
        state_root=_un_d(obj["stateRoot"]),
        receipts_root=_un_d(obj["receiptsRoot"]),
        logs_bloom=_un_d(obj["logsBloom"]),
        prev_randao=_un_d(obj["prevRandao"]),
        block_number=_un_q(obj["blockNumber"]),
        gas_limit=_un_q(obj["gasLimit"]),
        gas_used=_un_q(obj["gasUsed"]),
        timestamp=_un_q(obj["timestamp"]),
        extra_data=_un_d(obj["extraData"]),
        base_fee_per_gas=_un_q(obj["baseFeePerGas"]),
        block_hash=_un_d(obj["blockHash"]),
        transactions=[_un_d(tx) for tx in obj["transactions"]],
    )


def _status_to_json(status: PayloadStatusV1) -> dict:
    return {
        "status": status.status.value,
        "latestValidHash": (
            _d(status.latest_valid_hash)
            if status.latest_valid_hash is not None
            else None
        ),
        "validationError": status.validation_error,
    }


def _status_from_json(obj: dict) -> PayloadStatusV1:
    lvh = obj.get("latestValidHash")
    return PayloadStatusV1(
        status=PayloadStatusV1Status(obj["status"]),
        latest_valid_hash=_un_d(lvh) if lvh else None,
        validation_error=obj.get("validationError"),
    )


class HttpJsonRpcEngine(ExecutionEngine):
    """The beacon node's engine handle over a real socket (http.rs
    HttpJsonRpc): JWT header per request, bounded retries on transport
    errors, JSON-RPC error surfacing as EngineApiError."""

    def __init__(
        self,
        url: str,
        jwt_key: JwtKey,
        payload_cls,
        retries: int = 3,
        backoff_s: float = 0.05,
        timeout_s: float = 5.0,
    ):
        self.url = url
        self.jwt_key = jwt_key
        self.payload_cls = payload_cls
        self._rpc = JsonRpcClient(
            url,
            error_cls=EngineApiError,
            # fresh token each attempt: the iat window is short
            headers_fn=lambda: {
                "Authorization": f"Bearer {generate_token(self.jwt_key)}"
            },
            retries=retries,
            backoff_s=backoff_s,
            timeout_s=timeout_s,
        )

    def _call(self, method: str, params: list):
        return self._rpc.call(method, params)

    # -- ExecutionEngine protocol -------------------------------------------

    def new_payload(self, payload) -> PayloadStatusV1:
        result = self._call("engine_newPayloadV1", [payload_to_json(payload)])
        return _status_from_json(result)

    def forkchoice_updated(
        self,
        state: ForkchoiceState,
        attributes: PayloadAttributes | None = None,
    ) -> ForkchoiceUpdatedResponse:
        fc = {
            "headBlockHash": _d(state.head_block_hash),
            "safeBlockHash": _d(state.safe_block_hash),
            "finalizedBlockHash": _d(state.finalized_block_hash),
        }
        attrs = None
        if attributes is not None:
            attrs = {
                "timestamp": _q(attributes.timestamp),
                "prevRandao": _d(attributes.prev_randao),
                "suggestedFeeRecipient": _d(attributes.suggested_fee_recipient),
            }
        result = self._call("engine_forkchoiceUpdatedV1", [fc, attrs])
        pid = result.get("payloadId")
        return ForkchoiceUpdatedResponse(
            payload_status=_status_from_json(result["payloadStatus"]),
            payload_id=_un_d(pid) if pid else None,
        )

    def get_payload(self, payload_id: bytes):
        result = self._call("engine_getPayloadV1", [_d(payload_id)])
        return payload_from_json(result, self.payload_cls)


class EngineRpcServer:
    """An in-process engine behind a real authenticated socket (the
    reference's test_utils/mock_execution_layer.rs seat, with auth.rs
    validation live). `fail_next` injects transient 503s; `reject_auth`
    forces 401s to exercise the client's error surface."""

    def __init__(self, engine, jwt_key: JwtKey, host="127.0.0.1", port=0):
        self.engine = engine
        self.jwt_key = jwt_key
        self.reject_auth = False

        def check_auth(header: str) -> bool:
            if self.reject_auth or not header.startswith("Bearer "):
                return False
            try:
                validate_token(self.jwt_key, header[len("Bearer ") :])
                return True
            except JwtError:
                return False

        self._http = JsonRpcHttpServer(
            self._dispatch, host=host, port=port, auth_fn=check_auth
        )
        self.url = self._http.url

    @property
    def fail_next(self) -> int:
        return self._http.fail_next

    @fail_next.setter
    def fail_next(self, n: int) -> None:
        self._http.fail_next = n

    @property
    def requests_seen(self) -> int:
        return self._http.requests_seen

    def start(self):
        self._http.start()
        return self

    def stop(self):
        self._http.stop()

    def _dispatch(self, method: str, params: list):
        if method == "engine_newPayloadV1":
            payload = payload_from_json(params[0], self.engine.payload_cls)
            return _status_to_json(self.engine.new_payload(payload))
        if method == "engine_forkchoiceUpdatedV1":
            fc_json, attrs_json = params[0], params[1]
            state = ForkchoiceState(
                head_block_hash=_un_d(fc_json["headBlockHash"]),
                safe_block_hash=_un_d(fc_json["safeBlockHash"]),
                finalized_block_hash=_un_d(fc_json["finalizedBlockHash"]),
            )
            attrs = None
            if attrs_json is not None:
                attrs = PayloadAttributes(
                    timestamp=_un_q(attrs_json["timestamp"]),
                    prev_randao=_un_d(attrs_json["prevRandao"]),
                    suggested_fee_recipient=_un_d(
                        attrs_json["suggestedFeeRecipient"]
                    ),
                )
            resp = self.engine.forkchoice_updated(state, attrs)
            return {
                "payloadStatus": _status_to_json(resp.payload_status),
                "payloadId": _d(resp.payload_id) if resp.payload_id else None,
            }
        if method == "engine_getPayloadV1":
            payload = self.engine.get_payload(_un_d(params[0]))
            return payload_to_json(payload)
        raise ValueError(f"unknown method {method}")

"""Eth1 JSON-RPC boundary (reference beacon_node/eth1/src/service.rs +
http.rs): a provider that polls a real execution node's JSON-RPC —
`eth_blockNumber` / `eth_getBlockByNumber` / `eth_getLogs` — decoding
DepositEvent logs from their ABI encoding, with bounded retries and
parent-hash linkage so reorgs rewind the caller's caches.

The in-process `Eth1RpcServer` plays the reference's eth1 test rig
(testing/eth1_test_rig): a real HTTP server speaking the same JSON-RPC
dialect over a scriptable chain, so the service-side tests exercise
serialization, retry, and reorg handling over an actual socket.

The port's copy of lighthouse_tpu/eth1/jsonrpc.py.
"""

from __future__ import annotations

from ..types.containers import DepositData
from ..utils.jsonrpc import JsonRpcClient, JsonRpcHttpServer
from .service import Eth1Block, Eth1ProviderError

DEPOSIT_CONTRACT_ADDRESS = "0x" + "12" * 20
# keccak("DepositEvent(bytes,bytes,bytes,bytes,bytes)") — fixed topic of the
# deposit contract's single event (common/deposit_contract in the reference)
DEPOSIT_EVENT_TOPIC = (
    "0x649bbc62d0e31342afea4e5cd82d4049e7e1ee912fc0889aa790803be39038c5"
)


# -- DepositEvent ABI ---------------------------------------------------------
# The real contract emits five dynamic `bytes` params (pubkey, withdrawal
# credentials, amount as 8-byte LE, signature, index as 8-byte LE). ABI
# layout: 5 head words of offsets, then per-param length word + padded data
# (eth1/src/http.rs log-parsing counterpart).


def _abi_pad(data: bytes) -> bytes:
    return data + bytes((-len(data)) % 32)


def encode_deposit_log_data(deposit_data: DepositData, index: int) -> bytes:
    params = [
        bytes(deposit_data.pubkey),
        bytes(deposit_data.withdrawal_credentials),
        int(deposit_data.amount).to_bytes(8, "little"),
        bytes(deposit_data.signature),
        index.to_bytes(8, "little"),
    ]
    head = b""
    tail = b""
    offset = 32 * len(params)
    for p in params:
        head += offset.to_bytes(32, "big")
        chunk = len(p).to_bytes(32, "big") + _abi_pad(p)
        tail += chunk
        offset += len(chunk)
    return head + tail


def decode_deposit_log_data(data: bytes) -> tuple[DepositData, int]:
    if len(data) < 32 * 5:
        raise ValueError("deposit log data too short")
    params = []
    for i in range(5):
        off = int.from_bytes(data[32 * i : 32 * (i + 1)], "big")
        if off + 32 > len(data):
            raise ValueError("deposit log offset out of range")
        n = int.from_bytes(data[off : off + 32], "big")
        if off + 32 + n > len(data):
            raise ValueError("deposit log param out of range")
        params.append(data[off + 32 : off + 32 + n])
    pubkey, wc, amount, sig, index = params
    dd = DepositData(
        pubkey=pubkey,
        withdrawal_credentials=wc,
        amount=int.from_bytes(amount, "little"),
        signature=sig,
    )
    return dd, int.from_bytes(index, "little")


# -- client provider ----------------------------------------------------------


class Eth1RpcError(Eth1ProviderError):
    """RPC/transport failure after the client's own bounded retries --
    the transient shape FallbackEth1Provider fails over on."""


class JsonRpcEth1Provider:
    """Deposit-log/block provider over eth1 JSON-RPC (service.rs's
    HttpJsonRpc seat). Bounded retries with backoff on transport errors."""

    def __init__(
        self,
        url: str,
        deposit_contract: str = DEPOSIT_CONTRACT_ADDRESS,
        retries: int = 3,
        backoff_s: float = 0.05,
        timeout_s: float = 5.0,
    ):
        self.url = url
        self.deposit_contract = deposit_contract
        self._rpc = JsonRpcClient(
            url,
            error_cls=Eth1RpcError,
            retries=retries,
            backoff_s=backoff_s,
            timeout_s=timeout_s,
        )
        # incremental log scan state (service.rs keeps the same watermark)
        self._scanned_to = -1
        self._logs: list = []  # (DepositData, index, block_number), by index

    def _call(self, method: str, params: list):
        return self._rpc.call(method, params)

    # -- Eth1Service provider interface (service.py duck type) ---------------

    def head_number(self) -> int:
        return int(self._call("eth_blockNumber", []), 16)

    def get_block(self, number: int) -> Eth1Block | None:
        raw = self._call("eth_getBlockByNumber", [hex(number), False])
        if raw is None:
            return None
        return Eth1Block(
            number=int(raw["number"], 16),
            hash=bytes.fromhex(raw["hash"][2:]),
            parent_hash=bytes.fromhex(raw["parentHash"][2:]),
            timestamp=int(raw["timestamp"], 16),
            deposit_count=int(raw.get("depositCount", "0x0"), 16),
        )

    def get_deposit_logs(self, from_index: int) -> list:
        """DepositData in log order from `from_index` on, via an
        incremental block-range scan (only blocks past the watermark are
        fetched each poll). The caller's reorg rewind calls
        `reset_log_scan()` first, forcing a full rescan — a reorg can
        replace same-numbered blocks whose logs an incremental scan would
        never revisit."""
        head = self.head_number()
        if head < self._scanned_to:
            self.reset_log_scan()  # chain shrank under us
        if head > self._scanned_to:
            self._logs.extend(
                self.get_deposit_logs_range(self._scanned_to + 1, head)
            )
            self._scanned_to = head
        return [dd for dd, index, _ in self._logs if index >= from_index]

    def reset_log_scan(self) -> None:
        self._scanned_to = -1
        self._logs = []

    # -- raw range query -----------------------------------------------------

    def get_deposit_logs_range(self, from_block: int, to_block: int) -> list:
        """Decoded (DepositData, index, block_number) triples in the range."""
        raw = self._call(
            "eth_getLogs",
            [
                {
                    "address": self.deposit_contract,
                    "topics": [DEPOSIT_EVENT_TOPIC],
                    "fromBlock": hex(from_block),
                    "toBlock": hex(to_block),
                }
            ],
        )
        out = []
        for log in raw:
            dd, index = decode_deposit_log_data(bytes.fromhex(log["data"][2:]))
            out.append((dd, index, int(log["blockNumber"], 16)))
        out.sort(key=lambda t: t[1])
        return out


# -- in-process server test double -------------------------------------------


class Eth1RpcServer:
    """HTTP JSON-RPC front for a `MockEth1Provider` chain (the reference's
    eth1_test_rig seat). `fail_next` injects transient 503s to exercise the
    client's retry path."""

    def __init__(self, chain, host: str = "127.0.0.1", port: int = 0):
        self.chain = chain
        self._http = JsonRpcHttpServer(self._dispatch, host=host, port=port)
        self.url = self._http.url

    @property
    def fail_next(self) -> int:
        return self._http.fail_next

    @fail_next.setter
    def fail_next(self, n: int) -> None:
        self._http.fail_next = n

    def start(self):
        self._http.start()
        return self

    def stop(self):
        self._http.stop()

    def _dispatch(self, method: str, params: list):
        chain = self.chain
        if method == "eth_blockNumber":
            return hex(len(chain.blocks) - 1) if chain.blocks else "0x0"
        if method == "eth_getBlockByNumber":
            number = int(params[0], 16)
            if number >= len(chain.blocks):
                return None
            blk = chain.blocks[number]
            return {
                "number": hex(blk.number),
                "hash": "0x" + blk.hash.hex(),
                "parentHash": "0x" + blk.parent_hash.hex(),
                "timestamp": hex(blk.timestamp),
                "depositCount": hex(blk.deposit_count),
            }
        if method == "eth_getLogs":
            flt = params[0]
            lo = int(flt["fromBlock"], 16)
            hi = int(flt["toBlock"], 16)
            if flt.get("address") != DEPOSIT_CONTRACT_ADDRESS:
                return []
            return [
                {
                    "data": "0x" + encode_deposit_log_data(dd, index).hex(),
                    "blockNumber": hex(bn),
                    "topics": [DEPOSIT_EVENT_TOPIC],
                    "address": DEPOSIT_CONTRACT_ADDRESS,
                }
                for index, (dd, bn) in enumerate(chain.deposit_logs)
                if lo <= bn <= hi
            ]
        raise ValueError(f"unknown method {method}")

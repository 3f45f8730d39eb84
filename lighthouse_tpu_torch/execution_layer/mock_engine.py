"""In-process mock execution engine + execution block generator
(reference execution_layer/src/test_utils/{mock_execution_layer.rs,
execution_block_generator.rs}): a fake EL chain that makes full block
production/import testable without an external process.

Supports fault injection the way the reference's payload-invalidation
tests do (beacon_chain/tests/payload_invalidation.rs): specific block
hashes can be pre-marked INVALID (or the next N new_payload calls forced
SYNCING), so optimistic-import and invalidation paths are exercisable.

The port's copy of lighthouse_tpu/execution_layer/mock_engine.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from .engine_api import (
    EngineApiError,
    ExecutionEngine,
    ForkchoiceState,
    ForkchoiceUpdatedResponse,
    PayloadAttributes,
    PayloadStatusV1,
    PayloadStatusV1Status,
)


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


@dataclass
class MockBlock:
    block_hash: bytes
    parent_hash: bytes
    block_number: int
    timestamp: int
    prev_randao: bytes


class MockExecutionEngine(ExecutionEngine):
    def __init__(self, types, terminal_block_hash: bytes | None = None):
        self.t = types
        genesis_hash = _hash(b"mock-el-genesis")
        self.blocks: dict[bytes, MockBlock] = {
            genesis_hash: MockBlock(genesis_hash, b"\x00" * 32, 0, 0, b"\x00" * 32)
        }
        self.genesis_hash = genesis_hash
        self.head_hash = genesis_hash
        self.finalized_hash = b"\x00" * 32
        self._payloads: dict[bytes, object] = {}
        self._next_payload_id = 1
        # fault injection
        self.invalid_hashes: set[bytes] = set()
        self.force_syncing: int = 0
        self.new_payload_log: list[bytes] = []
        # pow (pre-merge) chain: block_hash -> (parent_hash,
        # total_difficulty), the eth_getBlockByHash surface merge-block
        # TTD validation reads (reference engines.rs get_pow_block)
        self.pow_blocks: dict[bytes, tuple[bytes, int]] = {}

    # -- fault injection hooks ----------------------------------------------

    def mark_invalid(self, block_hash: bytes) -> None:
        self.invalid_hashes.add(bytes(block_hash))

    def add_pow_block(
        self, block_hash: bytes, parent_hash: bytes, total_difficulty: int
    ) -> None:
        self.pow_blocks[bytes(block_hash)] = (
            bytes(parent_hash),
            int(total_difficulty),
        )

    def get_pow_block(self, block_hash: bytes):
        """(parent_hash, total_difficulty) or None if unknown."""
        return self.pow_blocks.get(bytes(block_hash))

    # -- engine API ----------------------------------------------------------

    def new_payload(self, payload) -> PayloadStatusV1:
        self.new_payload_log.append(bytes(payload.block_hash))
        if self.force_syncing > 0:
            self.force_syncing -= 1
            return PayloadStatusV1(PayloadStatusV1Status.SYNCING)
        block_hash = bytes(payload.block_hash)
        parent = bytes(payload.parent_hash)
        if block_hash in self.invalid_hashes:
            return PayloadStatusV1(
                PayloadStatusV1Status.INVALID,
                latest_valid_hash=self._latest_valid(parent),
                validation_error="injected invalid payload",
            )
        want = self.compute_block_hash(payload)
        if want != block_hash:
            return PayloadStatusV1(
                PayloadStatusV1Status.INVALID_BLOCK_HASH,
                validation_error="block hash mismatch",
            )
        if parent not in self.blocks:
            return PayloadStatusV1(PayloadStatusV1Status.SYNCING)
        self.blocks[block_hash] = MockBlock(
            block_hash,
            parent,
            int(payload.block_number),
            int(payload.timestamp),
            bytes(payload.prev_randao),
        )
        return PayloadStatusV1(
            PayloadStatusV1Status.VALID, latest_valid_hash=block_hash
        )

    def forkchoice_updated(
        self,
        state: ForkchoiceState,
        attributes: PayloadAttributes | None = None,
    ) -> ForkchoiceUpdatedResponse:
        head = bytes(state.head_block_hash)
        if head in self.invalid_hashes:
            return ForkchoiceUpdatedResponse(
                PayloadStatusV1(
                    PayloadStatusV1Status.INVALID,
                    latest_valid_hash=self.genesis_hash,
                )
            )
        syncing = head != b"\x00" * 32 and head not in self.blocks
        if not syncing:
            self.head_hash = head
            self.finalized_hash = bytes(state.finalized_block_hash)
        payload_id = None
        if attributes is not None:
            # Mock leniency: build even on an unknown (optimistically
            # imported) head so production on optimistic chains is testable
            # -- a real engine would return SYNCING with a null payloadId.
            payload_id = self._next_payload_id.to_bytes(8, "big")
            self._next_payload_id += 1
            self._payloads[payload_id] = self._build_payload(head, attributes)
        status = (
            PayloadStatusV1Status.SYNCING
            if syncing
            else PayloadStatusV1Status.VALID
        )
        return ForkchoiceUpdatedResponse(
            PayloadStatusV1(
                status, latest_valid_hash=None if syncing else (head or None)
            ),
            payload_id,
        )

    def get_payload(self, payload_id: bytes):
        payload = self._payloads.get(bytes(payload_id))
        if payload is None:
            raise EngineApiError(f"unknown payload id {payload_id.hex()}")
        return payload

    # -- internals -----------------------------------------------------------

    @property
    def payload_cls(self):
        return self.t.ExecutionPayload

    def compute_block_hash(self, payload) -> bytes:
        """REAL keccak-over-RLP-header hash (block_hash.rs), exactly what
        the beacon node's verify_payload_block_hash recomputes -- the mock
        chain is indistinguishable from a hash-honest engine (the
        reference's execution_block_generator does the same)."""
        from .block_hash import calculate_execution_block_hash

        return calculate_execution_block_hash(payload)

    def _build_payload(self, parent_hash: bytes, attrs: PayloadAttributes):
        parent = self.blocks.get(parent_hash)
        number = (parent.block_number + 1) if parent else 1
        p = self.t.ExecutionPayload(
            parent_hash=parent_hash,
            fee_recipient=attrs.suggested_fee_recipient,
            prev_randao=attrs.prev_randao,
            block_number=number,
            gas_limit=30_000_000,
            gas_used=21_000,
            timestamp=attrs.timestamp,
            base_fee_per_gas=7,
        )
        p.block_hash = self.compute_block_hash(p)
        return p

    def _latest_valid(self, parent: bytes) -> bytes:
        h = parent
        while h in self.invalid_hashes:
            blk = self.blocks.get(h)
            if blk is None:
                return self.genesis_hash
            h = blk.parent_hash
        return h if h in self.blocks or h == b"\x00" * 32 else self.genesis_hash

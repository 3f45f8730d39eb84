"""Execution-payload block-hash verification (reference
execution_layer/src/block_hash.rs + consensus/types/src/
execution_block_header.rs): re-derive keccak256(rlp(execution header))
from the payload a proposer shipped and compare it to the claimed
block_hash — the check that stops a lying execution engine or proposer
from smuggling a mislabeled payload through optimistic import.

The bellatrix execution header is the pre-withdrawals 15-field layout:
transactions_root is the ordered MPT root over the raw transaction bytes
(block_hash.rs calculate_transactions_root), ommers_hash is the constant
keccak(rlp([])), difficulty 0 and an all-zero 8-byte nonce post-merge.

The port's copy of lighthouse_tpu/execution_layer/block_hash.py.
"""

from __future__ import annotations

from .keccak import keccak256
from .rlp import encode_bytes, encode_int, encode_list, ordered_trie_root

# keccak256(rlp([])): ommers hash of every post-merge block
EMPTY_OMMERS_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
)
POST_MERGE_NONCE = b"\x00" * 8


def calculate_transactions_root(transactions) -> bytes:
    return ordered_trie_root([bytes(tx) for tx in transactions])


def calculate_execution_block_hash(payload) -> bytes:
    """keccak256 of the RLP execution header reconstructed from an
    ExecutionPayload (block_hash.rs calculate_execution_block_hash)."""
    fields = [
        encode_bytes(bytes(payload.parent_hash)),
        encode_bytes(EMPTY_OMMERS_HASH),
        encode_bytes(bytes(payload.fee_recipient)),
        encode_bytes(bytes(payload.state_root)),
        encode_bytes(calculate_transactions_root(payload.transactions)),
        encode_bytes(bytes(payload.receipts_root)),
        encode_bytes(bytes(payload.logs_bloom)),
        encode_int(0),  # difficulty: always 0 post-merge
        encode_int(int(payload.block_number)),
        encode_int(int(payload.gas_limit)),
        encode_int(int(payload.gas_used)),
        encode_int(int(payload.timestamp)),
        encode_bytes(bytes(payload.extra_data)),
        encode_bytes(bytes(payload.prev_randao)),  # mix_hash seat
        encode_bytes(POST_MERGE_NONCE),
        encode_int(int(payload.base_fee_per_gas)),
    ]
    return keccak256(encode_list(fields))


def verify_payload_block_hash(payload) -> None:
    """Raise ValueError on mismatch (the reference converts this into a
    block-verification failure before any engine round trip)."""
    computed = calculate_execution_block_hash(payload)
    claimed = bytes(payload.block_hash)
    if computed != claimed:
        raise ValueError(
            f"payload block_hash mismatch: claimed {claimed.hex()[:16]}, "
            f"header hashes to {computed.hex()[:16]}"
        )

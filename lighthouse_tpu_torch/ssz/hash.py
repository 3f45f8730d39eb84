"""SSZ merkleization primitives (reference: consensus/tree_hash +
crypto/eth2_hashing).

SHA-256 comes from hashlib (OpenSSL's assembly paths -- the same class of
backend the reference selects at runtime in eth2_hashing/src/lib.rs:1-28).
The zero-subtree cache mirrors eth2_hashing's zero-hash feature. Host-side
by design: Merkleization of consensus objects is latency-sensitive small
work. The port's copy of lighthouse_tpu/ssz/hash.py.
"""

from __future__ import annotations

import hashlib

BYTES_PER_CHUNK = 32
ZERO_CHUNK = bytes(BYTES_PER_CHUNK)

MAX_TREE_DEPTH = 64

# ZERO_HASHES[i] = root of a depth-i tree of zero chunks
ZERO_HASHES: list[bytes] = [ZERO_CHUNK]
for _ in range(MAX_TREE_DEPTH):
    ZERO_HASHES.append(
        hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest()
    )


def hash_concat(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def merkleize(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Root of the padded Merkle tree over 32-byte chunks.

    `limit` (chunk capacity) fixes the tree depth for list types; None
    means pad to the next power of two of len(chunks)."""
    count = len(chunks)
    if limit is not None and count > limit:
        raise ValueError(f"too many chunks: {count} > {limit}")
    width = _next_pow2(limit if limit is not None else max(count, 1))
    depth = width.bit_length() - 1

    layer = list(chunks)
    for d in range(depth):
        if len(layer) % 2 == 1:
            layer.append(ZERO_HASHES[d])
        layer = [
            hash_concat(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)
        ]
        if not layer:
            layer = []
    if not layer:
        return ZERO_HASHES[depth]
    return layer[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_concat(root, length.to_bytes(32, "little"))


def pack_bytes(data: bytes) -> list[bytes]:
    """Right-pad to a whole number of 32-byte chunks."""
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + bytes(pad)
    return [
        data[i : i + BYTES_PER_CHUNK]
        for i in range(0, len(data), BYTES_PER_CHUNK)
    ]

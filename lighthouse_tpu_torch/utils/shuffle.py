"""Swap-or-not committee shuffle (spec SHUFFLE_ROUND_COUNT = 90).

Equivalent of the reference's consensus/swap_or_not_shuffle crate:
`compute_shuffled_index` (single-index, compute_shuffled_index.rs:21) and
the whole-list fast path (shuffle_list.rs:79). The list path is vectorized
with numpy -- per round, ONE set of pivot/source hashes is computed and the
swap decisions for every index are applied as array ops, the same
round-level data-parallelism the reference gets by precomputing the round's
"pivots" buffer.
"""

from __future__ import annotations

import hashlib

import numpy as np

SHUFFLE_ROUND_COUNT = 90


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_shuffled_index(
    index: int, list_size: int, seed: bytes, rounds: int = SHUFFLE_ROUND_COUNT
) -> int:
    """Forward-shuffled position of one index (spec algorithm)."""
    if not 0 <= index < list_size:
        raise ValueError("index out of range")
    for r in range(rounds):
        pivot = (
            int.from_bytes(_hash(seed + bytes([r]))[:8], "little") % list_size
        )
        flip = (pivot + list_size - index) % list_size
        position = max(index, flip)
        source = _hash(
            seed + bytes([r]) + (position // 256).to_bytes(4, "little")
        )
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def shuffle_list(
    input_list,
    seed: bytes,
    forwards: bool = False,
    rounds: int = SHUFFLE_ROUND_COUNT,
) -> list:
    """Whole-list shuffle, both directions of the reference's shuffle_list
    (shuffle_list.rs:79):

      forwards=True:   output[compute_shuffled_index(i)] == input[i]
      forwards=False:  output[i] == input[compute_shuffled_index(i)]

    The backwards direction (default) is the one committee assignment uses
    (spec compute_committee; reference committee_cache.rs calls
    shuffle_list with forwards = false)."""
    n = len(input_list)
    if n == 0:
        return []
    perm = shuffle_indices(n, seed, rounds)
    out = [None] * n
    if forwards:
        for i, p in enumerate(perm):
            out[p] = input_list[i]
    else:
        for i, p in enumerate(perm):
            out[i] = input_list[p]
    return out


def shuffle_indices(
    n: int, seed: bytes, rounds: int = SHUFFLE_ROUND_COUNT
) -> np.ndarray:
    """Vectorized: perm[i] = compute_shuffled_index(i, n, seed)."""
    idx = np.arange(n, dtype=np.int64)
    n_words = (n + 255) // 256
    for r in range(rounds):
        rb = bytes([r])
        pivot = int.from_bytes(_hash(seed + rb)[:8], "little") % n
        flip = (pivot - idx) % n
        position = np.maximum(idx, flip)
        # one 32-byte source block per 256 positions
        blocks = np.frombuffer(
            b"".join(
                _hash(seed + rb + w.to_bytes(4, "little"))
                for w in range(n_words)
            ),
            dtype=np.uint8,
        ).reshape(n_words, 32)
        byte = blocks[position // 256, (position % 256) // 8]
        bit = (byte >> (position % 8).astype(np.uint8)) & 1
        idx = np.where(bit == 1, flip, idx)
    return idx

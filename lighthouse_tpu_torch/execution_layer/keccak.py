"""Keccak-256 (the pre-NIST-padding Keccak used by Ethereum), implemented
from the published Keccak-f[1600] specification. The reference reaches this
through its `keccak-hash` dependency (execution_layer/src/block_hash.rs,
types/src/execution_block_header.rs); Python's hashlib has no keccak (only
NIST SHA-3, whose domain padding differs), so the permutation lives here.

Pure Python is fine for the use cases: execution-header hashing and MPT
roots over transaction lists — a few dozen permutations per block.

The port's copy of lighthouse_tpu/execution_layer/keccak.py.
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(a: list[list[int]]) -> None:
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc


def _sponge_256(data: bytes, domain: int) -> bytes:
    """1088-bit-rate sponge with a parametric padding domain byte:
    0x01 = original Keccak (Ethereum), 0x06 = NIST SHA3. The SHA3 variant
    exists so tests can differentially anchor the permutation against an
    independent SHA3-256 implementation (hashlib/cryptography) -- the two
    differ ONLY in this byte."""
    rate = 136
    pad_len = rate - (len(data) % rate)
    if pad_len == 1:
        padded = data + bytes([domain | 0x80])  # both pad bits in one byte
    else:
        padded = data + bytes([domain]) + b"\x00" * (pad_len - 2) + b"\x80"
    a = [[0] * 5 for _ in range(5)]
    for block_start in range(0, len(padded), rate):
        block = padded[block_start : block_start + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            a[i % 5][i // 5] ^= lane
        _keccak_f(a)
    out = b""
    for i in range(4):  # 32 bytes = 4 lanes
        out += a[i % 5][i // 5].to_bytes(8, "little")
    return out


def keccak256(data: bytes) -> bytes:
    return _sponge_256(data, 0x01)


def sha3_256(data: bytes) -> bytes:
    """NIST SHA3-256 through the same sponge (differential-test hook)."""
    return _sponge_256(data, 0x06)

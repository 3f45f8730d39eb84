"""Minimal AES-128-CTR (encrypt == decrypt in CTR mode).

Keystore-only usage (EIP-2335 payloads are 32 bytes) -- this is NOT a
performance path, so a compact table-based pure-Python implementation is
the right dependency-free choice (the stdlib has no AES; the reference
gets it from RustCrypto via eth2_keystore).

The port's copy of lighthouse_tpu/crypto/aes.py.
"""

from __future__ import annotations

_SBOX = None


def _build_sbox():
    global _SBOX
    if _SBOX is not None:
        return _SBOX
    # multiplicative inverse table over GF(2^8) + affine transform
    p, q = 1, 1
    inv = [0] * 256
    while True:
        # p *= 3
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        # q /= 3
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        inv[p] = q
        if p == 1:
            break
    inv[0] = 0
    sbox = [0] * 256
    for i in range(256):
        x = inv[i] if i else 0
        s = x ^ _rotl8(x, 1) ^ _rotl8(x, 2) ^ _rotl8(x, 3) ^ _rotl8(x, 4) ^ 0x63
        sbox[i] = s
    _SBOX = sbox
    return sbox


def _rotl8(x: int, n: int) -> int:
    return ((x << n) | (x >> (8 - n))) & 0xFF


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _expand_key(key: bytes) -> list[list[int]]:
    sbox = _build_sbox()
    words = [list(key[i : i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        w = list(words[i - 1])
        if i % 4 == 0:
            w = w[1:] + w[:1]
            w = [sbox[b] for b in w]
            w[0] ^= rcon
            rcon = _xtime(rcon)
        words.append([a ^ b for a, b in zip(words[i - 4], w)])
    return [sum(words[4 * r : 4 * r + 4], []) for r in range(11)]


def _encrypt_block(block: bytes, round_keys) -> bytes:
    sbox = _build_sbox()
    # state is column-major 4x4 with flat index r + 4c == input byte order
    s = list(block)

    def add_round_key(state, rk):
        return [a ^ b for a, b in zip(state, rk)]

    def sub_bytes(state):
        return [sbox[b] for b in state]

    def shift_rows(state):
        out = list(state)
        for r in range(1, 4):
            row = [state[r + 4 * c] for c in range(4)]
            row = row[r:] + row[:r]
            for c in range(4):
                out[r + 4 * c] = row[c]
        return out

    def mix_columns(state):
        out = [0] * 16
        for c in range(4):
            col = state[4 * c : 4 * c + 4]
            out[4 * c + 0] = _xtime(col[0]) ^ _xtime(col[1]) ^ col[1] ^ col[2] ^ col[3]
            out[4 * c + 1] = col[0] ^ _xtime(col[1]) ^ _xtime(col[2]) ^ col[2] ^ col[3]
            out[4 * c + 2] = col[0] ^ col[1] ^ _xtime(col[2]) ^ _xtime(col[3]) ^ col[3]
            out[4 * c + 3] = _xtime(col[0]) ^ col[0] ^ col[1] ^ col[2] ^ _xtime(col[3])
        return out

    s = add_round_key(s, round_keys[0])
    for rnd in range(1, 10):
        s = add_round_key(mix_columns(shift_rows(sub_bytes(s))), round_keys[rnd])
    s = add_round_key(shift_rows(sub_bytes(s)), round_keys[10])
    return bytes(s)


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """CTR keystream XOR; key 16B, iv 16B (big-endian counter)."""
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("aes-128-ctr needs 16-byte key and iv")
    rks = _expand_key(key)
    out = bytearray()
    counter = int.from_bytes(iv, "big")
    for i in range(0, len(data), 16):
        stream = _encrypt_block(counter.to_bytes(16, "big"), rks)
        chunk = data[i : i + 16]
        out.extend(a ^ b for a, b in zip(chunk, stream))
        counter = (counter + 1) % (1 << 128)
    return bytes(out)

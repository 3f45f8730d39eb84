"""Pure-Python snappy block format (the `ssz_snappy` wire encoding of
reference lighthouse_network — rpc/codec/ssz_snappy.rs and gossip
compression in types/pubsub.rs).

The environment ships no snappy binding, so this implements the snappy
block format (github.com/google/snappy/blob/main/format_description.txt)
directly: `compress` emits a valid stream using literal tokens plus
greedy hash-matched copies; `decompress` handles the full tag set
(literals + 1/2/4-byte-offset copies), so streams from other snappy
implementations decode too. Wire-compatible, dependency-free.

The port's copy of lighthouse_tpu/network/snappy.py.
"""

from __future__ import annotations


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("snappy: truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise ValueError("snappy: varint too long")


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    n = len(chunk) - 1
    if n < 60:
        out.append(n << 2)
    elif n < (1 << 8):
        out.append(60 << 2)
        out.append(n)
    elif n < (1 << 16):
        out.append(61 << 2)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append(62 << 2)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += n.to_bytes(4, "little")
    out += chunk


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # prefer copy-with-2-byte-offset (tag 10); split long matches
    while length > 0:
        chunk = min(length, 64)
        if chunk < 4:
            # tags can't express length < 4 with 2-byte offset cleanly
            # when splitting; back off so the remainder is >= 4
            chunk = length
            if chunk < 4:
                break
        out.append(0b10 | ((chunk - 1) << 2) & 0xFF)
        out += offset.to_bytes(2, "little")
        length -= chunk
    return


def compress(data: bytes) -> bytes:
    """Greedy hash-table matcher (the format's reference strategy):
    4-byte hashes, literals between matches."""
    data = bytes(data)
    out = bytearray(_varint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    pos = 0
    literal_start = 0
    while pos + 4 <= n:
        key = data[pos : pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand <= 0xFFFF:
            # extend the match forward
            length = 4
            while (
                pos + length < n
                and data[cand + length] == data[pos + length]
                and length < 64
            ):
                length += 1
            if literal_start < pos:
                _emit_literal(out, data[literal_start:pos])
            _emit_copy(out, pos - cand, length)
            pos += length
            literal_start = pos
        else:
            pos += 1
    if literal_start < n:
        _emit_literal(out, data[literal_start:])
    return bytes(out)


def decompress(data: bytes) -> bytes:
    expected, pos = _read_varint(bytes(data), 0)
    out = bytearray()
    data = bytes(data)
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0b00:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise ValueError("snappy: truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise ValueError("snappy: truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 0b01:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise ValueError("snappy: truncated copy1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 0b10:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise ValueError("snappy: truncated copy2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise ValueError("snappy: truncated copy4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: invalid copy offset")
        # overlapping copies are byte-by-byte by definition
        for _ in range(length):
            out.append(out[-offset])
    if len(out) != expected:
        raise ValueError(
            f"snappy: length mismatch (got {len(out)}, want {expected})"
        )
    return bytes(out)

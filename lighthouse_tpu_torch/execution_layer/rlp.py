"""RLP encoding + the ordered Merkle-Patricia-Trie root, from the Ethereum
yellow-paper definitions. The reference reaches these through its
`triehash`/`rlp` crates (execution_layer/src/block_hash.rs:
calculate_transactions_root); here they exist to hash execution headers
and transaction lists for payload block-hash verification.

Only encoding is needed (we never decode engine data structurally), and
only the ordered trie (keys = rlp(index)) used for transactions/receipts
roots.

The port's copy of lighthouse_tpu/execution_layer/rlp.py.
"""

from __future__ import annotations

from .keccak import keccak256


def encode_bytes(data: bytes) -> bytes:
    if len(data) == 1 and data[0] < 0x80:
        return data
    return _len_prefix(len(data), 0x80) + data


def encode_int(n: int) -> bytes:
    """Integers are big-endian with no leading zeros; zero is empty."""
    if n == 0:
        return encode_bytes(b"")
    return encode_bytes(n.to_bytes((n.bit_length() + 7) // 8, "big"))


def encode_list(items: list[bytes]) -> bytes:
    """`items` are already-encoded RLP payloads."""
    body = b"".join(items)
    return _len_prefix(len(body), 0xC0) + body


def _len_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    ll = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(ll)]) + ll


# --- ordered Merkle-Patricia trie root --------------------------------------
# Keys are rlp(index) for index in 0..n; values are the raw byte strings.
# Node model per the yellow paper appendix D: leaf/extension nodes with
# hex-prefix-encoded paths, 17-ary branch nodes; nodes under 32 bytes embed
# in their parent, otherwise the parent stores keccak256(rlp(node)).

EMPTY_TRIE_ROOT = keccak256(encode_bytes(b""))


def _nibbles(key: bytes) -> list[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0x0F)
    return out


def _hex_prefix(nibbles: list[int], leaf: bool) -> bytes:
    flag = 2 if leaf else 0
    if len(nibbles) % 2:
        packed = [((flag + 1) << 4) + nibbles[0]]
        rest = nibbles[1:]
    else:
        packed = [flag << 4]
        rest = nibbles
    for i in range(0, len(rest), 2):
        packed.append((rest[i] << 4) + rest[i + 1])
    return bytes(packed)


def _node_ref(encoded: bytes) -> bytes:
    """Sub-32-byte nodes embed verbatim; larger ones hash (yellow paper c)."""
    if len(encoded) < 32:
        return encoded
    return encode_bytes(keccak256(encoded))


def _encode_node(items: list[tuple[list[int], bytes]]) -> bytes:
    """RLP encoding of the trie node covering `items` (suffix-nibbles,
    value), which must be non-empty and prefix-free (true for rlp(index)
    keys)."""
    if len(items) == 1:
        path, value = items[0]
        return encode_list(
            [encode_bytes(_hex_prefix(path, True)), encode_bytes(value)]
        )
    # shared prefix -> extension node
    first = items[0][0]
    prefix_len = 0
    while all(
        len(path) > prefix_len and path[prefix_len] == first[prefix_len]
        for path, _ in items
    ):
        prefix_len += 1
    if prefix_len:
        child = _encode_node(
            [(path[prefix_len:], v) for path, v in items]
        )
        return encode_list(
            [
                encode_bytes(_hex_prefix(first[:prefix_len], False)),
                _node_ref(child),
            ]
        )
    # branch node
    slots: list[list] = [[] for _ in range(16)]
    branch_value = b""
    for path, v in items:
        if not path:
            branch_value = v
        else:
            slots[path[0]].append((path[1:], v))
    encoded_slots = []
    for bucket in slots:
        if not bucket:
            encoded_slots.append(encode_bytes(b""))
        else:
            encoded_slots.append(_node_ref(_encode_node(bucket)))
    encoded_slots.append(encode_bytes(branch_value))
    return encode_list(encoded_slots)


def ordered_trie_root(values: list[bytes]) -> bytes:
    """Root of the trie mapping rlp(i) -> values[i] (the
    transactions/receipts root construction)."""
    if not values:
        return EMPTY_TRIE_ROOT
    items = [(_nibbles(encode_int(i)), v) for i, v in enumerate(values)]
    return keccak256(_encode_node(items))

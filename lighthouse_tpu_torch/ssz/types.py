"""SSZ type system: encode/decode + hash-tree-root.

Python equivalent of the reference's ssz / ssz_derive / ssz_types /
tree_hash crates (consensus/ssz/src, consensus/ssz_types/src,
consensus/tree_hash/src): `Encode`/`Decode`/`TreeHash` become methods on
type-descriptor objects; the derive macros become the `@container`
decorator over annotated dataclass-like classes.

Descriptors are singletons (`uint64`, `Bytes32`, ...) or parameterized
(`List(uint64, 1024)`), each with:
    is_fixed()  fixed_size()  encode(v)->bytes  decode(b)->v
    hash_tree_root(v)->bytes32  default()
"""

from __future__ import annotations

from .hash import (
    BYTES_PER_CHUNK,
    ZERO_HASHES,
    merkleize,
    mix_in_length,
    pack_bytes,
)

OFFSET_SIZE = 4


class SszError(ValueError):
    pass


class SszType:
    def is_fixed(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        raise NotImplementedError

    def encode(self, value) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError


class _UInt(SszType):
    def __init__(self, byte_len: int):
        self.byte_len = byte_len

    def is_fixed(self):
        return True

    def fixed_size(self):
        return self.byte_len

    def encode(self, value) -> bytes:
        value = int(value)
        if not 0 <= value < (1 << (8 * self.byte_len)):
            raise SszError(
                f"uint{self.byte_len * 8}: value out of range: {value}"
            )
        return value.to_bytes(self.byte_len, "little")

    def decode(self, data: bytes) -> int:
        if len(data) != self.byte_len:
            raise SszError(f"uint{self.byte_len * 8}: bad length {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return self.encode(value).ljust(BYTES_PER_CHUNK, b"\x00")

    def default(self):
        return 0


class _Boolean(SszType):
    def is_fixed(self):
        return True

    def fixed_size(self):
        return 1

    def encode(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def decode(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise SszError("boolean must be 0x00 or 0x01")

    def hash_tree_root(self, value) -> bytes:
        return self.encode(value).ljust(BYTES_PER_CHUNK, b"\x00")

    def default(self):
        return False


uint8 = _UInt(1)
uint16 = _UInt(2)
uint32 = _UInt(4)
uint64 = _UInt(8)
uint128 = _UInt(16)
uint256 = _UInt(32)
boolean = _Boolean()


class ByteVector(SszType):
    """Fixed-length opaque bytes (Bytes4/20/32/48/96 spec aliases)."""

    def __init__(self, length: int):
        self.length = length

    def is_fixed(self):
        return True

    def fixed_size(self):
        return self.length

    def encode(self, value) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise SszError(f"ByteVector[{self.length}]: got {len(value)}")
        return value

    def decode(self, data: bytes) -> bytes:
        return self.encode(data)

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.encode(value)))

    def default(self):
        return bytes(self.length)


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


class ByteList(SszType):
    """Variable-length opaque bytes with a max length."""

    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed(self):
        return False

    def encode(self, value) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise SszError(f"ByteList[{self.limit}]: got {len(value)}")
        return value

    def decode(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise SszError(f"ByteList[{self.limit}]: got {len(data)}")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        value = self.encode(value)
        limit_chunks = (self.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return mix_in_length(
            merkleize(pack_bytes(value), limit_chunks), len(value)
        )

    def default(self):
        return b""


class Bitvector(SszType):
    """Fixed-length bit sequence; value is a tuple/list of bools."""

    def __init__(self, length: int):
        if length <= 0:
            raise SszError("Bitvector length must be positive")
        self.length = length

    def is_fixed(self):
        return True

    def fixed_size(self):
        return (self.length + 7) // 8

    def encode(self, value) -> bytes:
        bits = list(value)
        if len(bits) != self.length:
            raise SszError(f"Bitvector[{self.length}]: got {len(bits)}")
        out = bytearray(self.fixed_size())
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def decode(self, data: bytes):
        if len(data) != self.fixed_size():
            raise SszError(f"Bitvector[{self.length}]: bad byte length")
        bits = [bool(data[i // 8] >> (i % 8) & 1) for i in range(self.length)]
        # excess bits in the last byte must be zero
        for i in range(self.length, len(data) * 8):
            if data[i // 8] >> (i % 8) & 1:
                raise SszError("Bitvector: non-zero padding bits")
        return tuple(bits)

    def hash_tree_root(self, value) -> bytes:
        limit = (self.length + 255) // 256
        return merkleize(pack_bytes(self.encode(value)), limit)

    def default(self):
        return tuple(False for _ in range(self.length))


class Bitlist(SszType):
    """Variable-length bit sequence with max length; delimiting-bit format."""

    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed(self):
        return False

    def encode(self, value) -> bytes:
        bits = list(value)
        if len(bits) > self.limit:
            raise SszError(f"Bitlist[{self.limit}]: got {len(bits)}")
        out = bytearray((len(bits) // 8) + 1)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        out[len(bits) // 8] |= 1 << (len(bits) % 8)  # delimiter
        return bytes(out)

    def decode(self, data: bytes):
        if not data or data[-1] == 0:
            raise SszError("Bitlist: missing delimiter bit")
        total_bits = (len(data) - 1) * 8 + data[-1].bit_length() - 1
        if total_bits > self.limit:
            raise SszError(f"Bitlist[{self.limit}]: got {total_bits}")
        return tuple(
            bool(data[i // 8] >> (i % 8) & 1) for i in range(total_bits)
        )

    def hash_tree_root(self, value) -> bytes:
        bits = list(value)
        out = bytearray((len(bits) + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        limit = (self.limit + 255) // 256
        return mix_in_length(merkleize(pack_bytes(bytes(out)), limit), len(bits))

    def default(self):
        return ()


def _is_basic(t: SszType) -> bool:
    return isinstance(t, (_UInt, _Boolean))


class Vector(SszType):
    """Fixed-length homogeneous sequence."""

    def __init__(self, elem: SszType, length: int):
        if length <= 0:
            raise SszError("Vector length must be positive")
        self.elem = elem
        self.length = length

    def is_fixed(self):
        return self.elem.is_fixed()

    def fixed_size(self):
        return self.elem.fixed_size() * self.length

    def encode(self, value) -> bytes:
        items = list(value)
        if len(items) != self.length:
            raise SszError(f"Vector[{self.length}]: got {len(items)}")
        return _encode_sequence(self.elem, items)

    def decode(self, data: bytes):
        return tuple(_decode_sequence(self.elem, data, exact=self.length))

    def hash_tree_root(self, value) -> bytes:
        return _sequence_root(self.elem, list(value), limit_elems=None)

    def default(self):
        return tuple(self.elem.default() for _ in range(self.length))


class List(SszType):
    """Variable-length homogeneous sequence with max length."""

    def __init__(self, elem: SszType, limit: int):
        self.elem = elem
        self.limit = limit

    def is_fixed(self):
        return False

    def encode(self, value) -> bytes:
        items = list(value)
        if len(items) > self.limit:
            raise SszError(f"List[{self.limit}]: got {len(items)}")
        return _encode_sequence(self.elem, items)

    def decode(self, data: bytes):
        items = _decode_sequence(self.elem, data, exact=None)
        if len(items) > self.limit:
            raise SszError(f"List[{self.limit}]: got {len(items)}")
        return tuple(items)

    def hash_tree_root(self, value) -> bytes:
        items = list(value)
        root = _sequence_root(self.elem, items, limit_elems=self.limit)
        return mix_in_length(root, len(items))

    def default(self):
        return ()


def _encode_sequence(elem: SszType, items) -> bytes:
    if elem.is_fixed():
        return b"".join(elem.encode(v) for v in items)
    parts = [elem.encode(v) for v in items]
    offset = OFFSET_SIZE * len(parts)
    head = bytearray()
    for p in parts:
        head += offset.to_bytes(OFFSET_SIZE, "little")
        offset += len(p)
    return bytes(head) + b"".join(parts)


def _decode_sequence(elem: SszType, data: bytes, exact: int | None):
    if elem.is_fixed():
        size = elem.fixed_size()
        if len(data) % size:
            raise SszError("sequence length not a multiple of element size")
        n = len(data) // size
        if exact is not None and n != exact:
            raise SszError(f"expected {exact} elements, got {n}")
        return [elem.decode(data[i * size : (i + 1) * size]) for i in range(n)]
    if not data:
        if exact:
            raise SszError(f"expected {exact} elements, got 0")
        return []
    first_off = int.from_bytes(data[:OFFSET_SIZE], "little")
    if first_off % OFFSET_SIZE or first_off > len(data):
        raise SszError("bad first offset")
    n = first_off // OFFSET_SIZE
    if exact is not None and n != exact:
        raise SszError(f"expected {exact} elements, got {n}")
    offsets = [
        int.from_bytes(data[i * OFFSET_SIZE : (i + 1) * OFFSET_SIZE], "little")
        for i in range(n)
    ] + [len(data)]
    out = []
    for i in range(n):
        if offsets[i + 1] < offsets[i] or offsets[i + 1] > len(data):
            raise SszError("offsets not monotonic")
        out.append(elem.decode(data[offsets[i] : offsets[i + 1]]))
    return out


def _sequence_root(elem: SszType, items, limit_elems: int | None) -> bytes:
    if _is_basic(elem):
        data = b"".join(elem.encode(v) for v in items)
        chunks = pack_bytes(data)
        if limit_elems is not None:
            per_chunk = BYTES_PER_CHUNK // elem.fixed_size()
            limit = (limit_elems + per_chunk - 1) // per_chunk
        else:
            limit = None  # Vector: natural width
        return merkleize(chunks, limit)
    roots = [elem.hash_tree_root(v) for v in items]
    return merkleize(roots, limit_elems)


class Container(SszType):
    """Descriptor for an @container class (see below)."""

    def __init__(self, cls, fields):
        self.cls = cls
        self.fields = fields  # [(name, SszType)]

    def is_fixed(self):
        return all(t.is_fixed() for _, t in self.fields)

    def fixed_size(self):
        return sum(t.fixed_size() for _, t in self.fields)

    def encode(self, value) -> bytes:
        head = bytearray()
        tail = bytearray()
        fixed_len = sum(
            t.fixed_size() if t.is_fixed() else OFFSET_SIZE
            for _, t in self.fields
        )
        for name, t in self.fields:
            v = getattr(value, name)
            if t.is_fixed():
                head += t.encode(v)
            else:
                head += (fixed_len + len(tail)).to_bytes(OFFSET_SIZE, "little")
                tail += t.encode(v)
        return bytes(head) + bytes(tail)

    def decode(self, data: bytes):
        kwargs = {}
        pos = 0
        var_fields = []
        offsets = []
        for name, t in self.fields:
            if t.is_fixed():
                size = t.fixed_size()
                kwargs[name] = t.decode(data[pos : pos + size])
                pos += size
            else:
                if pos + OFFSET_SIZE > len(data):
                    raise SszError("container truncated")
                offsets.append(
                    int.from_bytes(data[pos : pos + OFFSET_SIZE], "little")
                )
                var_fields.append((name, t))
                pos += OFFSET_SIZE
        if var_fields:
            if offsets[0] != pos:
                raise SszError("first offset must equal fixed length")
            offsets.append(len(data))
            for i, (name, t) in enumerate(var_fields):
                if offsets[i + 1] < offsets[i] or offsets[i + 1] > len(data):
                    raise SszError("offsets not monotonic")
                kwargs[name] = t.decode(data[offsets[i] : offsets[i + 1]])
        elif pos != len(data):
            raise SszError("container trailing bytes")
        return self.cls(**kwargs)

    def hash_tree_root(self, value) -> bytes:
        roots = [t.hash_tree_root(getattr(value, name)) for name, t in self.fields]
        return merkleize(roots)

    def default(self):
        return self.cls(**{name: t.default() for name, t in self.fields})


def container(cls):
    """Class decorator: annotations of SszType descriptors -> SSZ container.

    Produces an __init__ (defaults from the descriptors), equality, repr,
    and classmethods/methods: as_ssz_bytes, from_ssz_bytes, tree_hash_root,
    ssz_type. The derive-macro equivalent of ssz_derive + tree_hash_derive.
    """
    fields = [
        (name, t) for name, t in cls.__dict__.get("__annotations__", {}).items()
    ]
    for name, t in fields:
        if not isinstance(t, SszType):
            raise TypeError(f"{cls.__name__}.{name}: not an SszType")
    desc = Container(cls, fields)

    def __init__(self, **kwargs):
        for name, t in fields:
            if name in kwargs:
                setattr(self, name, kwargs.pop(name))
            else:
                setattr(self, name, t.default())
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")

    def __eq__(self, other):
        if other.__class__ is not self.__class__:
            return NotImplemented
        return all(
            getattr(self, n) == getattr(other, n) for n, _ in fields
        )

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n, _ in fields[:4])
        more = ", …" if len(fields) > 4 else ""
        return f"{cls.__name__}({inner}{more})"

    cls.__init__ = __init__
    cls.__eq__ = __eq__
    cls.__hash__ = None
    cls.__repr__ = __repr__
    cls.ssz_type = desc
    cls.ssz_fields = fields
    cls.as_ssz_bytes = lambda self: desc.encode(self)
    cls.from_ssz_bytes = classmethod(lambda c, data: desc.decode(bytes(data)))
    cls.tree_hash_root = lambda self: desc.hash_tree_root(self)
    cls.default = classmethod(lambda c: desc.default())
    return cls

"""Incremental (cached) tree hashing.

Python equivalent of the reference's `consensus/cached_tree_hash` crate
(cached_tree_hash/src/lib.rs): instead of re-merkleizing every field of a
large container (the `BeaconState` hot case) on every root request, keep
the previous merkle layers per field and re-hash only the paths whose leaf
chunks changed. The reference stores one arena-backed `TreeHashCache` per
multi-leaf field (cached_tree_hash/src/v2.rs style multi-cache over
validators/balances/roots vectors); here each such field gets a
`ChunkTreeCache`, and composite list elements (validators) get a
content-keyed root memo shared process-wide so cloned states re-use work.

Safety model (why content keys, not object identity): the state-transition
code mutates element containers in place *and then replaces the outer
tuple* (e.g. per_epoch.py effective-balance updates). The outer-tuple
identity is therefore a reliable "unchanged" signal, while element
identity is not — so unchanged fields are skipped by tuple identity, and
changed composite elements are keyed by their field *contents*.
"""

from __future__ import annotations

import struct

from .hash import ZERO_HASHES, hash_concat, merkleize, mix_in_length, pack_bytes
from .types import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    SszType,
    Vector,
    _Boolean,
    _UInt,
)

BYTES_PER_CHUNK = 32


def _is_basic(t: SszType) -> bool:
    return isinstance(t, (_UInt, _Boolean))


def _ceil_log2(n: int) -> int:
    return max(n - 1, 0).bit_length()


class ChunkTreeCache:
    """Incremental merkleization of a bounded chunk list.

    Equivalent contract to `merkleize(chunks, limit)` in hash.py, but
    `update()` diffs the new chunk list against the previous one and
    re-hashes only dirty parent paths. Layers store the occupied prefix
    only; absent right siblings are the standard zero-subtree hashes.
    """

    def __init__(self, limit_chunks: int | None):
        # None = Vector semantics: width fixed by the first update.
        self.limit = limit_chunks
        self.depth = None if limit_chunks is None else _ceil_log2(limit_chunks)
        self.layers: list[list[bytes]] | None = None

    def _full_build(self, chunks: list[bytes]) -> bytes:
        depth = self.depth
        if depth is None:
            depth = _ceil_log2(max(len(chunks), 1))
            self.depth = depth
        layers = [list(chunks)]
        for d in range(depth):
            prev = layers[-1]
            nxt = []
            for i in range(0, len(prev), 2):
                right = prev[i + 1] if i + 1 < len(prev) else ZERO_HASHES[d]
                nxt.append(hash_concat(prev[i], right))
            layers.append(nxt)
        self.layers = layers
        return layers[depth][0] if layers[depth] else ZERO_HASHES[depth]

    def update(self, chunks: list[bytes]) -> bytes:
        if self.limit is not None and len(chunks) > self.limit:
            raise ValueError(f"too many chunks: {len(chunks)} > {self.limit}")
        if self.layers is None:
            return self._full_build(chunks)
        depth = self.depth
        old = self.layers[0]
        n, m = len(chunks), len(old)
        common = min(n, m)
        dirty = {i for i in range(common) if chunks[i] is not old[i] and chunks[i] != old[i]}
        dirty.update(range(common, max(n, m)))
        if not dirty:
            top = self.layers[depth]
            return top[0] if top else ZERO_HASHES[depth]
        self.layers[0] = list(chunks)
        level = {i // 2 for i in dirty}
        for d in range(depth):
            prev = self.layers[d]
            cur = self.layers[d + 1]
            width = (len(prev) + 1) // 2
            del cur[width:]
            while len(cur) < width:
                cur.append(b"")
            for i in level:
                if i < width:
                    right = (
                        prev[2 * i + 1]
                        if 2 * i + 1 < len(prev)
                        else ZERO_HASHES[d]
                    )
                    cur[i] = hash_concat(prev[2 * i], right)
            # propagate even indices >= width: that subtree vanished on a
            # shrink, so its ancestor still needs re-deriving with a zero
            # right sibling at the level where it re-enters the width
            level = {i // 2 for i in level}
        top = self.layers[depth]
        return top[0] if top else ZERO_HASHES[depth]


# Process-wide memo: root of a composite element keyed by its contents.
# Bounded; cleared wholesale when it grows past the cap (validators change
# rarely, so steady-state hit rate stays high even across clears).
_COMPOSITE_MEMO: dict = {}
_COMPOSITE_MEMO_CAP = 1 << 20


def _flat_field_names(desc: Container):
    """Field names if every field is basic or fixed bytes (content key can
    be the raw attribute tuple); None if the container nests composites."""
    names = []
    for name, t in desc.fields:
        if not (_is_basic(t) or isinstance(t, ByteVector)):
            return None
        names.append(name)
    return tuple(names)


def _composite_root(t: SszType, value) -> bytes:
    """Root of one composite list element, via the content-keyed memo."""
    if isinstance(t, Container):
        flat = t.__dict__.get("_flat_names", False)
        if flat is False:
            flat = t._flat_names = _flat_field_names(t)
        if flat is not None:
            key = (id(t), tuple(getattr(value, n) for n in flat))
        else:
            key = (id(t), t.encode(value))
        root = _COMPOSITE_MEMO.get(key)
        if root is None:
            if len(_COMPOSITE_MEMO) >= _COMPOSITE_MEMO_CAP:
                _COMPOSITE_MEMO.clear()
            root = _COMPOSITE_MEMO[key] = t.hash_tree_root(value)
        return root
    return t.hash_tree_root(value)


_UINT_PACK = {}
_UINT_FMT = {1: "B", 2: "H", 4: "I", 8: "Q"}


def _basic_chunks(elem: SszType, items) -> list[bytes]:
    """pack_bytes of the encoded items, with struct fast paths for all
    uint widths (uint8 participation lists and uint64 balances/scores are
    the 500k-element hot fields; per-element encode() calls dominate the
    steady-state root otherwise)."""
    if isinstance(elem, _UInt) and elem.byte_len in _UINT_FMT:
        if elem.byte_len == 1:
            data = bytes(items)
        else:
            n = len(items)
            key = (n, elem.byte_len)
            fmt = _UINT_PACK.get(key)
            if fmt is None:
                fmt = _UINT_PACK[key] = struct.Struct(
                    f"<{n}{_UINT_FMT[elem.byte_len]}"
                )
            data = fmt.pack(*items)
    else:
        data = b"".join(elem.encode(v) for v in items)
    return pack_bytes(data)


class _FieldCache:
    __slots__ = ("ref", "root", "tree")

    def __init__(self):
        self.ref = None
        self.root = None
        self.tree = None


class CachedRoot:
    """Incremental hash_tree_root for one container *instance*.

    One per tracked object (attach via `cached_root(obj)`); re-uses
    per-field merkle trees across calls. Correct regardless of how fields
    were mutated: unchanged-ness is decided by outer-value identity only
    where the value is immutable by construction (tuples of ints/bytes,
    bytes), and by content comparison everywhere else.
    """

    def __init__(self, desc: Container):
        self.desc = desc
        self.fields = {name: _FieldCache() for name, _ in desc.fields}

    def root(self, value) -> bytes:
        roots = [
            self._field_root(name, t, getattr(value, name))
            for name, t in self.desc.fields
        ]
        return merkleize(roots)

    def _field_root(self, name: str, t: SszType, v) -> bytes:
        fc = self.fields[name]
        if isinstance(t, (List, Vector)):
            elem = t.elem
            if _is_basic(elem) or isinstance(elem, ByteVector):
                # immutable element contents: outer-tuple identity is sound
                if fc.ref is v and fc.root is not None:
                    return fc.root
                if _is_basic(elem):
                    chunks = _basic_chunks(elem, v)
                    if isinstance(t, List):
                        per = BYTES_PER_CHUNK // elem.fixed_size()
                        limit = (t.limit + per - 1) // per
                    else:
                        limit = None
                else:
                    chunks = [elem.hash_tree_root(x) for x in v]
                    limit = t.limit if isinstance(t, List) else None
                if fc.tree is None:
                    fc.tree = ChunkTreeCache(limit)
                root = fc.tree.update(chunks)
                if isinstance(t, List):
                    root = mix_in_length(root, len(v))
                fc.ref, fc.root = v, root
                return root
            # composite elements (validators &c): content-keyed elem roots,
            # incremental tree over them. The outer-tuple identity shortcut
            # leans on the state-transition convention that in-place element
            # mutation is ALWAYS followed by re-tupling the field (every
            # mutation site in per_block/per_epoch does `vals = list(...)`,
            # mutate, `state.validators = tuple(vals)`); a same-identity
            # tuple therefore has unchanged contents.
            if fc.ref is v and fc.root is not None:
                return fc.root
            leaf_roots = [_composite_root(elem, x) for x in v]
            if fc.tree is None:
                fc.tree = ChunkTreeCache(t.limit if isinstance(t, List) else None)
            root = fc.tree.update(leaf_roots)
            if isinstance(t, List):
                root = mix_in_length(root, len(v))
            fc.ref, fc.root = v, root
            return root
        if isinstance(t, (ByteVector, ByteList, Bitvector, Bitlist)):
            if fc.ref is v and fc.root is not None:
                return fc.root  # bytes/tuple-of-bool values are immutable
            root = t.hash_tree_root(v)
            fc.ref, fc.root = v, root
            return root
        if isinstance(t, Container):
            return _composite_root(t, v)
        return t.hash_tree_root(v)  # basics: trivial


def cached_root(obj) -> bytes:
    """hash_tree_root(obj) through a per-instance incremental cache.

    The cache rides on the instance (`_lh_tree_cache`); a freshly cloned
    state pays one full build, then every subsequent call is proportional
    to what changed. Falls back to the plain root for non-@container
    values.
    """
    desc = getattr(obj, "ssz_type", None)
    if not isinstance(desc, Container):
        return obj.tree_hash_root()
    cache = obj.__dict__.get("_lh_tree_cache")
    if cache is None or cache.desc is not desc:
        cache = CachedRoot(desc)
        obj.__dict__["_lh_tree_cache"] = cache
    return cache.root(obj)


def surgical_list_update(
    obj, field_name: str, old_value, new_value, changed_indices
) -> None:
    """Install `new_value` into obj.<field_name> and update the instance
    tree cache leaf-wise: only `changed_indices` get their element roots
    recomputed (epoch processing touches a handful of 500k validators; a
    full memo pass per boundary is the dominant steady-state hash cost).

    Sound only when the cache's previous leaf layer corresponds to
    `old_value` element-for-element and `new_value` differs from it at
    exactly `changed_indices` (same length). When any precondition fails
    this degrades to plain assignment — the next cached_root recomputes
    the field in full, which is always correct."""
    setattr(obj, field_name, new_value)
    cache = obj.__dict__.get("_lh_tree_cache")
    if cache is None:
        return
    fc = cache.fields.get(field_name)
    if (
        fc is None
        or fc.tree is None
        or fc.tree.layers is None
        or fc.ref is not old_value
        or len(fc.tree.layers[0]) != len(new_value)
    ):
        if fc is not None:
            fc.ref = None  # force a full field recompute on the next root
        return
    t = next(ft for fn, ft in cache.desc.fields if fn == field_name)
    chunks = list(fc.tree.layers[0])
    for i in changed_indices:
        chunks[i] = _composite_root(t.elem, new_value[i])
    root = fc.tree.update(chunks)
    if isinstance(t, List):
        root = mix_in_length(root, len(new_value))
    fc.ref, fc.root = new_value, root


def cached_field_roots(obj) -> list[bytes]:
    """Per-field roots through the same per-instance incremental cache as
    cached_root (merkle-proof generation needs the field layer; computing
    it fresh would re-merkleize the whole state per proof)."""
    desc = getattr(obj, "ssz_type", None)
    if not isinstance(desc, Container):
        raise TypeError("cached_field_roots needs an @container instance")
    cache = obj.__dict__.get("_lh_tree_cache")
    if cache is None or cache.desc is not desc:
        cache = CachedRoot(desc)
        obj.__dict__["_lh_tree_cache"] = cache
    return [
        cache._field_root(name, t, getattr(obj, name))
        for name, t in desc.fields
    ]

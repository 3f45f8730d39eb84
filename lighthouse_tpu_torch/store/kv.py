"""Key-value store abstraction (reference beacon_node/store/src/lib.rs:49,107
KeyValueStore/ItemStore traits; memory_store.rs; leveldb_store.rs).

Backends: `MemoryStore` (tests/ephemeral chains) and `FileStore` (simple
column-file persistence). A C++ embedded-store backend slots in behind the
same interface (the reference's LevelDB seat) in a later round.

Crash safety: `do_atomically` is a write-ahead journal protocol on every
backend (the reference gets the same guarantee from leveldb write-batches).
The batch is serialized — length-framed, CRC-protected — into a single
journal row FIRST; only once that intent record is durable are the ops
applied, and the journal row is deleted as the commit marker. On reopen,
`recover_journal` replays a complete journal (the crash hit mid-apply:
redo, ops are idempotent) and discards a torn one (the crash hit the
intent write itself: the batch never logically happened). Either way the
store ends in a state some crash-free execution could have produced.

The port's copy of lighthouse_tpu/store/kv.py.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import OrderedDict

# guards lazy creation of per-store batch locks (see do_atomically)
_BATCH_LOCK_INIT = threading.Lock()


class Column:
    BLOCK = b"blk"
    STATE = b"ste"
    STATE_SUMMARY = b"ssu"
    CHAIN = b"chn"
    FREEZER_BLOCK = b"fbk"
    FREEZER_STATE = b"fst"
    # chunked per-slot root vectors (reference store/src/chunked_vector.rs:
    # block_roots/state_roots stored once globally in 128-entry chunk rows
    # instead of duplicated inside every frozen state)
    FREEZER_BLOCK_ROOTS = b"fbr"
    FREEZER_STATE_ROOTS = b"fsr"
    # write-ahead journal for do_atomically (one batch in flight at a time)
    JOURNAL = b"jnl"


JOURNAL_KEY = b"batch"
_JOURNAL_MAGIC = b"LHWAL1\x00"


def encode_batch(ops) -> bytes:
    """Serialize a do_atomically batch into one journal blob.

    Validates every op BEFORE any byte is framed, so a malformed batch
    raises without a journal row ever being written (mirroring
    native_kv.py's convert-before-BATCH_BEGIN care)."""
    payload = bytearray(struct.pack(">I", len(ops)))
    for op, column, key, value in ops:
        if op == "put":
            value = bytes(value)
            payload += b"P"
        elif op == "delete":
            value = b""
            payload += b"D"
        else:
            raise ValueError(f"unknown batch op {op!r}")
        column, key = bytes(column), bytes(key)
        payload += struct.pack(">I", len(column)) + column
        payload += struct.pack(">I", len(key)) + key
        payload += struct.pack(">I", len(value)) + value
    return (
        _JOURNAL_MAGIC
        + struct.pack(">II", len(payload), zlib.crc32(bytes(payload)))
        + bytes(payload)
    )


def decode_batch(blob: bytes):
    """The ops of a journal blob, or None when the blob is torn/corrupt
    (truncated write, bad checksum, bad framing) — the rollback signal."""
    hdr = len(_JOURNAL_MAGIC) + 8
    if len(blob) < hdr or not blob.startswith(_JOURNAL_MAGIC):
        return None
    length, crc = struct.unpack(">II", blob[len(_JOURNAL_MAGIC) : hdr])
    payload = blob[hdr:]
    if len(payload) != length or zlib.crc32(payload) != crc:
        return None
    try:
        (count,) = struct.unpack(">I", payload[:4])
        pos = 4
        ops = []
        for _ in range(count):
            tag = payload[pos : pos + 1]
            pos += 1
            fields = []
            for _f in range(3):
                (n,) = struct.unpack(">I", payload[pos : pos + 4])
                pos += 4
                fields.append(payload[pos : pos + n])
                pos += n
            column, key, value = fields
            if tag == b"P":
                ops.append(("put", column, key, value))
            elif tag == b"D":
                ops.append(("delete", column, key, None))
            else:
                return None
        if pos != len(payload):
            return None
        return ops
    except struct.error:
        return None


def recover_journal(kv) -> str:
    """Open-time journal recovery: "clean" (no journal), "replayed" (a
    complete intent record re-applied — the crash hit mid-apply), or
    "rolled_back" (a torn intent record discarded — the batch never
    committed). Counted in utils.metrics; idempotent under a crash during
    recovery itself (the journal row is deleted last)."""
    blob = kv.get(Column.JOURNAL, JOURNAL_KEY)
    if blob is None:
        return "clean"
    from ..utils import metrics as M

    ops = decode_batch(blob)
    if ops is None:
        kv.delete(Column.JOURNAL, JOURNAL_KEY)
        M.STORE_JOURNAL_ROLLBACKS.inc()
        return "rolled_back"
    for op, column, key, value in ops:
        if op == "put":
            kv.put(column, key, value)
        else:
            kv.delete(column, key)
    kv.delete(Column.JOURNAL, JOURNAL_KEY)
    M.STORE_JOURNAL_REPLAYS.inc()
    return "replayed"


class KeyValueStore:
    def get(self, column: bytes, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, column: bytes, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, column: bytes, key: bytes) -> None:
        raise NotImplementedError

    def keys(self, column: bytes):
        raise NotImplementedError

    def do_atomically(self, ops) -> None:
        """ops: [(op, column, key, value-or-None)] with op in {put, delete}.

        All-or-nothing via the write-ahead journal: intent record ->
        apply -> commit-marker delete. A crash anywhere in between is
        repaired by recover_journal on reopen (replay once the intent is
        durable, rollback when it is not). Backends with native batches
        (native_kv.py) override this.

        Batches serialize on a per-store lock: there is ONE journal row,
        so two concurrent batches (the HTTP thread's reconstruct against
        the chain thread's import) would otherwise overwrite each other's
        intent records and a crash could pass recovery as "clean" while
        one batch is torn. The lock is created lazily so subclasses need
        not call __init__."""
        ops = list(ops)
        if not ops:
            return
        lock = self.__dict__.get("_batch_lock")
        if lock is None:
            with _BATCH_LOCK_INIT:
                lock = self.__dict__.setdefault(
                    "_batch_lock", threading.Lock()
                )
        blob = encode_batch(ops)  # validates before any write
        with lock:
            self.put(Column.JOURNAL, JOURNAL_KEY, blob)
            for op, column, key, value in ops:
                if op == "put":
                    self.put(column, key, value)
                else:
                    self.delete(column, key)
            self.delete(Column.JOURNAL, JOURNAL_KEY)


class AtomicBatch:
    """Staged multi-key mutation committed through do_atomically.

    Staging (`stage` / `stage_delete` / `stage_chain_item`) performs no
    I/O; `commit()` writes the journal intent and applies everything
    all-or-nothing. This is the sanctioned shape for multi-key CHAIN
    mutations (the bare-atomic-batch lint rule flags direct sequences)."""

    def __init__(self, kv: KeyValueStore):
        self.kv = kv
        self.ops: list = []

    def stage(self, column: bytes, key: bytes, value: bytes) -> None:
        self.ops.append(("put", bytes(column), bytes(key), bytes(value)))

    def stage_delete(self, column: bytes, key: bytes) -> None:
        self.ops.append(("delete", bytes(column), bytes(key), None))

    def stage_chain_item(self, key: bytes, value: bytes) -> None:
        self.stage(Column.CHAIN, key, value)

    def __len__(self) -> int:
        return len(self.ops)

    def commit(self) -> None:
        if self.ops:
            self.kv.do_atomically(self.ops)
            self.ops = []


class MemoryStore(KeyValueStore):
    def __init__(self):
        self._data: dict[bytes, OrderedDict[bytes, bytes]] = {}

    def _col(self, column: bytes) -> OrderedDict:
        return self._data.setdefault(column, OrderedDict())

    def get(self, column, key):
        return self._col(column).get(key)

    def put(self, column, key, value):
        self._col(column)[key] = bytes(value)

    def delete(self, column, key):
        self._col(column).pop(key, None)

    def keys(self, column):
        return list(self._col(column).keys())


class FileStore(KeyValueStore):
    """One file per entry under <root>/<column>/<hexkey>. Crash-safe for
    node-restart resume; not a performance path.

    Durability: with ``durable=True`` (the default) every put fsyncs the
    tmp file before the rename and the directory entry after it, so an
    acknowledged write survives a power cut — a rename alone only orders
    the data against OTHER renames, it does not force it to disk.
    ``durable=False`` is the escape hatch for tests and throwaway dirs."""

    def __init__(self, root: str, durable: bool = True):
        self.root = root
        self.durable = durable
        os.makedirs(root, exist_ok=True)

    def _path(self, column: bytes, key: bytes) -> str:
        d = os.path.join(self.root, column.decode())
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, key.hex())

    @staticmethod
    def _fsync_dir(d: str) -> None:
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def get(self, column, key):
        try:
            with open(self._path(column, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def put(self, column, key, value):
        path = self._path(column, key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
            if self.durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.durable:
            self._fsync_dir(os.path.dirname(path))

    def delete(self, column, key):
        try:
            os.remove(self._path(column, key))
        except FileNotFoundError:
            return
        if self.durable:
            self._fsync_dir(os.path.dirname(self._path(column, key)))

    def keys(self, column):
        d = os.path.join(self.root, column.decode())
        if not os.path.isdir(d):
            return []
        return [bytes.fromhex(f) for f in os.listdir(d) if not f.endswith(".tmp")]


def slot_key(slot: int) -> bytes:
    return struct.pack(">Q", slot)

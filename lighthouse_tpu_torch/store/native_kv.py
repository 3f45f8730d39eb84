"""Native embedded KV backend (the LevelDB seat, reference
beacon_node/store/src/leveldb_store.rs): a C++ log-structured store
(native/kvstore.cc) behind the same KeyValueStore interface as
MemoryStore/FileStore. ctypes binding (no pybind11 in the image); the
shared library is built on demand with g++ from the port's own copy of
the source (lighthouse_tpu_torch/native/kvstore.cc) into
build/native/<source hash>/, and a failed build raises
``NativeBuildError``.

Crash semantics match the reference's expectations of LevelDB:
`do_atomically` frames the ops between batch begin/commit records, and
replay drops uncommitted batches and torn tails.

The port's copy of lighthouse_tpu/store/native_kv.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from .kv import KeyValueStore

_PKG = Path(__file__).resolve().parents[1]  # lighthouse_tpu_torch/
_SRC = _PKG / "native" / "kvstore.cc"
# built at first use beside the kernels, one directory per source hash
BUILD_ROOT = _PKG.parent / "build" / "native"
_BUILD_LOCK = threading.Lock()
_LIB = None


class NativeBuildError(RuntimeError):
    """The native store library could not be built or loaded (no g++, a
    compile failure, a library the loader refuses). Nothing falls back to
    another store."""


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest / "libkvstore.so"


def _build_lib() -> str:
    with _BUILD_LOCK:
        so = _lib_path()
        if so.exists():
            return str(so)
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
        try:
            # lint: allow[blocking-under-lock] -- the build lock exists to
            # serialize exactly this one-time g++ compile; every later call
            # finds the library of this source hash
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed ({proc.returncode}) on {_SRC}: {proc.stderr[-2000:]}"
            )
        # concurrent builders (other processes) each rename a whole file
        os.replace(tmp, so)
        return str(so)


# key pointer MUST be c_void_p: c_char_p would NUL-truncate before
# string_at reads the full length (keys are 32-byte roots full of NULs)
_KEY_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(_build_lib())
    except OSError as e:
        raise NativeBuildError(f"the native store library did not load: {e}") from e
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [ctypes.c_char_p]
    lib.kv_close.argtypes = [ctypes.c_void_p]
    sz = ctypes.c_size_t
    buf = ctypes.c_char_p
    lib.kv_put.argtypes = [ctypes.c_void_p, buf, sz, buf, sz, buf, sz]
    lib.kv_delete.argtypes = [ctypes.c_void_p, buf, sz, buf, sz]
    lib.kv_get.restype = ctypes.c_long
    lib.kv_get.argtypes = [
        ctypes.c_void_p, buf, sz, buf, sz, ctypes.c_char_p, sz,
    ]
    lib.kv_batch_begin.argtypes = [ctypes.c_void_p]
    lib.kv_batch_put.argtypes = [ctypes.c_void_p, buf, sz, buf, sz, buf, sz]
    lib.kv_batch_delete.argtypes = [ctypes.c_void_p, buf, sz, buf, sz]
    lib.kv_batch_commit.argtypes = [ctypes.c_void_p]
    lib.kv_keys.argtypes = [ctypes.c_void_p, buf, sz, _KEY_CB, ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_len.restype = ctypes.c_size_t
    lib.kv_len.argtypes = [ctypes.c_void_p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.kv_recovery_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
    _LIB = lib
    return lib


class NativeStore(KeyValueStore):
    """C++ log-structured store; one file per database."""

    def __init__(self, path: str):
        lib = _load()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lib = lib
        self._db = lib.kv_open(path.encode())
        if not self._db:
            raise OSError(f"kv_open failed for {path}")
        self._lock = threading.Lock()
        # surface the C++ log's open-time recovery outcomes into the
        # shared metrics registry (the python-WAL counters' native twin)
        self.recovery_stats = self._read_recovery_stats()
        from ..utils import metrics as M

        M.STORE_NATIVE_REPLAYED.inc(self.recovery_stats["replayed_batches"])
        M.STORE_NATIVE_ROLLED_BACK.inc(
            self.recovery_stats["rolled_back_batches"]
        )
        M.STORE_NATIVE_TRUNCATED.inc(self.recovery_stats["truncated_bytes"])

    def _read_recovery_stats(self) -> dict:
        replayed = ctypes.c_uint64()
        rolled_back = ctypes.c_uint64()
        truncated = ctypes.c_uint64()
        self._lib.kv_recovery_stats(
            self._db,
            ctypes.byref(replayed),
            ctypes.byref(rolled_back),
            ctypes.byref(truncated),
        )
        return {
            "replayed_batches": int(replayed.value),
            "rolled_back_batches": int(rolled_back.value),
            "truncated_bytes": int(truncated.value),
        }

    def close(self) -> None:
        with self._lock:
            if self._db:
                self._lib.kv_close(self._db)
                self._db = None

    def _handle(self):
        """The live C handle; raises (instead of letting the C side
        dereference NULL -> SIGSEGV) once the store is closed."""
        if self._db is None:
            raise OSError("store is closed")
        return self._db

    def get(self, column: bytes, key: bytes) -> bytes | None:
        with self._lock:
            n = self._lib.kv_get(
                self._handle(), column, len(column), key, len(key), None, 0
            )
            if n < 0:
                return None
            out = ctypes.create_string_buffer(n)
            self._lib.kv_get(
                self._handle(), column, len(column), key, len(key), out, n
            )
            return out.raw

    def put(self, column: bytes, key: bytes, value: bytes) -> None:
        value = bytes(value)
        with self._lock:
            self._lib.kv_put(
                self._handle(), column, len(column), key, len(key), value, len(value)
            )

    def delete(self, column: bytes, key: bytes) -> None:
        with self._lock:
            self._lib.kv_delete(self._handle(), column, len(column), key, len(key))

    def keys(self, column: bytes):
        out: list[bytes] = []

        @_KEY_CB
        def cb(ptr, n, _ctx):
            out.append(ctypes.string_at(ptr, n))

        with self._lock:
            self._lib.kv_keys(self._handle(), column, len(column), cb, None)
        return out

    def do_atomically(self, ops) -> None:
        """All-or-nothing batch: one commit record, one disk barrier.

        Ops are validated/converted BEFORE the BATCH_BEGIN record is
        written: a mid-batch exception would otherwise leave an
        unterminated batch marker that replay treats as the start of an
        uncommitted region, truncating every later write on reopen."""
        converted = []
        for op, column, key, value in ops:
            if op == "put":
                converted.append((op, bytes(column), bytes(key), bytes(value)))
            elif op == "delete":
                converted.append((op, bytes(column), bytes(key), None))
            else:
                raise ValueError(f"unknown batch op {op!r}")
        with self._lock:
            self._lib.kv_batch_begin(self._handle())
            for op, column, key, value in converted:
                if op == "put":
                    self._lib.kv_batch_put(
                        self._handle(), column, len(column), key, len(key),
                        value, len(value),
                    )
                else:
                    self._lib.kv_batch_delete(
                        self._handle(), column, len(column), key, len(key)
                    )
            self._lib.kv_batch_commit(self._handle())

    def compact(self) -> None:
        with self._lock:
            rc = self._lib.kv_compact(self._handle())
            if rc == -2:
                # the log handle could not be reopened: nothing further
                # can be persisted, fail loudly rather than corrupt
                self._lib.kv_close(self._handle())
                self._db = None
                raise OSError("kv_compact lost the log handle; store closed")
            if rc != 0:
                raise OSError("kv_compact failed")

    def __len__(self) -> int:
        with self._lock:
            return self._lib.kv_len(self._handle())

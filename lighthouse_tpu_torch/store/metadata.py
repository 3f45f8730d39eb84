"""Database schema metadata + migrations (reference
beacon_node/store/src/metadata.rs CURRENT_SCHEMA_VERSION/SchemaVersion
and beacon_chain/src/schema_change.rs migrate_schema).

The on-disk schema carries a version stamp in the chain column. On open:

- a fresh database is stamped with the current version;
- an up-to-date database passes through;
- an OLDER database runs the registered per-step migrations in order.
  Each step builds its rewrite as a single op list and commits it in ONE
  atomic batch TOGETHER WITH the new version stamp (mirroring
  schema_change.rs's per-version match arms over a leveldb write-batch):
  a crash anywhere inside a step either replays the whole step from the
  write-ahead journal on reopen or rolls it back entirely — the stamp
  can never run ahead of (or lag) the rewrite it describes;
- a NEWER database refuses to open (downgrades are not supported --
  metadata.rs returns SchemaVersionError and the reference node exits).

Schema history:
  v1 -- blocks stored as raw SSZ with the fork resolved from slot order
        (the pre-multi-fork layout).
  v2 -- blocks stored fork-prefixed (`<fork>\\x00<ssz>`), letting the
        store decode any-fork blocks without a spec lookup (the current
        layout, hot_cold.py put_block).

The port's copy of lighthouse_tpu/store/metadata.py.
"""

from __future__ import annotations

from .kv import Column

CURRENT_SCHEMA_VERSION = 2
SCHEMA_VERSION_KEY = b"schema_version"

_KNOWN_FORKS = (b"phase0", b"altair", b"bellatrix")


class SchemaVersionError(RuntimeError):
    pass


def get_schema_version(kv) -> int | None:
    raw = kv.get(Column.CHAIN, SCHEMA_VERSION_KEY)
    return int.from_bytes(raw, "little") if raw is not None else None


def set_schema_version(kv, version: int) -> None:
    kv.put(Column.CHAIN, SCHEMA_VERSION_KEY, version.to_bytes(8, "little"))


def _migrate_v1_to_v2(kv, preset) -> list:
    """Fork-prefix every stored block. v1 rows hold bare SSZ; phase0 is
    the only fork that ever shipped v1 databases, so the prefix is
    constant -- the rewrite is idempotent (already-prefixed rows are
    left alone, making a crashed half-migration safe to re-run).

    Returns the rewrite as batch ops; ensure_schema commits them
    atomically together with the version stamp."""
    ops = []
    for column in (Column.BLOCK, Column.FREEZER_BLOCK):
        for key in list(kv.keys(column)):
            data = kv.get(column, key)
            if data is None or data.split(b"\x00", 1)[0] in _KNOWN_FORKS:
                continue  # already v2
            ops.append(("put", column, key, b"phase0\x00" + data))
    return ops


MIGRATIONS = {
    (1, 2): _migrate_v1_to_v2,
}


def ensure_schema(kv, preset) -> list:
    """Open-time check-and-migrate. Returns the list of applied steps
    (empty for fresh/up-to-date databases)."""
    version = get_schema_version(kv)
    if version is None:
        # fresh database: stamp through the journal like every other
        # open-path write — the crash matrix tears arbitrary ops, and a
        # half-written stamp must roll back, not read as a short int
        kv.do_atomically([
            ("put", Column.CHAIN, SCHEMA_VERSION_KEY,
             CURRENT_SCHEMA_VERSION.to_bytes(8, "little")),
        ])
        return []
    if version == CURRENT_SCHEMA_VERSION:
        return []
    if version > CURRENT_SCHEMA_VERSION:
        raise SchemaVersionError(
            f"database schema v{version} is newer than this build's "
            f"v{CURRENT_SCHEMA_VERSION}; downgrades are not supported"
        )
    applied = []
    while version < CURRENT_SCHEMA_VERSION:
        step = (version, version + 1)
        migration = MIGRATIONS.get(step)
        if migration is None:
            raise SchemaVersionError(
                f"no migration registered for schema v{step[0]} -> v{step[1]}"
            )
        ops = list(migration(kv, preset))
        version += 1
        # rewrite + version stamp commit as ONE atomic batch: a crash
        # between them is impossible at the logical level, and a crash
        # inside the batch replays or rolls back on reopen
        ops.append(
            ("put", Column.CHAIN, SCHEMA_VERSION_KEY,
             version.to_bytes(8, "little"))
        )
        kv.do_atomically(ops)
        applied.append(step)
    return applied

"""Store consistency checker (`python -m lighthouse_tpu.cli db fsck`;
the seat of `lighthouse db inspect`/database_manager sanity tooling).

Walks the cross-key invariants that the write-ahead journal is supposed
to preserve — the ones a torn multi-key mutation would break:

* no orphaned write-ahead journal row (open-time recovery removes it);
* the schema version stamp is present and known;
* `split_slot` agrees with the freezer: the chunked block-root vector is
  contiguous over the frozen range (no holes below the split);
* restore points exist at `slots_per_restore_point` stride below the
  `restore_points_to` high-water mark;
* frozen blocks and restore-point states actually DECODE (not just key
  contiguity): a torn or bit-rotted freezer row would otherwise surface
  only when a historical replay trips over it;
* the head pointer resolves: `head_block_root` has a post-state mapping,
  `head_state_root` matches it, and the state row (full or summary) is
  actually present;
* the finalized pointer resolves to a stored block (or the genesis
  header's post-state mapping).

Outcomes are counted in utils.metrics (`store_fsck_runs_total`,
`store_fsck_issues_total`); the CLI exits non-zero when any issue is
found.

The port's copy of lighthouse_tpu/store/fsck.py.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .hot_cold import CHUNK_SIZE, chunk_root_in_row
from .kv import JOURNAL_KEY, Column, slot_key
from .metadata import CURRENT_SCHEMA_VERSION, get_schema_version


@dataclass(frozen=True)
class FsckIssue:
    check: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.detail}"


def run_fsck(db) -> list[FsckIssue]:
    """Check `db` (a HotColdDB); returns [] when clean."""
    from ..utils import metrics as M

    issues: list[FsckIssue] = []
    kv = db.kv

    # -- journal -------------------------------------------------------------
    if kv.get(Column.JOURNAL, JOURNAL_KEY) is not None:
        issues.append(
            FsckIssue(
                "journal",
                "orphaned write-ahead journal present (open-time recovery "
                "did not run, or a batch is mid-commit)",
            )
        )

    # -- schema --------------------------------------------------------------
    version = get_schema_version(kv)
    if version is None:
        issues.append(FsckIssue("schema", "no schema version stamp"))
    elif version != CURRENT_SCHEMA_VERSION:
        issues.append(
            FsckIssue(
                "schema",
                f"on-disk schema v{version} != current "
                f"v{CURRENT_SCHEMA_VERSION} after open",
            )
        )

    # -- split vs freezer contiguity ----------------------------------------
    # the chain's history floor: checkpoint-sync nodes hold nothing below
    # their anchor, so contiguity is only owed from there
    lo = 0
    meta = db.get_chain_item(b"oldest_block_meta")
    if meta is not None:
        lo = int.from_bytes(meta[:8], "little")
    # walk the 128-slot chunk rows directly (one get per row) instead of
    # db.cold_block_root_at_slot per slot, which would re-fetch each row
    # 128 times — on FileStore that is one file open per frozen slot
    holes = []
    split = db.split_slot
    for cindex in range(lo // CHUNK_SIZE, (split + CHUNK_SIZE - 1) // CHUNK_SIZE):
        row = kv.get(Column.FREEZER_BLOCK_ROOTS, struct.pack(">Q", cindex))
        base = cindex * CHUNK_SIZE
        for slot in range(max(lo, base), min(split, base + CHUNK_SIZE)):
            if chunk_root_in_row(row, slot) is None:
                holes.append(slot)
    if holes:
        issues.append(
            FsckIssue(
                "block-roots",
                f"{len(holes)} hole(s) in the frozen block-root vector "
                f"below split_slot {db.split_slot}, first at slot {holes[0]}",
            )
        )

    # -- restore points at stride -------------------------------------------
    marker = db.get_chain_item(b"restore_points_to")
    if marker is not None:
        upto = struct.unpack(">Q", marker)[0]
        stored_spr = db.get_chain_item(b"slots_per_restore_point")
        spr = (
            struct.unpack(">Q", stored_spr)[0]
            if stored_spr
            else db.slots_per_restore_point
        )
        missing = [
            slot
            for slot in range(lo + (-lo % spr), upto, spr)
            if kv.get(Column.FREEZER_STATE, slot_key(slot)) is None
        ]
        if missing:
            issues.append(
                FsckIssue(
                    "restore-points",
                    f"{len(missing)} restore point(s) missing below "
                    f"restore_points_to {upto} (stride {spr}), first at "
                    f"slot {missing[0]}",
                )
            )

    # -- freezer decodability -----------------------------------------------
    # key contiguity is not enough: a frozen row can exist and still be
    # garbage (torn native-log tail, bit rot). Decode every frozen block
    # and every restore-point state; the crash-recovery scenario runs this
    # after every reopen.
    bad_blocks = []
    for root in kv.keys(Column.FREEZER_BLOCK):
        try:
            blk = db._decode_stored_block(kv.get(Column.FREEZER_BLOCK, root))
            if bytes(blk.message.tree_hash_root()) != bytes(root):
                raise ValueError("stored block does not match its key root")
        except (ValueError, KeyError, IndexError, struct.error):
            bad_blocks.append(bytes(root))
    if bad_blocks:
        issues.append(
            FsckIssue(
                "freezer-decode",
                f"{len(bad_blocks)} frozen block(s) fail to decode, first "
                f"{bad_blocks[0].hex()[:12]}",
            )
        )
    bad_states = []
    for key in kv.keys(Column.FREEZER_STATE):
        try:
            db.decode_stored_state(kv.get(Column.FREEZER_STATE, key))
        except (ValueError, KeyError, IndexError, struct.error):
            bad_states.append(struct.unpack(">Q", key)[0])
    if bad_states:
        issues.append(
            FsckIssue(
                "freezer-decode",
                f"{len(bad_states)} restore-point state(s) fail to decode, "
                f"first at slot {bad_states[0]}",
            )
        )

    # -- head pointer --------------------------------------------------------
    head = db.get_chain_item(b"head_block_root")
    head_state = db.get_chain_item(b"head_state_root")
    if head is not None:
        mapped = db.get_chain_item(b"block_post_state:" + head)
        if mapped is None:
            issues.append(
                FsckIssue(
                    "head",
                    f"head_block_root {head.hex()[:12]} has no post-state "
                    "mapping",
                )
            )
        else:
            if head_state is not None and head_state != mapped:
                issues.append(
                    FsckIssue(
                        "head",
                        "head_state_root disagrees with the head block's "
                        "post-state mapping",
                    )
                )
            if (
                kv.get(Column.STATE, mapped) is None
                and kv.get(Column.STATE_SUMMARY, mapped) is None
            ):
                issues.append(
                    FsckIssue(
                        "head",
                        f"head state {mapped.hex()[:12]} is stored neither "
                        "full nor as a summary",
                    )
                )

    # -- finalized pointer ---------------------------------------------------
    fin = db.get_chain_item(b"finalized_block_root")
    if fin is not None and db.get_block_any_temperature(fin) is None:
        # the genesis "block" is a header, not a stored block: its
        # post-state mapping is the resolution path (hot_cold.get_state)
        if db.get_chain_item(b"block_post_state:" + fin) is None:
            issues.append(
                FsckIssue(
                    "finalized",
                    f"finalized_block_root {fin.hex()[:12]} resolves to no "
                    "stored block",
                )
            )

    M.STORE_FSCK_RUNS.inc()
    if issues:
        M.STORE_FSCK_FAILURES.inc(len(issues))
    return issues

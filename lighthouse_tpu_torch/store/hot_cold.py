"""Hot/cold database (reference beacon_node/store/src/hot_cold_store.rs:48):
hot side stores recent blocks + periodic full states with per-block
summaries; the freezer keeps finalized history as restore points. States
between snapshots/restore points are rebuilt by block replay
(reference reconstruct.rs / BlockReplayer).

The port's copy of lighthouse_tpu/store/hot_cold.py.
"""

from __future__ import annotations

import struct
import threading

from ..ssz import cached_root as cached_root_of
from ..state_transition import BlockReplayer, clone_state, process_slots
from ..types import compute_epoch_at_slot, state_class_for, types_for
from ..types.presets import Preset
from .kv import AtomicBatch, Column, KeyValueStore, recover_journal, slot_key


class StoreError(KeyError):
    pass


def latest_block_header_root(state, state_root: bytes) -> bytes:
    """Root of the last applied block: the state's latest header with its
    state_root filled when still zeroed (a post-block state's header has
    it zeroed until the next process_slot; the block's state_root IS that
    state's root)."""
    from ..types.containers import BeaconBlockHeader

    hdr = state.latest_block_header
    return BeaconBlockHeader(
        slot=hdr.slot,
        proposer_index=hdr.proposer_index,
        parent_root=bytes(hdr.parent_root),
        state_root=(
            bytes(hdr.state_root)
            if any(bytes(hdr.state_root))
            else state_root
        ),
        body_root=bytes(hdr.body_root),
    ).tree_hash_root()


CHUNK_SIZE = 128  # roots per freezer chunk row (chunked_vector.rs: 4K pages)


def chunk_root_in_row(row: bytes | None, slot: int) -> bytes | None:
    """Decode `slot`'s 32-byte root from its chunk row. None means absent:
    no row, a row too short to cover the slot, or the all-zero unwritten
    sentinel. The ONE place chunk framing is interpreted — _chunk_get,
    _ChunkWriter.root_at, and fsck's contiguity walk all read through it."""
    if row is None:
        return None
    offset = (slot % CHUNK_SIZE) * 32
    if len(row) < offset + 32:
        return None
    root = bytes(row[offset : offset + 32])
    return root if any(root) else None


class _ChunkWriter:
    """Buffers chunked-column writes so a migration touches each 4K chunk
    row once instead of read-modify-writing it per slot. Doubles as the
    read-through overlay for an atomic migration batch: `root_at` sees
    staged rows before they commit, so later migration phases (restore
    points) can read the root vectors the same batch is about to write."""

    def __init__(self, kv: KeyValueStore):
        self.kv = kv
        self.rows: dict[tuple[bytes, int], bytearray] = {}

    def put(self, column: bytes, slot: int, root: bytes) -> None:
        cindex = slot // CHUNK_SIZE
        key = (column, cindex)
        row = self.rows.get(key)
        if row is None:
            row = bytearray(
                self.kv.get(column, struct.pack(">Q", cindex)) or b""
            )
            self.rows[key] = row
        offset = (slot % CHUNK_SIZE) * 32
        if len(row) < offset + 32:
            row.extend(bytes(offset + 32 - len(row)))
        row[offset : offset + 32] = root

    def root_at(self, column: bytes, slot: int) -> bytes | None:
        """Staged-or-stored read of one root (the overlay view)."""
        cindex = slot // CHUNK_SIZE
        row = self.rows.get((column, cindex))
        if row is None:
            row = self.kv.get(column, struct.pack(">Q", cindex))
        elif not isinstance(row, bytes):
            row = bytes(row)
        return chunk_root_in_row(row, slot)

    def flush(self) -> None:
        for (column, cindex), row in self.rows.items():
            self.kv.put(column, struct.pack(">Q", cindex), bytes(row))
        self.rows.clear()

    def flush_into(self, batch: AtomicBatch) -> None:
        """Stage the buffered rows on `batch` instead of writing them."""
        for (column, cindex), row in self.rows.items():
            batch.stage(column, struct.pack(">Q", cindex), bytes(row))
        self.rows.clear()


class HotColdDB:
    def __init__(
        self,
        kv: KeyValueStore,
        preset: Preset,
        spec,
        slots_per_snapshot: int | None = None,
        slots_per_restore_point: int | None = None,
        migration_chunk_slots: int | None = None,
    ):
        self.kv = kv
        self.preset = preset
        self.spec = spec
        # hot snapshot cadence: every epoch by default
        self.slots_per_snapshot = slots_per_snapshot or preset.slots_per_epoch
        # freezer restore-point cadence (hot_cold_store.rs StoreConfig
        # slots_per_restore_point): full states in the cold DB at this
        # interval; states between are rebuilt by replaying <= this many
        # slots of frozen blocks
        self.slots_per_restore_point = (
            slots_per_restore_point or 4 * preset.slots_per_epoch
        )
        # hot->cold migration commits in journaled sub-batches of this
        # many slots (the long-non-finality memory bound: a multi-epoch
        # finality jump must not stage the whole range in one batch)
        self.migration_chunk_slots = migration_chunk_slots or 2 * CHUNK_SIZE
        # serializes multi-batch freezer mutations (migrate_to_freezer,
        # reconstruct_historic_states, prune_payloads) across threads:
        # kv.do_atomically makes each BATCH atomic, but the
        # restore_points_to marker is read-modify-written across a long
        # scan, and an HTTP-thread reconstruct racing a chain-thread
        # migration could commit a stale smaller marker over a fresh one
        self._mutation_lock = threading.Lock()
        # write-ahead journal recovery FIRST (an interrupted batch from
        # the previous process must replay or roll back before anything
        # reads the store), then the schema stamp + open-time migrations
        # (metadata.rs, schema_change.rs); refuses newer-schema databases
        self.journal_recovery = recover_journal(kv)
        from .metadata import ensure_schema

        self.schema_migrations_applied = ensure_schema(kv, preset)
        # hot/cold boundary (advances on finality); restored on reopen so
        # restarted nodes neither re-freeze nor clobber recorded history
        stored_split = kv.get(Column.CHAIN, b"split_slot")
        self.split_slot = (
            struct.unpack(">Q", stored_split)[0] if stored_split else 0
        )
        stored_fill = kv.get(Column.CHAIN, b"state_roots_filled_to")
        self._state_roots_filled_to = (
            struct.unpack(">Q", stored_fill)[0] if stored_fill else 0
        )

    # -- atomic batches ------------------------------------------------------

    def batch(self) -> AtomicBatch:
        """A staged multi-key mutation over this store's kv; commit()
        applies it all-or-nothing through the write-ahead journal."""
        return AtomicBatch(self.kv)

    # -- blocks --------------------------------------------------------------

    def put_block(self, block_root: bytes, signed_block, batch=None) -> None:
        fork = type(signed_block).fork_name
        payload = fork.encode() + b"\x00" + signed_block.as_ssz_bytes()
        if batch is not None:
            batch.stage(Column.BLOCK, block_root, payload)
        else:
            self.kv.put(Column.BLOCK, block_root, payload)

    def _decode_stored_block(self, data: bytes):
        fork, _, body = data.partition(b"\x00")
        t = types_for(self.preset)
        if fork == b"bellatrix_blinded":
            # payload pruned to its header (root-identical to the full
            # block; database_manager prune-payloads)
            return t.SignedBlindedBeaconBlock.from_ssz_bytes(body)
        from ..types import block_classes_for

        _, signed_cls, _ = block_classes_for(t, fork.decode())
        return signed_cls.from_ssz_bytes(body)

    def get_block(self, block_root: bytes):
        data = self.kv.get(Column.BLOCK, block_root)
        if data is None:
            return None
        return self._decode_stored_block(data)

    # -- states --------------------------------------------------------------

    def put_state(self, state_root: bytes, state, batch=None) -> None:
        """Full state at snapshot cadence; otherwise a summary pointing to
        the previous snapshot (hot_cold_store.rs stores per-slot summaries
        + periodic full states the same way). The state row and its
        slot-index row commit together: without a `batch` a private one
        is committed here, so a crash can never index an absent state."""
        sink = batch if batch is not None else self.batch()
        if state.slot % self.slots_per_snapshot == 0:
            payload = (
                b"F" + state.fork_name.encode() + b"\x00" + state.as_ssz_bytes()
            )
            sink.stage(Column.STATE, state_root, payload)
        else:
            block_root = latest_block_header_root(state, state_root)
            summary = struct.pack(">Q", state.slot) + block_root
            sink.stage(Column.STATE_SUMMARY, state_root, summary)
        sink.stage_chain_item(
            b"state_at_slot:" + slot_key(state.slot), state_root
        )
        if batch is None:
            sink.commit()

    def decode_stored_state(self, data: bytes):
        """Decode a stored full-state payload (b"F" + fork + NUL + ssz):
        the ONE place the framing is interpreted — hot snapshots, frozen
        restore points, and fsck's decodability walk all read through it.
        Raises ValueError-family errors on a torn/corrupt payload."""
        if not data or data[:1] != b"F":
            raise ValueError("not a full-state payload")
        fork, _, body = data[1:].partition(b"\x00")
        t = types_for(self.preset)
        cls = state_class_for(t, fork.decode())
        return cls.from_ssz_bytes(body)

    def get_full_state(self, state_root: bytes):
        data = self.kv.get(Column.STATE, state_root)
        if data is None:
            return None
        return self.decode_stored_state(data)

    def get_state(self, state_root: bytes, blocks_by_root=None):
        """Load a state, replaying blocks from the nearest stored snapshot
        when only a summary exists. `blocks_by_root(root)` resolves blocks
        (defaults to this store)."""
        full = self.get_full_state(state_root)
        if full is not None:
            return full
        summary = self.kv.get(Column.STATE_SUMMARY, state_root)
        if summary is None:
            raise StoreError(f"unknown state {state_root.hex()[:12]}")
        (slot,) = struct.unpack(">Q", summary[:8])
        block_root = summary[8:]
        # replay may start below the hot/cold split (a non-finalized state
        # whose snapshot ancestor was migrated): resolve blocks from either
        # temperature
        get_block = blocks_by_root or self.get_block_any_temperature

        # walk back through blocks until one whose POST-state is stored full
        chain = []
        root = block_root
        base_state = None
        while True:
            block = get_block(root)
            if block is None:
                # the genesis "block" is a header, not a stored block: its
                # post-state mapping is recorded at chain init
                mapped = self.get_chain_item(b"block_post_state:" + root)
                if mapped is not None:
                    base_state = self.get_full_state(mapped)
                    if base_state is not None:
                        break
                raise StoreError(f"missing block {root.hex()[:12]} for replay")
            post_state_root = bytes(block.message.state_root)
            base_state = self.get_full_state(post_state_root)
            if base_state is not None:
                break  # replay starts AFTER this block
            chain.append(block)
            root = bytes(block.message.parent_root)

        chain.reverse()
        replayer = BlockReplayer(base_state, self.preset, self.spec)
        replayer.apply_blocks(chain, target_slot=slot)
        return replayer.state

    # -- chain metadata ------------------------------------------------------

    def put_chain_item(self, key: bytes, value: bytes) -> None:
        self.kv.put(Column.CHAIN, key, value)

    def delete_chain_item(self, key: bytes) -> None:
        self.kv.delete(Column.CHAIN, key)

    def get_chain_item(self, key: bytes) -> bytes | None:
        return self.kv.get(Column.CHAIN, key)

    # -- freezer chunked root vectors (store/src/chunked_vector.rs) ---------
    #
    # block_roots/state_roots live ONCE in the cold DB as 128-entry chunk
    # rows keyed by chunk index, instead of duplicated in every frozen
    # state. vindex == absolute slot; cindex == slot // CHUNK_SIZE.

    def _chunk_put(self, column: bytes, slot: int, root: bytes) -> None:
        w = _ChunkWriter(self.kv)
        w.put(column, slot, root)
        w.flush()

    def _chunk_get(self, column: bytes, slot: int) -> bytes | None:
        row = self.kv.get(column, struct.pack(">Q", slot // CHUNK_SIZE))
        return chunk_root_in_row(row, slot)

    def cold_block_root_at_slot(self, slot: int) -> bytes | None:
        return self._chunk_get(Column.FREEZER_BLOCK_ROOTS, slot)

    def cold_state_root_at_slot(self, slot: int) -> bytes | None:
        return self._chunk_get(Column.FREEZER_STATE_ROOTS, slot)

    # -- freezer migration (hot_cold_store.rs:48-53 + migrate.rs) -----------

    def migrate_to_freezer(
        self,
        finalized_slot: int,
        canonical_roots,
        finalized_state=None,
        finalized_block_root: bytes | None = None,
    ) -> None:
        """Move finalized blocks to the freezer column and advance the
        split point; prune non-canonical hot entries older than the split.
        `canonical_roots`: {block_root} on the finalized chain.

        With `finalized_state` (the finalized block's post-state) the
        freezer also records the migrated range's per-slot block/state
        roots into the chunked columns and stores restore-point states at
        slots_per_restore_point cadence — historical loads then cost at
        most one restore-point read + a bounded block replay
        (hot_cold_store.rs store_cold_state/load_cold_state).

        The migration commits through the write-ahead journal in bounded
        SUB-BATCHES (the documented single-batch memory trade-off,
        resolved): block copies + hot prunes + chunked block-root rows
        per `migration_chunk_slots`-slot window in ascending slot order,
        then the state-root rows, then one batch per missing restore
        point, and FINALLY the split-slot advance (+ stride and
        finalized-checkpoint pointers) as its own batch. Each sub-batch
        is individually atomic, and the ordering keeps every inter-batch
        crash point consistent: frozen content is only ever a superset of
        what `split_slot` claims, a hot block is pruned only after its
        freezer copy and root-row committed, and a re-run resumes
        idempotently (moved blocks are no longer hot, existing chunk rows
        win over recomputation, the restore-point sweep restarts from its
        marker). Staged memory is bounded by one window of blocks or one
        full state, never by the length of a non-finality stretch."""
        with self._mutation_lock:
            old_split = self.split_slot
            # collect the hot KEYS to move/prune ONCE, sorted by slot;
            # block payloads are re-read per window at staging time so
            # peak memory really is one window, not the whole stretch
            moves = []  # canonical: (slot, root) -> freezer
            prunes = []  # non-canonical: (slot, root) -> delete only
            for root in list(self.kv.keys(Column.BLOCK)):
                data = self.kv.get(Column.BLOCK, root)
                if data is None:
                    continue
                block = self.get_block(root)
                if block.message.slot < finalized_slot:
                    if root in canonical_roots:
                        moves.append((int(block.message.slot), bytes(root)))
                    else:
                        prunes.append(
                            (int(block.message.slot), bytes(root))
                        )
            moves.sort()
            prunes.sort()
            step = max(int(self.migration_chunk_slots), 1)
            mi = pi = 0
            lo = old_split
            while lo < finalized_slot:
                hi = min(lo + step, finalized_slot)
                batch = self.batch()
                chunks = _ChunkWriter(self.kv)
                window = []
                while mi < len(moves) and moves[mi][0] < hi:
                    slot, root = moves[mi]
                    mi += 1
                    data = self.kv.get(Column.BLOCK, root)
                    if data is None:
                        continue  # vanished since the scan (re-run overlap)
                    batch.stage(Column.FREEZER_BLOCK, root, data)
                    batch.stage_delete(Column.BLOCK, root)
                    window.append((slot, root))
                while pi < len(prunes) and prunes[pi][0] < hi:
                    batch.stage_delete(Column.BLOCK, prunes[pi][1])
                    pi += 1
                self._freeze_block_roots(lo, hi, window, chunks)
                chunks.flush_into(batch)
                batch.commit()
                lo = hi
            if finalized_state is not None:
                batch = self.batch()
                chunks = _ChunkWriter(self.kv)
                filled_to = self._freeze_state_roots(
                    finalized_slot, finalized_state, chunks, batch
                )
                chunks.flush_into(batch)
                batch.commit()
                self._state_roots_filled_to = filled_to
            self._sweep_restore_points(finalized_slot)
            # the split-slot advance is the LAST batch: a crash anywhere
            # above leaves the old split naming only content that exists.
            # Values are staged only when they CHANGE — finality triggers
            # a migrate call per import, and a no-advance repeat must not
            # journal an identical marker batch every slot.
            batch = self.batch()
            markers = [
                (b"split_slot", struct.pack(">Q", finalized_slot)),
                (
                    b"slots_per_restore_point",
                    struct.pack(">Q", self.slots_per_restore_point),
                ),
            ]
            if finalized_block_root is not None:
                markers.append(
                    (b"finalized_block_root", bytes(finalized_block_root))
                )
            for key, value in markers:
                if self.get_chain_item(key) != value:
                    batch.stage_chain_item(key, value)
            batch.commit()
            # in-memory mirrors advance only AFTER the batch is durable,
            # so a commit-time crash leaves this object consistent with
            # the disk
            self.split_slot = finalized_slot

    def _freeze_block_roots(self, lo: int, hi: int, migrated, chunks) -> None:
        """Per-slot block roots for the window [lo, hi) from the migrated
        canonical blocks themselves (ring semantics: an empty slot repeats
        the previous block's root) — coverage never depends on any state's
        ring buffer, so long non-finality cannot punch holes. Rows are
        staged on the shared `chunks` overlay; the window batch flushes
        them. An EXISTING stored root wins over recomputation and becomes
        the running `prev`: a re-run over a window a crashed migration
        already committed (whose hot blocks are gone, so `migrated` no
        longer names them) must keep the recorded canonical roots instead
        of smearing a stale predecessor over them."""
        migrated.sort()
        cursor = 0
        prev = (
            chunks.root_at(Column.FREEZER_BLOCK_ROOTS, lo - 1)
            if lo
            else None
        )
        row_cache: dict[int, bytes | None] = {}

        def existing_root(slot: int) -> bytes | None:
            # one kv read per 128-slot chunk row, not one per slot
            cindex = slot // CHUNK_SIZE
            staged = chunks.rows.get((Column.FREEZER_BLOCK_ROOTS, cindex))
            if staged is not None:
                return chunk_root_in_row(bytes(staged), slot)
            if cindex not in row_cache:
                row_cache[cindex] = self.kv.get(
                    Column.FREEZER_BLOCK_ROOTS, struct.pack(">Q", cindex)
                )
            return chunk_root_in_row(row_cache[cindex], slot)

        for slot in range(lo, hi):
            while cursor < len(migrated) and migrated[cursor][0] <= slot:
                prev = migrated[cursor][1]
                cursor += 1
            stored = existing_root(slot)
            if stored is not None:
                prev = stored
                continue
            if prev is None:
                # before the first canonical block: slot 0's "block" is the
                # genesis header, recorded at chain init. Databases that
                # predate that item fall back to the backfill anchor (for
                # genesis-start chains it IS the genesis root; checkpoint
                # chains have no served history below the anchor anyway).
                prev = self.get_chain_item(
                    b"genesis_block_root"
                ) or self.get_chain_item(b"oldest_block_root")
                if prev is None:
                    continue
            chunks.put(Column.FREEZER_BLOCK_ROOTS, slot, prev)

    def _freeze_state_roots(
        self, finalized_slot: int, finalized_state, chunks, batch
    ) -> int:
        """State roots from the finalized state's ring, tracked by a
        persisted low-water mark: a finalized epoch that starts with empty
        slots leaves the tail unmaterialized this round, and the NEXT
        migration backfills it from a later ring (those state roots exist
        in any state that advanced past the gap).

        If finality ever jumps by more than the ring (non-finality longer
        than slots_per_historical_root), the stretch the ring cannot cover
        is patched from the canonical frozen blocks themselves: a block's
        state_root IS the state root at its slot. Only empty slots inside
        such a stretch stay unrecorded (their states were never part of
        any block), and the state-roots iterator raises for them.

        Stages rows on `chunks` / items on `batch`; returns the new
        low-water mark for the caller to adopt after commit."""
        ring = self.preset.slots_per_historical_root
        covered = min(finalized_slot, int(finalized_state.slot))
        lo = max(self._state_roots_filled_to, covered - ring)
        for slot in range(self._state_roots_filled_to, lo):
            root = chunks.root_at(Column.FREEZER_BLOCK_ROOTS, slot)
            if root is None:
                continue
            if slot and root == chunks.root_at(
                Column.FREEZER_BLOCK_ROOTS, slot - 1
            ):
                continue  # empty slot: no block-anchored state root
            block = self.get_block_any_temperature(root)
            if block is not None and int(block.message.slot) == slot:
                chunks.put(
                    Column.FREEZER_STATE_ROOTS,
                    slot,
                    bytes(block.message.state_root),
                )
        for slot in range(lo, covered):
            chunks.put(
                Column.FREEZER_STATE_ROOTS,
                slot,
                bytes(finalized_state.state_roots[slot % ring]),
            )
        if covered > self._state_roots_filled_to:
            batch.stage_chain_item(
                b"state_roots_filled_to", struct.pack(">Q", covered)
            )
            return covered
        return self._state_roots_filled_to

    def _store_restore_points(
        self, finalized_slot: int, chunks, batch, scan_from: int | None = None
    ) -> None:
        """Full states at restore-point cadence, loaded strictly by the
        AUTHORITATIVE root from the chunked column — never by the
        last-writer-wins state_at_slot index, which can name a
        non-canonical fork's state. Roots come through the `chunks`
        overlay (the same batch may have just staged them); the state
        payloads and the high-water marker are staged on `batch`.

        The scan starts at the earliest restore-point slot that is still
        missing (the restore_points_to marker, not the split): a slot
        skipped last round because its
        state root was in an empty-slot gap is retried once the next
        migration's ring backfill records the root. `scan_from` lets a
        caller sweeping bounded sub-ranges (http reconstruct) set the
        scan floor itself instead of rescanning from the marker every
        call — which goes quadratic when a permanently-missing state
        root pins the marker."""
        spr = self.slots_per_restore_point
        marker = 0
        stored = self.get_chain_item(b"restore_points_to")
        if stored is not None:
            marker = struct.unpack(">Q", stored)[0]
        start = marker if scan_from is None else scan_from
        all_present = True
        for slot in range(start + (-start % spr), finalized_slot, spr):
            if self.kv.get(Column.FREEZER_STATE, slot_key(slot)) is not None:
                continue
            state_root = chunks.root_at(Column.FREEZER_STATE_ROOTS, slot)
            if state_root is None:
                all_present = False
                continue
            try:
                state = self.get_state(state_root)
            except StoreError:
                all_present = False
                continue
            payload = (
                b"F" + state.fork_name.encode() + b"\x00" + state.as_ssz_bytes()
            )
            batch.stage(Column.FREEZER_STATE, slot_key(slot), payload)
        # the high-water mark means "every restore point below me exists":
        # it only advances (a bounded sweep below it must not regress it),
        # and only when this scan actually covered the ground from the
        # marker up — a sweep that began ABOVE the marker cannot vouch for
        # the gap below its floor
        if all_present and finalized_slot > marker and start <= marker:
            batch.stage_chain_item(
                b"restore_points_to", struct.pack(">Q", finalized_slot)
            )

    def _sweep_restore_points(self, upto_slot: int) -> None:
        """Store missing restore points below `upto_slot` in per-stride
        journaled batches (at most ONE rebuilt full state staged per
        commit — the migration's memory bound), starting from the
        restore_points_to marker's floor. Caller holds _mutation_lock."""
        spr = self.slots_per_restore_point
        stored = self.get_chain_item(b"restore_points_to")
        cursor = struct.unpack(">Q", stored)[0] if stored else 0
        if cursor >= upto_slot:
            return
        while True:
            upto = min(cursor + spr, upto_slot)
            batch = self.batch()
            self._store_restore_points(
                upto, _ChunkWriter(self.kv), batch, scan_from=cursor
            )
            batch.commit()
            if upto >= upto_slot:
                return
            cursor = upto

    def reconstruct_historic_states(self) -> int:
        """Fill any missing restore-point states below the split from the
        chunked columns (the reference's historic state reconstruction,
        reconstruct.rs), in bounded journaled batches: each stride
        interval commits at most one rebuilt full state plus the
        restore_points_to marker, so memory and journal size stay bounded
        however long the chain is. The sweep is idempotent — present
        points are skipped, and the marker only advances over prefixes
        verified complete — so a crash between batches resumes exactly
        where it left off. Returns the number of restore points added."""
        with self._mutation_lock:
            before = len(self.kv.keys(Column.FREEZER_STATE))
            spr = self.slots_per_restore_point
            cursor = 0
            boundary = spr
            while True:
                upto = min(boundary, self.split_slot)
                batch = self.batch()
                self._store_restore_points(
                    upto, _ChunkWriter(self.kv), batch, scan_from=cursor
                )
                batch.commit()
                cursor = upto
                if upto == self.split_slot:
                    break
                boundary += spr
            return len(self.kv.keys(Column.FREEZER_STATE)) - before

    def load_cold_state(self, slot: int):
        """Historical (pre-split) state at `slot`: nearest restore point at
        or below, then replay the frozen canonical blocks up to `slot`
        (bounded by slots_per_restore_point; reference
        hot_cold_store.rs load_cold_state_by_slot + reconstruct.rs)."""
        spr = self.slots_per_restore_point
        rp_slot = slot - slot % spr
        base = None
        while rp_slot >= 0:
            data = self.kv.get(Column.FREEZER_STATE, slot_key(rp_slot))
            if data is not None:
                base = self.decode_stored_state(data)
                break
            rp_slot -= spr
        if base is None:
            raise StoreError(f"no restore point at or below slot {slot}")
        # canonical blocks in (rp_slot, slot]: consecutive equal roots in
        # the chunked vector mean empty slots. A missing root is a REAL
        # error — silently skipping would replay a wrong chain.
        chain = []
        prev = self.cold_block_root_at_slot(rp_slot)
        if prev is None:
            raise StoreError(f"no frozen block root at restore slot {rp_slot}")
        for s in range(rp_slot + 1, slot + 1):
            r = self.cold_block_root_at_slot(s)
            if r is None:
                raise StoreError(f"no frozen block root at slot {s}")
            if r == prev:
                continue
            block = self.get_block_any_temperature(r)
            if block is None:
                raise StoreError(f"missing frozen block {r.hex()[:12]}")
            chain.append(block)
            prev = r
        replayer = BlockReplayer(base, self.preset, self.spec)
        replayer.apply_blocks(chain, target_slot=slot)
        return replayer.state

    # -- forward iterators (store/src/forwards_iter.rs) ---------------------

    def forwards_block_roots_iter(self, start_slot: int, end_slot: int, state):
        """Yield (block_root, slot) ascending over [start_slot, end_slot].
        The frozen range reads the chunked vector (FrozenForwardsIterator);
        the hot range reads `state`'s ring buffer (SimpleForwardsIterator —
        `state` must cover it, i.e. end_slot within slots_per_historical_root
        of state.slot)."""
        yield from self._forwards_iter(
            start_slot, end_slot, state, Column.FREEZER_BLOCK_ROOTS, "block_roots"
        )

    def forwards_state_roots_iter(self, start_slot: int, end_slot: int, state):
        yield from self._forwards_iter(
            start_slot, end_slot, state, Column.FREEZER_STATE_ROOTS, "state_roots"
        )

    def _forwards_iter(self, start_slot, end_slot, state, column, field):
        ring = self.preset.slots_per_historical_root
        for slot in range(start_slot, end_slot + 1):
            if slot < self.split_slot:
                root = self._chunk_get(column, slot)
                if root is None:
                    raise StoreError(f"no frozen {field} for slot {slot}")
            elif slot == state.slot:
                # the state's own slot is not in its ring buffers yet; the
                # reference computes these on demand (forwards_iter.rs)
                if field == "state_roots":
                    root = cached_root_of(state)
                else:
                    root = latest_block_header_root(
                        state, cached_root_of(state)
                    )
            elif not (state.slot - ring <= slot < state.slot):
                raise StoreError(f"slot {slot} outside hot ring")
            else:
                root = bytes(getattr(state, field)[slot % ring])
            yield root, slot

    def get_block_any_temperature(self, block_root: bytes):
        blk = self.get_block(block_root)
        if blk is not None:
            return blk
        data = self.kv.get(Column.FREEZER_BLOCK, block_root)
        if data is None:
            return None
        return self._decode_stored_block(data)

    def prune_payloads(
        self, before_slot: int | None = None, chunk_blocks: int = 128
    ) -> int:
        """Replace stored full bellatrix blocks with their BLINDED form
        (payload -> header; block roots are identical by SSZ design), like
        `lighthouse db prune-payloads` (database_manager/src/lib.rs).
        Returns the number of pruned blocks. With no explicit boundary the
        prune stops at the hot/cold split (finalized) slot — the reference
        prunes only finalized payloads, never the head's, so the node can
        still serve full blocks over req/resp and re-notify the EL.

        Commits in journaled chunks of ``chunk_blocks`` rewrites (like
        the http reconstruct sweep), so journal size and staged memory
        stay bounded however long the chain is: each individual block is
        still rewritten atomically, a crash inside a chunk recovers to
        that chunk's pre-or-post image, and a crash BETWEEN chunks leaves
        a consistent partially-pruned store the next prune resumes over
        (already-blinded blocks are skipped).

        Holds the freezer mutation lock: the prune's op list is built
        from reads of the block columns, and a concurrent migration
        committing between those reads and a chunk's commit would let
        the prune resurrect a hot row the migration just deleted."""
        with self._mutation_lock:
            return self._prune_payloads_locked(before_slot, chunk_blocks)

    def _prune_payloads_locked(
        self, before_slot: int | None, chunk_blocks: int
    ) -> int:
        from ..state_transition.per_block import payload_to_header

        if before_slot is None:
            before_slot = self.split_slot
        t = types_for(self.preset)
        pruned = 0
        batch = self.batch()
        for col in (Column.BLOCK, Column.FREEZER_BLOCK):
            for root in list(self.kv.keys(col)):
                data = self.kv.get(col, root)
                if data is None or not data.startswith(b"bellatrix\x00"):
                    continue
                signed = self._decode_stored_block(data)
                blk = signed.message
                if before_slot is not None and blk.slot >= before_slot:
                    continue
                body = blk.body
                blinded_body = t.BlindedBeaconBlockBody(
                    randao_reveal=body.randao_reveal,
                    eth1_data=body.eth1_data,
                    graffiti=body.graffiti,
                    proposer_slashings=body.proposer_slashings,
                    attester_slashings=body.attester_slashings,
                    attestations=body.attestations,
                    deposits=body.deposits,
                    voluntary_exits=body.voluntary_exits,
                    sync_aggregate=body.sync_aggregate,
                    execution_payload_header=payload_to_header(
                        body.execution_payload, self.preset
                    ),
                )
                blinded = t.BlindedBeaconBlock(
                    slot=blk.slot,
                    proposer_index=blk.proposer_index,
                    parent_root=bytes(blk.parent_root),
                    state_root=bytes(blk.state_root),
                    body=blinded_body,
                )
                if blinded.tree_hash_root() != blk.tree_hash_root():
                    # never rewrite a block under a different root (a real
                    # raise, not an assert: this must survive python -O)
                    raise RuntimeError(
                        f"pruned block root diverged for {root.hex()}"
                    )
                signed_blinded = t.SignedBlindedBeaconBlock(
                    message=blinded, signature=bytes(signed.signature)
                )
                batch.stage(
                    col,
                    root,
                    b"bellatrix_blinded\x00" + signed_blinded.as_ssz_bytes(),
                )
                pruned += 1
                if chunk_blocks and len(batch) >= chunk_blocks:
                    # per-chunk atomic commit: bounded journal, and any
                    # crash point recovers to a consistent image (no
                    # block is ever half-rewritten; a partially-pruned
                    # store is valid and resumable)
                    batch.commit()
                    batch = self.batch()
        batch.commit()
        return pruned

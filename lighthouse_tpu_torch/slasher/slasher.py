"""Slasher: detects OTHER validators' slashable messages (reference
slasher/src/: attestation/block queues batched per update (slasher.rs),
min/max-target arrays for surround detection (array.rs:22-32), double
vote and double proposal records (database.rs)).

Layout mirrors the reference's chunked design: the (validator, epoch)
min/max-target planes are stored as EPOCH_CHUNK x VALIDATOR_CHUNK numpy
tiles (16 epochs x 256 validators, array.rs:22-32), loaded on demand from
the KV layer and flushed dirty-only after each `process_queued` batch —
so validator capacity is unbounded and state survives restart
(database.rs's LMDB seat is the framework's KeyValueStore).

Detection rules:

  double vote:  same (validator, target epoch), different attestation root
  surrounds:    new (s, t) with an existing (s', t'): s < s' and t' < t
                 <=> min_target[v][s+1..] < t
  surrounded:   exists (s', t') with s' < s and t' > t
                 <=> max_target[v][..s-1] > t
  double block: same (proposer, slot), different block root

Early-exit in the running-array updates uses the arrays' monotonicity
(min_target non-decreasing in s, max_target non-decreasing in s), the
same pruning the reference applies per chunk (array.rs apply_chunk).


The port's copy of lighthouse_tpu/slasher/slasher.py.
"""

from __future__ import annotations

import struct

import numpy as np

from ..store.kv import KeyValueStore, MemoryStore
from ..types.presets import Preset

_NO_TARGET_MIN = np.iinfo(np.int64).max
_NO_TARGET_MAX = -1

EPOCH_CHUNK = 16  # epochs per tile (reference chunk_size, array.rs:22)
VALIDATOR_CHUNK = 256  # validators per tile (reference validator_chunk_size)


class SlasherColumn:
    MIN_TARGET = b"smn"
    MAX_TARGET = b"smx"
    ATT_RECORD = b"sat"
    BLOCK_RECORD = b"sbk"


def _tile_key(v_chunk: int, e_chunk: int) -> bytes:
    return struct.pack(">QQ", v_chunk, e_chunk)


def _record_key(a: int, b: int) -> bytes:
    return struct.pack(">QQ", a, b)


class _TargetPlane:
    """One chunked (validator, epoch) plane over the KV store."""

    def __init__(self, store: KeyValueStore, column: bytes, fill: int):
        self.store = store
        self.column = column
        self.fill = fill
        self.tiles: dict[tuple[int, int], np.ndarray] = {}
        self.dirty: set[tuple[int, int]] = set()

    def _tile(self, v_chunk: int, e_chunk: int) -> np.ndarray:
        key = (v_chunk, e_chunk)
        tile = self.tiles.get(key)
        if tile is None:
            raw = self.store.get(self.column, _tile_key(v_chunk, e_chunk))
            if raw is None:
                tile = np.full((VALIDATOR_CHUNK, EPOCH_CHUNK), self.fill, np.int64)
            else:
                tile = (
                    np.frombuffer(raw, np.int64)
                    .reshape(VALIDATOR_CHUNK, EPOCH_CHUNK)
                    .copy()
                )
            self.tiles[key] = tile
        return tile

    def get(self, validator: int, epoch: int) -> int:
        tile = self._tile(validator // VALIDATOR_CHUNK, epoch // EPOCH_CHUNK)
        return int(tile[validator % VALIDATOR_CHUNK, epoch % EPOCH_CHUNK])

    def update_range(self, validator: int, e_lo: int, e_hi: int, target: int, op):
        """Apply `op` (np.minimum / np.maximum) of `target` over epochs
        [e_lo, e_hi); early-exit on tiles the op leaves unchanged
        (monotonicity pruning, reference array.rs chunk updates)."""
        if e_lo >= e_hi:
            return
        v_chunk, v_off = divmod(validator, VALIDATOR_CHUNK)
        # walk tiles outward from the attestation's source epoch so the
        # monotone early-exit is sound: for np.minimum we sweep downward
        # (min_target updates [0, s]), for np.maximum upward
        chunks = range(e_lo // EPOCH_CHUNK, (e_hi - 1) // EPOCH_CHUNK + 1)
        if op is np.minimum:
            chunks = reversed(list(chunks))
        for e_chunk in chunks:
            tile = self._tile(v_chunk, e_chunk)
            lo = max(e_lo - e_chunk * EPOCH_CHUNK, 0)
            hi = min(e_hi - e_chunk * EPOCH_CHUNK, EPOCH_CHUNK)
            seg = tile[v_off, lo:hi]
            before = seg.copy()
            op(seg, target, out=seg)
            if np.array_equal(before, seg):
                # untouched tile: by monotonicity no farther tile changes
                break
            self.dirty.add((v_chunk, e_chunk))

    def flush_ops(self):
        ops = [
            ("put", self.column, _tile_key(vc, ec), self.tiles[(vc, ec)].tobytes())
            for vc, ec in self.dirty
        ]
        self.dirty.clear()
        # evict: everything just flushed is clean and reloadable on demand,
        # so resident memory stays bounded by one batch's working set
        # instead of growing to the dense (validator x epoch) planes
        self.tiles.clear()
        return ops


class Slasher:
    def __init__(
        self,
        preset: Preset,
        spec,
        store: KeyValueStore | None = None,
        history_epochs: int = 4096,
    ):
        self.preset = preset
        self.spec = spec
        self.history = history_epochs
        self.store = store if store is not None else MemoryStore()
        self.min_target = _TargetPlane(
            self.store, SlasherColumn.MIN_TARGET, _NO_TARGET_MIN
        )
        self.max_target = _TargetPlane(
            self.store, SlasherColumn.MAX_TARGET, _NO_TARGET_MAX
        )
        # write-through record caches over the KV columns
        # (validator, target_epoch) -> (att_root, ssz(indexed))
        self._att_cache: dict[tuple[int, int], tuple[bytes, bytes]] = {}
        # per-validator target index for culprit lookup
        self._targets_by_validator: dict[int, set[int]] = {}
        # (proposer, slot) -> ssz(SignedBeaconBlockHeader), write-through
        self._blk_cache: dict[bytes, bytes] = {}
        self._load_att_index()
        self.attestation_queue: list = []
        self.block_queue: list = []
        self.attester_slashings: list = []
        self.proposer_slashings: list = []

    @classmethod
    def open(cls, store: KeyValueStore, preset: Preset, spec, **kw) -> "Slasher":
        """Re-open a slasher over an existing database (reference
        Slasher::open, slasher/src/lib.rs:20-28)."""
        return cls(preset, spec, store=store, **kw)

    def _load_att_index(self) -> None:
        for key in self.store.keys(SlasherColumn.ATT_RECORD):
            v, t = struct.unpack(">QQ", key)
            self._targets_by_validator.setdefault(v, set()).add(t)

    # -- ingestion (slasher.rs accept_*) ------------------------------------

    def accept_attestation(self, indexed_attestation) -> None:
        self.attestation_queue.append(indexed_attestation)

    def accept_block_header(self, signed_header) -> None:
        self.block_queue.append(signed_header)

    # -- batched update (slasher.rs process_queued) -------------------------

    def process_queued(self) -> tuple[list, list]:
        """Drain queues, detect, record, flush dirty tiles to the store.
        Returns (new attester slashings, new proposer slashings)."""
        new_att, new_prop = [], []
        ops = []
        for att in self.attestation_queue:
            new_att.extend(self._process_attestation(att, ops))
        for header in self.block_queue:
            s = self._process_block_header(header, ops)
            if s is not None:
                new_prop.append(s)
        self.attestation_queue.clear()
        self.block_queue.clear()
        ops.extend(self.min_target.flush_ops())
        ops.extend(self.max_target.flush_ops())
        self.store.do_atomically(ops)
        if len(self._att_cache) > (1 << 16):
            self._att_cache.clear()  # bounded; records reload from the store
        self.attester_slashings.extend(new_att)
        self.proposer_slashings.extend(new_prop)
        return new_att, new_prop

    # -- attestation records -------------------------------------------------

    def _att_record(self, v: int, t: int):
        rec = self._att_cache.get((v, t))
        if rec is None:
            raw = self.store.get(SlasherColumn.ATT_RECORD, _record_key(v, t))
            if raw is None:
                return None
            rec = self._att_cache[(v, t)] = (raw[:32], raw[32:])
        return rec

    def _decode_indexed(self, ssz_bytes: bytes):
        from ..types import types_for

        return types_for(self.preset).IndexedAttestation.from_ssz_bytes(ssz_bytes)

    def _put_att_record(self, v: int, t: int, att_root: bytes, ssz_bytes: bytes, ops):
        self._att_cache[(v, t)] = (att_root, ssz_bytes)
        self._targets_by_validator.setdefault(v, set()).add(t)
        ops.append(
            ("put", SlasherColumn.ATT_RECORD, _record_key(v, t), att_root + ssz_bytes)
        )

    # -- attestation detection ----------------------------------------------

    def _process_attestation(self, indexed, ops) -> list:
        out = []
        data = indexed.data
        s, t = data.source.epoch, data.target.epoch
        if s >= self.history or t >= self.history:
            return out  # outside the tracked window
        att_root = data.tree_hash_root()
        indexed_ssz = indexed.as_ssz_bytes()
        for v in indexed.attesting_indices:
            # double vote
            prior = self._att_record(v, t)
            if prior is not None and prior[0] != att_root:
                out.append((v, self._decode_indexed(prior[1]), indexed))
                continue
            # Surround checks via the running arrays. AttesterSlashing
            # order matters: is_slashable_attestation_data (spec) requires
            # attestation_1 to be the SURROUNDING vote
            # (source_1 < source_2 and target_2 < target_1).
            if s + 1 < self.history and self.min_target.get(v, s + 1) < t:
                # prior has source' > s and target' < t: NEW surrounds PRIOR
                culprit = self._find_record(v, lambda pt: pt[1] < t and pt[0] > s)
                if culprit is not None:
                    out.append((v, indexed, culprit))
            if s >= 1 and self.max_target.get(v, s - 1) > t:
                # prior has source' < s and target' > t: PRIOR surrounds NEW
                culprit = self._find_record(v, lambda pt: pt[1] > t and pt[0] < s)
                if culprit is not None:
                    out.append((v, culprit, indexed))
            # record + running-array maintenance
            self._put_att_record(v, t, att_root, indexed_ssz, ops)
            # min_target[s'] for s' <= s gets min'ed with t
            self.min_target.update_range(v, 0, s + 1, t, np.minimum)
            # max_target[s'] for s' >= s gets max'ed with t
            self.max_target.update_range(v, s, self.history, t, np.maximum)
        return self._to_attester_slashings(out)

    def _find_record(self, validator: int, predicate):
        for t in self._targets_by_validator.get(validator, ()):
            rec = self._att_record(validator, t)
            if rec is None:
                continue
            indexed = self._decode_indexed(rec[1])
            if predicate((indexed.data.source.epoch, indexed.data.target.epoch)):
                return indexed
        return None

    def _to_attester_slashings(self, detections) -> list:
        from ..types import types_for

        t = types_for(self.preset)
        return [
            t.AttesterSlashing(attestation_1=att_1, attestation_2=att_2)
            for _, att_1, att_2 in detections
        ]

    # -- block detection -----------------------------------------------------

    def _process_block_header(self, signed_header, ops):
        header = signed_header.message
        key = _record_key(header.proposer_index, header.slot)
        raw = self._blk_cache.get(key)
        if raw is None:
            raw = self.store.get(SlasherColumn.BLOCK_RECORD, key)
        if raw is None:
            ssz = signed_header.as_ssz_bytes()
            self._blk_cache[key] = ssz
            ops.append(("put", SlasherColumn.BLOCK_RECORD, key, ssz))
            return None
        from ..types.containers import ProposerSlashing, SignedBeaconBlockHeader

        prior = SignedBeaconBlockHeader.from_ssz_bytes(raw)
        if prior.message.tree_hash_root() == header.tree_hash_root():
            return None
        return ProposerSlashing(
            signed_header_1=prior, signed_header_2=signed_header
        )

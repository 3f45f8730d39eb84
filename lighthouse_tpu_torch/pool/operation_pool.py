"""Operation pool (reference beacon_node/operation_pool/src/lib.rs:189,239,
357 + attestation_storage.rs): holds pre-verified attestations, slashings,
and exits; packs blocks with greedy max-cover over unattested committee
positions.

The port's copy of lighthouse_tpu/pool/operation_pool.py.
"""

from __future__ import annotations

from ..crypto.bls.api import AggregateSignature, Signature
from ..types import CommitteeCache, compute_epoch_at_slot
from ..types.presets import Preset
from .max_cover import max_cover


class OperationPool:
    def __init__(self, preset: Preset, spec):
        self.preset = preset
        self.spec = spec
        # compact split storage: (data_root) -> {"data", variants:
        # [(bits_tuple, sig_bytes)]} (attestation_storage.rs splits
        # data from aggregation the same way)
        self._attestations: dict[bytes, dict] = {}
        self._proposer_slashings: dict[int, object] = {}
        self._attester_slashings: list = []
        self._voluntary_exits: dict[int, object] = {}
        # set by load() when a persisted blob only partially decoded
        self.persist_load_error: str | None = None

    # -- attestations (lib.rs:189 insert_attestation) -----------------------

    def insert_attestation(self, attestation) -> None:
        root = attestation.data.tree_hash_root()
        entry = self._attestations.setdefault(
            root, {"data": attestation.data, "variants": []}
        )
        bits = tuple(attestation.aggregation_bits)
        for have_bits, have_sig in entry["variants"]:
            if all(h or not b for h, b in zip(have_bits, bits)):
                return  # subset of an existing aggregate
        entry["variants"].append(
            (bits, bytes(attestation.signature))
        )

    def num_attestations(self) -> int:
        return sum(len(e["variants"]) for e in self._attestations.values())

    # -- block packing (lib.rs:239 get_attestations + max_cover) ------------

    def get_attestations(self, state, ctxt_cache: dict | None = None):
        """Pick up to MAX_ATTESTATIONS aggregates maximizing new attester
        coverage for the current/previous epoch of `state`."""
        t_epoch_ok = (
            compute_epoch_at_slot(state.slot, self.preset),
            max(compute_epoch_at_slot(state.slot, self.preset) - 1, 0),
        )
        caches: dict[int, CommitteeCache] = ctxt_cache or {}

        candidates = []
        for entry in self._attestations.values():
            data = entry["data"]
            if data.target.epoch not in t_epoch_ok:
                continue
            if not (
                data.slot + self.spec.min_attestation_inclusion_delay
                <= state.slot
                <= data.slot + self.preset.slots_per_epoch
            ):
                continue
            epoch = data.target.epoch
            cache = caches.get(epoch)
            if cache is None:
                cache = CommitteeCache(state, epoch, self.preset, self.spec)
                caches[epoch] = cache
            try:
                committee = cache.get_beacon_committee(data.slot, data.index)
            except ValueError:
                continue
            for bits, sig in entry["variants"]:
                if len(bits) != len(committee):
                    continue
                cover = {
                    v: 1 for v, b in zip(committee, bits) if b
                }
                candidates.append(((data, bits, sig), cover))

        chosen = max_cover(
            candidates,
            covering=lambda c: c[1],
            weight=None,
            limit=self.preset.max_attestations,
        )
        from ..types import types_for

        t = types_for(self.preset)
        return [
            t.Attestation(
                aggregation_bits=bits, data=data, signature=sig
            )
            for (data, bits, sig), _ in chosen
        ]

    # -- slashings & exits (lib.rs:357 get_slashings_and_exits) -------------

    def insert_proposer_slashing(self, slashing) -> None:
        index = slashing.signed_header_1.message.proposer_index
        self._proposer_slashings.setdefault(index, slashing)

    def insert_attester_slashing(self, slashing) -> None:
        self._attester_slashings.append(slashing)

    def insert_voluntary_exit(self, exit_op) -> None:
        self._voluntary_exits.setdefault(
            exit_op.message.validator_index, exit_op
        )

    def get_slashings_and_exits(self, state):
        epoch = compute_epoch_at_slot(state.slot, self.preset)

        def slashable(index):
            from ..types import is_slashable_validator

            return index < len(state.validators) and is_slashable_validator(
                state.validators[index], epoch
            )

        proposer = [
            s
            for i, s in self._proposer_slashings.items()
            if slashable(i)
        ][: self.preset.max_proposer_slashings]
        attester = [
            s
            for s in self._attester_slashings
            if any(
                slashable(i)
                for i in set(s.attestation_1.attesting_indices)
                & set(s.attestation_2.attesting_indices)
            )
        ][: self.preset.max_attester_slashings]

        def exitable(op):
            from ..types import FAR_FUTURE_EPOCH, is_active_validator

            i = op.message.validator_index
            if i >= len(state.validators):
                return False
            v = state.validators[i]
            return (
                is_active_validator(v, epoch)
                and v.exit_epoch == FAR_FUTURE_EPOCH
                and op.message.epoch <= epoch
                # process_voluntary_exit's age gate: packing a too-young
                # exit would invalidate the produced block
                and epoch >= v.activation_epoch + self.spec.shard_committee_period
            )

        exits = [e for e in self._voluntary_exits.values() if exitable(e)][
            : self.preset.max_voluntary_exits
        ]
        return proposer, attester, exits

    # -- persistence (operation_pool/src/persistence.rs) --------------------
    #
    # The pool survives restarts: every held operation serializes as its
    # SSZ container into one length-framed blob under the CHAIN column.
    # Reload replays each item through the normal insert path, so dedup /
    # subset rules apply identically to restored state.

    _PERSIST_KEY = b"op_pool_v1"

    def persist(self, store) -> None:
        import struct as _s

        from ..types.containers import types_for

        t = types_for(self.preset)
        sections: list[list[bytes]] = [[], [], [], []]
        for entry in self._attestations.values():
            for bits, sig in entry["variants"]:
                att = t.Attestation(
                    aggregation_bits=list(bits),
                    data=entry["data"],
                    signature=sig,
                )
                sections[0].append(att.as_ssz_bytes())
        for s in self._proposer_slashings.values():
            sections[1].append(s.as_ssz_bytes())
        for s in self._attester_slashings:
            sections[2].append(s.as_ssz_bytes())
        for e in self._voluntary_exits.values():
            sections[3].append(e.as_ssz_bytes())
        out = bytearray()
        for items in sections:
            out += _s.pack(">I", len(items))
            for blob in items:
                out += _s.pack(">I", len(blob)) + blob
        # the blob rewrite commits through the write-ahead journal: a
        # crash mid-write must leave the OLD blob or the NEW one, never a
        # torn prefix (load() tolerates truncation, but best-effort decode
        # of a torn blob silently drops operations; the journal's intent
        # record makes the rewrite all-or-nothing on every backend)
        batch = store.batch()
        batch.stage_chain_item(self._PERSIST_KEY, bytes(out))
        batch.commit()

    @classmethod
    def load(cls, store, preset: Preset, spec, log=None) -> "OperationPool":
        import struct as _s

        from ..types.containers import types_for

        pool = cls(preset, spec)
        blob = store.get_chain_item(cls._PERSIST_KEY)
        if not blob:
            return pool
        from ..types.containers import ProposerSlashing, SignedVoluntaryExit

        t = types_for(preset)
        decoders = [
            (t.Attestation, pool.insert_attestation),
            (ProposerSlashing, pool.insert_proposer_slashing),
            (t.AttesterSlashing, pool.insert_attester_slashing),
            (SignedVoluntaryExit, pool.insert_voluntary_exit),
        ]
        try:
            off = 0
            for cls_, insert in decoders:
                (count,) = _s.unpack_from(">I", blob, off)
                off += 4
                for _ in range(count):
                    (ln,) = _s.unpack_from(">I", blob, off)
                    off += 4
                    insert(cls_.from_ssz_bytes(blob[off : off + ln]))
                    off += ln
        except (ValueError, IndexError, _s.error) as e:
            # persistence is best-effort BOTH ways: a corrupt/truncated
            # blob (crash mid-write, SszError/struct.error) must not
            # crash-loop node startup; restart with whatever decoded and
            # surface the partial load for the operator
            pool.persist_load_error = f"{type(e).__name__}: {e}"
            if log is None:
                # fallback stderr sink; callers with a configured logger
                # (level / json / file) should pass it in
                from ..utils.logging import Logger

                log = Logger()
            log.warn(
                "op-pool persisted blob only partially decoded",
                error=pool.persist_load_error,
            )
        return pool

    # -- pruning (lib.rs prune_* on finalization) ---------------------------

    def prune(self, state) -> None:
        epoch = compute_epoch_at_slot(state.slot, self.preset)
        for root in [
            r
            for r, e in self._attestations.items()
            if e["data"].target.epoch + 1 < epoch
        ]:
            del self._attestations[root]
        for i in [
            i
            for i, v in enumerate(state.validators)
            if v.slashed and i in self._proposer_slashings
        ]:
            del self._proposer_slashings[i]
        self._voluntary_exits = {
            i: e
            for i, e in self._voluntary_exits.items()
            if i < len(state.validators)
            and state.validators[i].exit_epoch == 2**64 - 1
        }

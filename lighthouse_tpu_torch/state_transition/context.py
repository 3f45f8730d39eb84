"""Per-block processing context: memoizes proposer index and indexed
attestations so gossip verification, signature batching, and state
transition share one computation (reference
consensus/state_processing/src/consensus_context.rs:136)."""

from __future__ import annotations

from ..types import CommitteeCache, compute_epoch_at_slot
from ..types.presets import Preset


class BlockProcessingError(ValueError):
    pass


class ConsensusContext:
    def __init__(self, preset: Preset, spec):
        self.preset = preset
        self.spec = spec
        self.proposer_index: int | None = None
        self._indexed: dict[bytes, object] = {}
        self._committee_caches: dict[int, CommitteeCache] = {}
        self._pubkey_map: dict[bytes, int] | None = None
        self._pubkey_map_len = 0
        # engine hook for process_execution_payload (payload -> bool or a
        # PayloadVerificationStatus); None = no engine round trip (replay)
        self.notify_new_payload = None
        # set by the hook's caller after import, for optimistic tracking
        self.payload_verification_status = None

    def pubkey_to_index(self, state, pubkey: bytes) -> int | None:
        """Registry pubkey -> validator index, built once and extended
        incrementally as deposits append validators (avoids an O(V) scan
        per deposit)."""
        n = len(state.validators)
        if self._pubkey_map is None:
            self._pubkey_map = {
                bytes(v.pubkey): i for i, v in enumerate(state.validators)
            }
            self._pubkey_map_len = n
        elif self._pubkey_map_len < n:
            for i in range(self._pubkey_map_len, n):
                self._pubkey_map[bytes(state.validators[i].pubkey)] = i
            self._pubkey_map_len = n
        return self._pubkey_map.get(bytes(pubkey))

    def get_proposer_index(self, state) -> int:
        """Memoized proposer for the block's slot (consensus_context.rs
        proposer_index): the weighted-sampling loop is O(active set), and a
        block consults it once per attestation/slashing/sync-aggregate."""
        if self.proposer_index is None:
            from .per_slot import get_beacon_proposer_index

            self.proposer_index = get_beacon_proposer_index(
                state, self.preset, self.spec
            )
        return self.proposer_index

    def committee_cache(self, state, epoch: int) -> CommitteeCache:
        cache = self._committee_caches.get(epoch)
        if cache is None:
            current = compute_epoch_at_slot(state.slot, self.preset)
            if epoch not in (current, current - 1, current + 1):
                raise BlockProcessingError(
                    f"committee cache for epoch {epoch} unavailable at {current}"
                )
            cache = CommitteeCache(state, epoch, self.preset, self.spec)
            self._committee_caches[epoch] = cache
        return cache

    def get_indexed_attestation(self, state, attestation):
        """Committee-sorted indexed form, memoized by attestation root
        (consensus_context.rs get_indexed_attestation)."""
        key = attestation.tree_hash_root()
        hit = self._indexed.get(key)
        if hit is not None:
            return hit
        data = attestation.data
        epoch = compute_epoch_at_slot(data.slot, self.preset)
        cache = self.committee_cache(state, epoch)
        committee = cache.get_beacon_committee(data.slot, data.index)
        bits = list(attestation.aggregation_bits)
        if len(bits) != len(committee):
            raise BlockProcessingError(
                f"aggregation bits {len(bits)} != committee {len(committee)}"
            )
        indices = sorted(i for i, b in zip(committee, bits) if b)
        from ..types import types_for

        t = types_for(self.preset)
        indexed = t.IndexedAttestation(
            attesting_indices=tuple(indices),
            data=data,
            signature=attestation.signature,
        )
        self._indexed[key] = indexed
        return indexed

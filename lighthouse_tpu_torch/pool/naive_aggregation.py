"""Naive aggregation pool (reference beacon_node/beacon_chain/src/
naive_aggregation_pool.rs): accumulates unaggregated attestations into
per-(slot, data-root) aggregates so the node can serve aggregation duties
and pack blocks even before committee aggregators publish.

The port's copy of lighthouse_tpu/pool/naive_aggregation.py.
"""

from __future__ import annotations

from ..crypto.bls.api import AggregateSignature, Signature


class NaiveAggregationPool:
    def __init__(self, retained_slots: int = 32):
        self.retained = retained_slots
        # (slot, data_root) -> {"data": AttestationData, "bits": list[bool],
        #                        "sig": AggregateSignature}
        self._map: dict[tuple[int, bytes], dict] = {}

    def insert(self, attestation) -> bool:
        """Insert an UNAGGREGATED attestation (exactly one bit set).
        Returns True if it contributed new participation."""
        bits = list(attestation.aggregation_bits)
        if sum(bits) != 1:
            raise ValueError("naive pool accepts single-bit attestations only")
        key = (attestation.data.slot, attestation.data.tree_hash_root())
        entry = self._map.get(key)
        if entry is None:
            self._map[key] = {
                "data": attestation.data,
                "bits": bits,
                "sig": AggregateSignature.aggregate(
                    [Signature.from_bytes(bytes(attestation.signature))]
                ),
            }
            self._prune(attestation.data.slot)
            return True
        idx = bits.index(True)
        if len(entry["bits"]) != len(bits):
            raise ValueError("aggregation bit length mismatch")
        if entry["bits"][idx]:
            return False  # already have this attester
        entry["bits"][idx] = True
        entry["sig"].add_assign(
            Signature.from_bytes(bytes(attestation.signature))
        )
        return True

    def get(self, data) -> dict | None:
        return self._map.get((data.slot, data.tree_hash_root()))

    def get_aggregate(self, t, data):
        """Best aggregate for AttestationData as a typed Attestation."""
        entry = self.get(data)
        if entry is None:
            return None
        return t.Attestation(
            aggregation_bits=tuple(entry["bits"]),
            data=entry["data"],
            signature=entry["sig"].to_bytes(),
        )

    def _prune(self, current_slot: int) -> None:
        low = current_slot - self.retained
        for key in [k for k in self._map if k[0] < low]:
            del self._map[key]

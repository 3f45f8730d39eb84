"""Observed-gossip dedup caches (reference beacon_node/beacon_chain/src/
observed_{attesters,aggregates,block_producers,operations}.rs): the
first-seen filters that gate gossip propagation and protect the
verification pipeline from duplicates."""

from __future__ import annotations


class ObservedAttesters:
    """Per-epoch set of validator indices that have published an
    unaggregated attestation (observed_attesters.rs AutoPruningContainer)."""

    def __init__(self, retained_epochs: int = 2):
        self.retained = retained_epochs
        self._epochs: dict[int, set[int]] = {}

    def observe(self, epoch: int, validator_index: int) -> bool:
        """Returns True if ALREADY seen (caller should drop the item)."""
        seen = self._epochs.setdefault(epoch, set())
        if validator_index in seen:
            return True
        seen.add(validator_index)
        self._prune(epoch)
        return False

    def is_known(self, epoch: int, validator_index: int) -> bool:
        return validator_index in self._epochs.get(epoch, ())

    def _prune(self, current_epoch: int) -> None:
        low = current_epoch - self.retained
        for e in [e for e in self._epochs if e < low]:
            del self._epochs[e]


class ObservedAggregators(ObservedAttesters):
    """Same structure for (epoch, aggregator_index) pairs."""


class ObservedAggregates:
    """Seen aggregate-attestation roots per epoch
    (observed_aggregates.rs)."""

    def __init__(self, retained_epochs: int = 2):
        self.retained = retained_epochs
        self._epochs: dict[int, set[bytes]] = {}

    def observe(self, epoch: int, item_root: bytes) -> bool:
        seen = self._epochs.setdefault(epoch, set())
        if item_root in seen:
            return True
        seen.add(item_root)
        low = epoch - self.retained
        for e in [e for e in self._epochs if e < low]:
            del self._epochs[e]
        return False

    def is_known(self, epoch: int, item_root: bytes) -> bool:
        return item_root in self._epochs.get(epoch, ())


class ObservedBlockProducers:
    """(slot, proposer) pairs already seen on gossip
    (observed_block_producers.rs); a second distinct block from the same
    proposer at the same slot is a slashable equivocation signal."""

    def __init__(self, retained_slots: int = 64):
        self.retained = retained_slots
        self._slots: dict[int, dict[int, bytes]] = {}

    def observe(self, slot: int, proposer: int, block_root: bytes):
        """Returns 'duplicate' | 'equivocation' | None (first sighting).
        Callers must only RECORD verified blocks (observe after the
        proposer signature checks out): recording an unverified first
        sighting would let a forged block suppress the real proposal."""
        by_proposer = self._slots.setdefault(slot, {})
        prev = by_proposer.get(proposer)
        if prev is not None:
            return "duplicate" if prev == block_root else "equivocation"
        by_proposer[proposer] = block_root
        low = slot - self.retained
        for s in [s for s in self._slots if s < low]:
            del self._slots[s]
        return None

    def known_root(self, slot: int, proposer: int) -> bytes | None:
        """Read-only probe: the VERIFIED root already recorded for
        (slot, proposer), or None. The gossip ingress uses it for cheap
        exact-duplicate shedding without recording anything."""
        return self._slots.get(slot, {}).get(proposer)


class ObservedOperations:
    """Dedup for exits/slashings by offending validator index
    (observed_operations.rs)."""

    def __init__(self):
        self._seen: set[tuple[str, int]] = set()

    def observe(self, kind: str, validator_index: int) -> bool:
        key = (kind, validator_index)
        if key in self._seen:
            return True
        self._seen.add(key)
        return False

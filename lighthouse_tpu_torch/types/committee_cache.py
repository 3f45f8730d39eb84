"""Per-epoch committee cache (reference
consensus/types/src/beacon_state/committee_cache.rs): one vectorized
swap-or-not shuffle of the active set per epoch, then committee lookup is
pure slicing. Also owns the attester->(committee, position) reverse map the
gossip verification path needs."""

from __future__ import annotations

from ..utils.shuffle import shuffle_indices
from .chain_spec import DOMAIN_BEACON_ATTESTER as _DOM_ATT
from .chain_spec import ChainSpec
from .helpers import (
    compute_epoch_at_slot,
    get_active_validator_indices,
    get_committee_count_per_slot,
    get_seed,
)
from .presets import Preset


class CommitteeCache:
    def __init__(self, state, epoch: int, preset: Preset, spec: ChainSpec):
        self.epoch = epoch
        self.preset = preset
        active = get_active_validator_indices(state, epoch)
        seed = get_seed(state, epoch, _DOM_ATT, preset, spec)
        perm = shuffle_indices(len(active), seed, spec.shuffle_round_count)
        # shuffling[i] = active[perm[i]]: the committee-ordered validator list
        self.shuffling = [active[p] for p in perm]
        self.committees_per_slot = get_committee_count_per_slot(
            len(active), preset, spec
        )
        self.slots_per_epoch = preset.slots_per_epoch
        self._reverse: dict[int, tuple[int, int, int]] | None = None

    @property
    def active_validator_count(self) -> int:
        return len(self.shuffling)

    def _committee_range(self, slot: int, index: int) -> range:
        epoch_count = self.committees_per_slot * self.slots_per_epoch
        committee_index = (
            (slot % self.slots_per_epoch) * self.committees_per_slot + index
        )
        n = len(self.shuffling)
        start = n * committee_index // epoch_count
        end = n * (committee_index + 1) // epoch_count
        return range(start, end)

    def get_beacon_committee(self, slot: int, index: int) -> list[int]:
        if compute_epoch_at_slot(slot, self.preset) != self.epoch:
            raise ValueError("slot not in cached epoch")
        if index >= self.committees_per_slot:
            raise ValueError("committee index out of range")
        r = self._committee_range(slot, index)
        return [self.shuffling[i] for i in r]

    def get_all_committees_at_slot(self, slot: int) -> list[list[int]]:
        return [
            self.get_beacon_committee(slot, i)
            for i in range(self.committees_per_slot)
        ]

    def attester_position(self, validator_index: int):
        """(slot_offset, committee_index, position) or None -- the reverse
        map duty lookup and slashing detection use."""
        if self._reverse is None:
            rev = {}
            for slot_off in range(self.slots_per_epoch):
                for ci in range(self.committees_per_slot):
                    r = self._committee_range(slot_off, ci)
                    for pos, i in enumerate(r):
                        rev[self.shuffling[i]] = (slot_off, ci, pos)
            self._reverse = rev
        return self._reverse.get(validator_index)

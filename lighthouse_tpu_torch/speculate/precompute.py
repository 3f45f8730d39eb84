"""Committee aggregate-pubkey precompute (the first half of speculate/).

Committees are known an epoch ahead (MIN_SEED_LOOKAHEAD): at each epoch
boundary this cache walks the committee shuffle and precomputes, per
(slot, committee_index), the aggregate pubkey point for expected
full-committee participation plus the per-member point table. Attestation
verification then skips per-set pubkey aggregation entirely when the
arriving aggregation bits are the full committee, and falls back to an
INCREMENTAL CORRECTION (cached full aggregate minus the absent members'
points) for partial participation — O(absent) point ops instead of
O(committee).

Soundness model (the "One For All" framing, PAPERS.md): the precompute
only ever substitutes a MATHEMATICALLY IDENTICAL aggregate point for the
per-set aggregation the backend would have computed — exact group
arithmetic on both paths, so accept/reject verdicts are bit-identical
and planted forgeries still fail the pairing and are attributed by
bisection (tests/test_speculation.py plants them).

Reorg safety: every entry is keyed on the epoch's attester shuffling
seed (`get_seed(state, epoch, DOMAIN_BEACON_ATTESTER)` — the shuffling
decision input; CommitteeCache derives its permutation from exactly this
value). At verification time the seed is recomputed from the batch's own
head state: a reorg that changed the shuffling yields a different seed,
the entry is invalidated and the set falls through to the normal path;
a same-shuffling reorg keeps the cache warm.

The port's copy of lighthouse_tpu/speculate/precompute.py. On the
torch_cuda and fallback backends the committee aggregates live in
torch_cuda's committee table on the backend's device (`api.set_backend`'s
`device`), and the incremental correction runs there when it is switched
on. Unlike the JAX package, nothing around the device import or
the device correction degrades to the host: on those backends an error
there reaches the caller.
"""

from __future__ import annotations

from ..crypto.bls import api as bls_api
from ..crypto.bls.api import PublicKey, _g1_infinity, get_backend_name
from ..types import DOMAIN_BEACON_ATTESTER, compute_start_slot_at_epoch
from ..types.helpers import get_seed
from ..utils import metrics as M

# partial-participation corrections memoized per entry (gossip re-sends
# the same bit patterns); bounded per entry, entries are epoch-scoped
_MAX_CORRECTIONS_PER_ENTRY = 64

# the backends whose committee aggregates and corrections live on the card
_DEVICE_BACKENDS = ("torch_cuda", "fallback")


class PrecomputeEntry:
    """One (slot, committee_index)'s precomputed aggregation state."""

    __slots__ = (
        "shuffling_key",
        "slot",
        "index",
        "members",
        "member_pks",
        "full_point",
        "full_pk",
        "corrections",
    )

    def __init__(self, shuffling_key, slot, index, members, member_pks):
        self.shuffling_key = shuffling_key
        self.slot = slot
        self.index = index
        self.members = members  # tuple, committee order
        self.member_pks = member_pks  # same order
        point = _g1_infinity()
        for pk in member_pks:
            point = point + pk.point
        self.full_point = point
        # sum of cache-validated member keys: G1 is closed under +, so
        # the aggregate inherits key_validate without paying the check
        self.full_pk = PublicKey(point, subgroup_checked=True)
        self.corrections: dict[tuple, PublicKey] = {}

    def matches(self, bits, attesting_indices) -> bool:
        """Never-trust guard: the bit-selected committee members must be
        exactly the indexed attestation's attesting indices (which
        ConsensusContext derives sorted)."""
        if len(bits) != len(self.members):
            return False
        selected = sorted(
            m for m, b in zip(self.members, bits) if b
        )
        return selected == [int(i) for i in attesting_indices]


class CommitteePrecompute:
    """Epoch-scoped map (slot, committee_index) -> PrecomputeEntry, keyed
    on the epoch's shuffling seed. `refresh_epoch` runs off the critical
    path (epoch boundary / idle time); `lookup` + `aggregate_pubkey` run
    inside batch setup and do no point arithmetic on a full-bits hit."""

    def __init__(self, preset, spec, device_correction: bool | None = None):
        self.preset = preset
        self.spec = spec
        # None -> decide per call from the backend env flag
        self.device_correction = device_correction
        self._epochs: dict[int, dict[tuple[int, int], PrecomputeEntry]] = {}
        self._keys: dict[int, bytes] = {}
        self.stats = {
            "full_hits": 0,
            "corrections": 0,
            "misses": 0,
            "invalidations": 0,
            "refreshes": 0,
        }

    def shuffling_key(self, state, epoch: int) -> bytes:
        """The attester shuffling seed — one randao-mix lookup + one hash,
        cheap enough to recompute per verification batch item."""
        return get_seed(
            state, epoch, DOMAIN_BEACON_ATTESTER, self.preset, self.spec
        )

    # -- refresh / invalidation (off the critical path) ---------------------

    def refresh_epoch(self, state, epoch: int, ctxt, get_pubkey) -> int:
        """Precompute every committee of `epoch` (members + full aggregate
        point) under the epoch's shuffling key. No-op when the key is
        unchanged (warm across same-shuffling reorgs). Returns the number
        of entries built."""
        key = self.shuffling_key(state, epoch)
        if self._keys.get(epoch) == key:
            return 0
        self._drop_epoch(epoch, invalidated=epoch in self._epochs)
        cache = ctxt.committee_cache(state, epoch)
        entries: dict[tuple[int, int], PrecomputeEntry] = {}
        start = compute_start_slot_at_epoch(epoch, self.preset)
        for slot in range(start, start + self.preset.slots_per_epoch):
            for index in range(cache.committees_per_slot):
                members = tuple(cache.get_beacon_committee(slot, index))
                if not members:
                    continue
                pks = [get_pubkey(i) for i in members]
                entries[(slot, index)] = PrecomputeEntry(
                    key, slot, index, members, pks
                )
        self._epochs[epoch] = entries
        self._keys[epoch] = key
        self.stats["refreshes"] += 1
        self._update_gauge()
        self._register_device_resident()
        return len(entries)

    def check_epoch(self, state, epoch: int) -> bool:
        """Revalidate a cached epoch against (possibly reorged) `state`:
        drops it when the shuffling seed moved. True iff still valid."""
        if epoch not in self._keys:
            return False
        if self._keys[epoch] == self.shuffling_key(state, epoch):
            return True
        self._drop_epoch(epoch, invalidated=True)
        return False

    def prune(self, min_epoch: int) -> None:
        """Forget epochs before `min_epoch` (normal aging, not counted as
        invalidation)."""
        for e in [e for e in self._epochs if e < min_epoch]:
            self._drop_epoch(e, invalidated=False)

    def _drop_epoch(self, epoch: int, invalidated: bool) -> None:
        dropped = self._epochs.pop(epoch, None)
        self._keys.pop(epoch, None)
        if dropped and invalidated:
            n = len(dropped)
            self.stats["invalidations"] += n
            M.SPECULATE_PRECOMPUTE_INVALIDATIONS.inc(n)
        if dropped:
            self._update_gauge()

    def __len__(self) -> int:
        return sum(len(v) for v in self._epochs.values())

    def _update_gauge(self) -> None:
        M.SPECULATE_PRECOMPUTE_ENTRIES.set(
            sum(len(v) for v in self._epochs.values())
        )

    def _register_device_resident(self) -> None:
        """Park the full-aggregate family device-resident next to the
        validator pubkey table (torch_cuda and fallback backends only):
        warms each synthetic key's cached limb array so marshalling an
        all-precomputed batch ships precomputed arrays, never converts
        coordinates on the critical path."""
        if get_backend_name() not in _DEVICE_BACKENDS:
            return
        from ..crypto.bls.backends import torch_cuda

        torch_cuda.set_committee_aggregates(
            [
                e.full_pk
                for entries in self._epochs.values()
                for e in entries.values()
            ],
            device=bls_api._DEVICE,
        )

    # -- critical-path lookup ----------------------------------------------

    def lookup(self, state, slot: int, index: int, epoch: int):
        """Entry for (slot, index) iff its shuffling key matches the seed
        derived from the VERIFYING state (the stale-after-reorg gate).
        None on miss; the caller counts the miss once per set."""
        entries = self._epochs.get(epoch)
        if entries is None:
            return None
        entry = entries.get((slot, index))
        if entry is None:
            return None
        if entry.shuffling_key != self.shuffling_key(state, epoch):
            # reorg moved the shuffling under us: the whole epoch is stale
            self._drop_epoch(epoch, invalidated=True)
            return None
        return entry

    def aggregate_pubkey(self, entry: PrecomputeEntry, bits) -> PublicKey:
        """The precomputed aggregate for this participation pattern.
        Caller must have checked `entry.matches(bits, ...)`. Full
        participation returns the cached full-committee key (zero point
        ops); partial returns the memoized incremental correction."""
        if all(bits):
            self.stats["full_hits"] += 1
            M.SPECULATE_PRECOMPUTE_HITS.inc()
            return entry.full_pk
        memo_key = tuple(bits)
        cached = entry.corrections.get(memo_key)
        if cached is not None:
            self.stats["corrections"] += 1
            M.SPECULATE_PRECOMPUTE_CORRECTIONS.inc()
            return cached
        absent = [pk for pk, b in zip(entry.member_pks, bits) if not b]
        point = self._corrected_point(entry, absent)
        # full - sum(absent) over validated keys stays in the subgroup
        pk = PublicKey(point, subgroup_checked=True)
        if len(entry.corrections) < _MAX_CORRECTIONS_PER_ENTRY:
            entry.corrections[memo_key] = pk
        self.stats["corrections"] += 1
        M.SPECULATE_PRECOMPUTE_CORRECTIONS.inc()
        return pk

    def _corrected_point(self, entry: PrecomputeEntry, absent):
        """full - sum(absent): host oracle arithmetic by default; on the
        torch_cuda and fallback backends the staged device program
        (torch_cuda.correct_aggregate_device) behind
        LIGHTHOUSE_TPU_SPECULATE_DEVICE (or `device_correction=True`)
        computes the identical point with one graph per bucket. A device
        failure raises: the host arithmetic is not a hidden fallback. A
        None from the device (the all-absent infinity) falls through."""
        if get_backend_name() in _DEVICE_BACKENDS:
            from ..crypto.bls.backends import torch_cuda

            use_device = self.device_correction
            if use_device is None:
                use_device = torch_cuda._speculate_device_enabled()
            if use_device:
                point = torch_cuda.correct_aggregate_device(
                    entry.full_pk, absent, device=bls_api._DEVICE
                )
                if point is not None:
                    return point
        point = entry.full_point
        for pk in absent:
            point = point + (-pk.point)
        return point

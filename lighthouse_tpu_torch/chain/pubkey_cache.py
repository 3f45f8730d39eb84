"""Chain-owned validator pubkey cache: decompress each registry key ONCE
at import time, keep the decompressed keys indexed by validator index, and
expose a device-resident limb table for the batch verifier on the card.

The port's copy of lighthouse_tpu/chain/pubkey_cache.py, the analogue of
the reference's ValidatorPubkeyCache
(beacon_node/beacon_chain/src/validator_pubkey_cache.rs:10-23,79,131):
decompression is expensive, so it happens exactly once per validator --
here the same moment also packs the key's limb tensor and (lazily) uploads
it to the device table, so steady-state batch verification ships only
validator indices host->device.

Keys handed out by this cache are tagged with `validator_index` and
`table` (= this cache); the torch_cuda backend detects fully-tagged
batches and gathers limb rows on the device instead of packing host
arrays. Backends without a device path (cpu, fake) simply ignore the
tags, so the cache is backend-agnostic and builds no device table unless
one is asked for. The table lives on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import functools

from ..crypto.bls.api import PublicKey


class PubkeyCacheError(ValueError):
    pass


@functools.lru_cache(maxsize=1 << 20)
def _validated(pubkey_bytes: bytes) -> PublicKey:
    """Decompression + subgroup check happen once per key process-wide
    (interop keys recur across every test chain)."""
    return PublicKey.from_bytes(pubkey_bytes)


def _fresh(pubkey_bytes: bytes) -> PublicKey:
    """A cache-private wrapper sharing the validated point: each chain's
    cache tags its OWN objects (index + table) without clobbering keys
    shared through the process-wide LRU."""
    src = _validated(bytes(pubkey_bytes))
    # the shared LRU key already passed from_bytes' key_validate
    return PublicKey(src.point, src.to_bytes(), subgroup_checked=True)


class ValidatorPubkeyCache:
    def __init__(self, state=None, device=None):
        self._pubkeys: list[PublicKey] = []
        self._index_by_bytes: dict[bytes, int] = {}
        self._table = None  # lazily-built torch_cuda.PubkeyTable
        self._device = device  # None: the card (torch_cuda.resolve_device)
        if state is not None:
            self.import_new_pubkeys(state)

    def __len__(self) -> int:
        return len(self._pubkeys)

    def import_new_pubkeys(self, state) -> int:
        """Decompress + register validators added since the last import
        (mirrors import_new_pubkeys, validator_pubkey_cache.rs:79).
        Returns the number of new keys."""
        start = len(self._pubkeys)
        new = []
        for i in range(start, len(state.validators)):
            pk = _fresh(state.validators[i].pubkey)
            pk.validator_index = i
            pk.table = self
            new.append(pk)
        if not new:
            return 0
        self._pubkeys.extend(new)
        for pk in new:
            self._index_by_bytes.setdefault(pk.to_bytes(), pk.validator_index)
        if self._table is not None:
            self._table.import_new_pubkeys(new)
        return len(new)

    def get(self, index: int) -> PublicKey:
        if index >= len(self._pubkeys):
            raise PubkeyCacheError(f"unknown validator index {index}")
        return self._pubkeys[index]

    def get_index(self, pubkey_bytes: bytes):
        return self._index_by_bytes.get(bytes(pubkey_bytes))

    def resolve(self, pubkey_bytes: bytes) -> PublicKey:
        """bytes -> cached decompressed key; decompresses (untagged) only
        for keys outside the registry."""
        idx = self._index_by_bytes.get(bytes(pubkey_bytes))
        if idx is not None:
            return self._pubkeys[idx]
        return _validated(bytes(pubkey_bytes))

    def getter(self, state=None):
        """get_pubkey(validator_index) closure for the signature-set
        builders. With `state`, indices beyond the cache fall back to the
        state registry (a deposit in the block being verified may have
        appended validators the chain has not imported yet)."""

        def get_pubkey(index: int) -> PublicKey:
            if index < len(self._pubkeys):
                return self._pubkeys[index]
            if state is not None and index < len(state.validators):
                return _validated(bytes(state.validators[index].pubkey))
            raise PubkeyCacheError(f"unknown validator index {index}")

        return get_pubkey

    # --- device table (duck-typed for the torch_cuda backend) --------------

    def device_table(self):
        """Bucketed (rows, 3, W) limb table on the device; built lazily so
        the cache builds nothing on the device for cpu/fake backends."""
        if self._table is None:
            from ..crypto.bls.backends.torch_cuda import PubkeyTable

            table = PubkeyTable(self._device)
            table.import_new_pubkeys(self._pubkeys)
            self._table = table
        return self._table.device_table()

    def gather(self, indices):
        """Validator indices -> (..., 3, W) device limb rows, via the
        table's gather path."""
        self.device_table()
        return self._table.gather(indices)

"""Deposit contract Merkle tree (reference beacon_node/eth1/src/
deposit_cache.rs + common/deposit_contract): depth-32 incremental tree of
DepositData roots whose root mixes in the deposit count, with branch
proofs in the spec's DEPOSIT_CONTRACT_TREE_DEPTH + 1 format (the extra
level is the mixed-in count).

The port's copy of lighthouse_tpu/eth1/deposit_tree.py.
"""

from __future__ import annotations

from ..ssz.hash import ZERO_HASHES, hash_concat
from ..types.containers import Deposit

DEPOSIT_TREE_DEPTH = 32


class DepositDataTree:
    def __init__(self):
        self.leaves: list[bytes] = []

    def push(self, deposit_data) -> None:
        self.leaves.append(deposit_data.tree_hash_root())

    def truncate(self, count: int) -> None:
        """Drop leaves past `count` (eth1 reorg rewind, service.rs)."""
        del self.leaves[count:]

    def _branch_root(self, count: int | None = None) -> bytes:
        """Root over the first `count` leaves (default all)."""
        if count is not None and count > len(self.leaves):
            raise ValueError(
                f"deposit tree has {len(self.leaves)} leaves, need {count}"
            )
        leaves = self.leaves[: count if count is not None else len(self.leaves)]
        layer = list(leaves)
        for d in range(DEPOSIT_TREE_DEPTH):
            if len(layer) % 2:
                layer.append(ZERO_HASHES[d])
            layer = [
                hash_concat(layer[i], layer[i + 1])
                for i in range(0, len(layer), 2)
            ]
        return layer[0] if layer else ZERO_HASHES[DEPOSIT_TREE_DEPTH]

    def root(self, count: int | None = None) -> bytes:
        n = count if count is not None else len(self.leaves)
        return hash_concat(
            self._branch_root(n), n.to_bytes(8, "little") + bytes(24)
        )

    def proof(self, index: int, count: int | None = None) -> list[bytes]:
        """Branch for leaf `index` against root(count): 32 tree levels +
        the count leaf (spec Deposit.proof format)."""
        n = count if count is not None else len(self.leaves)
        if not 0 <= index < n:
            raise IndexError("deposit index outside tree")
        layer = list(self.leaves[:n])
        branch = []
        idx = index
        for d in range(DEPOSIT_TREE_DEPTH):
            if len(layer) % 2:
                layer.append(ZERO_HASHES[d])
            sibling = idx ^ 1
            branch.append(layer[sibling] if sibling < len(layer) else ZERO_HASHES[d])
            layer = [
                hash_concat(layer[i], layer[i + 1])
                for i in range(0, len(layer), 2)
            ]
            idx //= 2
        branch.append(n.to_bytes(8, "little") + bytes(24))
        return branch

    def deposit(self, index: int, deposit_data, count: int | None = None):
        return Deposit(
            proof=tuple(self.proof(index, count)), data=deposit_data
        )

"""General merkle single- and multi-proofs over SSZ generalized indices
(reference consensus/merkle_proof/src/lib.rs + the consensus-spec
generalized-index helpers in ssz/merkle-proofs.md).

A generalized index addresses a node in the binary merkle tree rooted at
1: node g's children are 2g and 2g+1, depth = floor(log2(g)). Single
proofs carry the sibling on each level; multiproofs carry exactly the
helper nodes not derivable from the provided leaves.

`MerkleTree` builds the full padded tree from chunks so proofs can be
GENERATED for any SSZ merkleization this repo produces (the same padding
rules as ssz/hash.py merkleize, so proven roots match tree_hash_root /
cached_root outputs).

The port's copy of lighthouse_tpu/ssz/merkle_proof.py.
"""

from __future__ import annotations

from .hash import ZERO_HASHES, hash_concat


class MerkleProofError(ValueError):
    pass


def generalized_index_depth(index: int) -> int:
    if index < 1:
        raise MerkleProofError("generalized index must be >= 1")
    return index.bit_length() - 1


def generalized_index_sibling(index: int) -> int:
    return index ^ 1


def generalized_index_child(index: int, right: bool) -> int:
    return 2 * index + (1 if right else 0)


def branch_indices(index: int) -> list[int]:
    """The sibling path from a node up to (not including) the root --
    the generalized indices a single proof carries, leaf-to-root order."""
    out = []
    while index > 1:
        out.append(generalized_index_sibling(index))
        index //= 2
    return out


def multiproof_helper_indices(indices: list[int]) -> list[int]:
    """get_helper_indices from the consensus spec: all nodes needed to
    reconstruct the root that are not derivable from `indices`
    themselves, sorted descending (the spec's canonical order)."""
    all_helpers: set[int] = set()
    all_path: set[int] = set()
    for index in indices:
        i = index
        while i > 1:
            all_helpers.add(generalized_index_sibling(i))
            all_path.add(i)
            i //= 2
    return sorted(
        (i for i in all_helpers if i not in all_path), reverse=True
    )


def verify_merkle_proof(
    leaf: bytes, branch: list[bytes], index: int, root: bytes
) -> bool:
    """Single proof: fold the branch from the leaf up (reference
    merkle_proof/src/lib.rs verify_merkle_proof)."""
    return calculate_merkle_root(leaf, branch, index) == bytes(root)


def calculate_merkle_root(leaf: bytes, branch: list[bytes], index: int) -> bytes:
    depth = generalized_index_depth(index)
    if len(branch) != depth:
        raise MerkleProofError(
            f"branch length {len(branch)} != index depth {depth}"
        )
    node = bytes(leaf)
    i = index
    for sibling in branch:
        if i % 2:
            node = hash_concat(bytes(sibling), node)
        else:
            node = hash_concat(node, bytes(sibling))
        i //= 2
    return node


def verify_merkle_multiproof(
    leaves: list[bytes],
    proof: list[bytes],
    indices: list[int],
    root: bytes,
) -> bool:
    """Multiproof: `proof` holds the helper nodes in
    multiproof_helper_indices(indices) order (spec
    calculate_multi_merkle_root)."""
    helper_indices = multiproof_helper_indices(indices)
    if len(proof) != len(helper_indices):
        raise MerkleProofError("proof length != helper count")
    if len(leaves) != len(indices):
        raise MerkleProofError("leaves length != indices length")
    objects = {
        **{gi: bytes(leaf) for gi, leaf in zip(indices, leaves)},
        **{gi: bytes(node) for gi, node in zip(helper_indices, proof)},
    }
    keys = sorted(objects.keys(), reverse=True)
    pos = 0
    while pos < len(keys):
        k = keys[pos]
        if (
            k in objects
            and k ^ 1 in objects
            and k // 2 not in objects
        ):
            objects[k // 2] = hash_concat(
                objects[k & ~1], objects[k | 1]
            )
            keys.append(k // 2)
        pos += 1
    if 1 not in objects:
        raise MerkleProofError("multiproof does not reach the root")
    return objects[1] == bytes(root)


class MerkleTree:
    """Full padded binary tree over leaf chunks (the shape ssz/hash.py's
    merkleize produces): proof GENERATION for anything this repo
    merkleizes. Padding leaves are zero-hash subtrees, so trees with a
    `limit` (SSZ lists) prove correctly without materializing the limit."""

    def __init__(self, chunks: list[bytes], limit: int | None = None):
        n = max(len(chunks), 1)
        width = limit if limit is not None else n
        if width < len(chunks):
            raise MerkleProofError("more chunks than the limit allows")
        self.depth = max(width - 1, 0).bit_length()
        self.chunks = [bytes(c) for c in chunks]
        # levels[0] = leaves (padded virtually); levels[d] = root level
        # stored sparsely: only nodes covering real data; zero-subtree
        # roots come from ZERO_HASHES
        self.levels: list[list[bytes]] = [list(self.chunks)]
        for d in range(self.depth):
            prev = self.levels[d]
            nxt = []
            for i in range(0, len(prev), 2):
                left = prev[i]
                right = (
                    prev[i + 1] if i + 1 < len(prev) else ZERO_HASHES[d]
                )
                nxt.append(hash_concat(left, right))
            self.levels.append(nxt)

    @property
    def root(self) -> bytes:
        if not self.levels[-1]:
            return ZERO_HASHES[self.depth]
        return self.levels[-1][0]

    def _node(self, level: int, idx: int) -> bytes:
        row = self.levels[level]
        if idx < len(row):
            return row[idx]
        return ZERO_HASHES[level]

    def generalized_index_of_chunk(self, chunk_index: int) -> int:
        return (1 << self.depth) + chunk_index

    def proof(self, chunk_index: int) -> list[bytes]:
        """Single-proof branch for a leaf, leaf-to-root order."""
        if chunk_index >= (1 << self.depth):
            raise MerkleProofError("chunk index beyond tree width")
        out = []
        idx = chunk_index
        for level in range(self.depth):
            out.append(self._node(level, idx ^ 1))
            idx //= 2
        return out

    def multiproof(self, chunk_indices: list[int]) -> list[bytes]:
        """Helper nodes for a set of leaves, in spec helper order."""
        indices = [self.generalized_index_of_chunk(c) for c in chunk_indices]
        helpers = multiproof_helper_indices(indices)
        out = []
        for gi in helpers:
            level = self.depth - generalized_index_depth(gi)
            idx = gi - (1 << generalized_index_depth(gi))
            out.append(self._node(level, idx))
        return out

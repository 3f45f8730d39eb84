"""Proto-array LMD-GHOST fork choice (reference consensus/proto_array:
flat node vector, O(n) score application and head finding,
proto_array.rs:70,167,644 and proto_array_fork_choice.rs:294).

The structure is a parent-pointer forest stored as an append-only list in
insertion order (children after parents), so score propagation is one
reverse sweep and best-descendant maintenance is O(1) per visited node.

The port's copy of lighthouse_tpu/fork_choice/proto_array.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ProtoArrayError(ValueError):
    pass


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: int | None
    justified_checkpoint: tuple[int, bytes]
    finalized_checkpoint: tuple[int, bytes]
    # what this block's state WOULD justify at its next epoch boundary
    # (fork_choice.rs unrealized_justifications; the voting source for
    # nodes from prior epochs, spec get_voting_source)
    unrealized_justified_checkpoint: tuple[int, bytes] | None = None
    weight: int = 0
    best_child: int | None = None
    best_descendant: int | None = None
    # optimistic-sync execution status (reference proto_array.rs
    # ExecutionStatus): "irrelevant" (pre-merge), "optimistic" (engine said
    # SYNCING/ACCEPTED), "valid", or "invalid"
    execution_status: str = "irrelevant"
    execution_block_hash: bytes = b""


@dataclass
class VoteTracker:
    """Latest message per validator (proto_array_fork_choice.rs VoteTracker)."""

    current_root: bytes = b""
    next_root: bytes = b""
    next_epoch: int = 0


class ProtoArray:
    def __init__(
        self,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        slots_per_epoch: int | None = None,
    ):
        self.nodes: list[ProtoNode] = []
        self.indices: dict[bytes, int] = {}
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self.current_epoch: int | None = None
        self.slots_per_epoch = slots_per_epoch
        self.prune_threshold = 256
        # finalized-ancestry memo (see _descends_from)
        self._descent_cache: dict[bytes, bool] = {}
        self._descent_cache_root: bytes | None = None

    # -- insertion (proto_array.rs on_block) --------------------------------

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes | None,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        execution_status: str = "irrelevant",
        execution_block_hash: bytes = b"",
        unrealized_justified_checkpoint: tuple[int, bytes] | None = None,
    ) -> None:
        if root in self.indices:
            return
        parent = self.indices.get(parent_root) if parent_root else None
        node = ProtoNode(
            slot=slot,
            root=root,
            parent=parent,
            justified_checkpoint=justified_checkpoint,
            finalized_checkpoint=finalized_checkpoint,
            unrealized_justified_checkpoint=unrealized_justified_checkpoint,
            execution_status=execution_status,
            execution_block_hash=bytes(execution_block_hash),
        )
        index = len(self.nodes)
        self.nodes.append(node)
        self.indices[root] = index
        if parent is not None:
            self._maybe_update_best_child_and_descendant(parent, index)

    # -- score changes (proto_array.rs:167 apply_score_changes) -------------

    def apply_score_changes(
        self,
        deltas: list[int],
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        proposer_boost_root: bytes | None = None,
        proposer_boost_amount: int = 0,
        current_epoch: int | None = None,
    ) -> None:
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError("deltas length != nodes length")
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self.current_epoch = current_epoch

        # proposer boost enters as an extra (transient) delta each run:
        # previous boost is subtracted by the caller via deltas
        if proposer_boost_root is not None:
            idx = self.indices.get(proposer_boost_root)
            if idx is not None:
                deltas[idx] += proposer_boost_amount

        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            delta = deltas[i]
            if delta:
                node.weight += delta
                if node.weight < 0:
                    raise ProtoArrayError("negative node weight")
                if node.parent is not None:
                    deltas[node.parent] += delta
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.parent is not None:
                self._maybe_update_best_child_and_descendant(node.parent, i)

    # -- head (proto_array.rs:644 find_head) --------------------------------

    def find_head(self, justified_root: bytes) -> bytes:
        idx = self.indices.get(justified_root)
        if idx is None:
            # checkpoint-synced view: the justified block can predate the
            # anchor (unrealized pull-up references pre-anchor epoch
            # roots). Every node descends from it THROUGH the anchor, so
            # the array root yields the same head.
            if not self.nodes:
                raise ProtoArrayError("justified root unknown to proto array")
            idx = 0
        node = self.nodes[idx]
        best = (
            self.nodes[node.best_descendant]
            if node.best_descendant is not None
            else node
        )
        if not self._node_is_viable_for_head(best):
            raise ProtoArrayError(
                "best node is not viable for head (justified/finalized mismatch)"
            )
        return best.root

    # -- maintenance ---------------------------------------------------------

    def _maybe_update_best_child_and_descendant(
        self, parent_index: int, child_index: int
    ) -> None:
        child = self.nodes[child_index]
        parent = self.nodes[parent_index]
        child_leads = (
            child.best_descendant
            if child.best_descendant is not None
            else child_index
        )
        child_viable = self._node_is_viable_for_head(self.nodes[child_leads])

        def make_best():
            parent.best_child = child_index
            parent.best_descendant = child_leads

        if parent.best_child is None:
            if child_viable:
                make_best()
            return
        if parent.best_child == child_index:
            if not child_viable:
                parent.best_child = None
                parent.best_descendant = None
                # try to find another viable child
                for i, n in enumerate(self.nodes):
                    if n.parent == parent_index and i != child_index:
                        self._maybe_update_best_child_and_descendant(
                            parent_index, i
                        )
            else:
                make_best()
            return
        best = self.nodes[parent.best_child]
        best_leads = (
            best.best_descendant
            if best.best_descendant is not None
            else parent.best_child
        )
        best_lead_node = self.nodes[best_leads]
        best_viable = self._node_is_viable_for_head(best_lead_node)
        if child_viable and not best_viable:
            make_best()
            return
        if not child_viable:
            return
        # node.weight is the SUBTREE weight (score sweeps propagate child
        # weights into parents), so direct children compare directly
        if child.weight > best.weight or (
            child.weight == best.weight and child.root > best.root
        ):
            make_best()

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        """Spec filter_block_tree viability: the node's voting source must
        match the store's justified checkpoint OR be recent (within 2
        epochs of current -- the unrealized-justification tolerance that
        keeps late-epoch nodes viable across the boundary pull-up), and
        the store's finalized checkpoint must be the node's own or an
        ancestor (epoch 0 wildcards accepted at genesis bootstrap)."""
        if node.execution_status == "invalid":
            return False
        # spec get_voting_source: a node from a PRIOR epoch votes with its
        # unrealized justification (its own boundary has passed)
        voting_source = node.justified_checkpoint
        if (
            self.current_epoch is not None
            and self.slots_per_epoch
            and node.slot // self.slots_per_epoch < self.current_epoch
            and node.unrealized_justified_checkpoint is not None
        ):
            voting_source = node.unrealized_justified_checkpoint
        j_ok = (
            self.justified_checkpoint[0] == 0
            or voting_source == self.justified_checkpoint
            or (
                self.current_epoch is not None
                and voting_source[0] + 2 >= self.current_epoch
            )
        )
        f_ok = (
            self.finalized_checkpoint[0] == 0
            or node.finalized_checkpoint == self.finalized_checkpoint
            or self._descends_from(node, self.finalized_checkpoint[1])
        )
        return j_ok and f_ok

    def _descends_from(self, node: ProtoNode, root: bytes) -> bool:
        """Memoized ancestry walk: the finalized-ancestry viability check
        runs per node per score sweep, so an uncached walk would make head
        recomputation O(n * depth). The cache is keyed to the finalized
        root and fills with path compression (every node on a walked path
        gets its verdict recorded)."""
        if self._descent_cache_root != root:
            self._descent_cache_root = root
            self._descent_cache = {}
        cache = self._descent_cache
        path = []
        idx = self.indices.get(node.root)
        verdict = False
        while idx is not None:
            n = self.nodes[idx]
            hit = cache.get(n.root)
            if hit is not None:
                verdict = hit
                break
            if n.root == root:
                verdict = True
                break
            path.append(n.root)
            idx = n.parent
        for r in path:
            cache[r] = verdict
        return verdict

    # -- optimistic-sync invalidation (proto_array.rs ExecutionStatus
    #    propagation; reference fork_choice.rs on_invalid_execution_payload) --

    def on_valid_execution_payload(self, root: bytes) -> None:
        """The engine confirmed a payload VALID: the block and all its
        ancestors with payloads become valid (a valid payload implies valid
        ancestry)."""
        idx = self.indices.get(root)
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status == "invalid":
                raise ProtoArrayError(
                    "engine said VALID for a block already known invalid"
                )
            if node.execution_status == "optimistic":
                node.execution_status = "valid"
            idx = node.parent

    def on_invalid_execution_payload(
        self, root: bytes, latest_valid_hash: bytes | None = None
    ) -> None:
        """Mark `root` and every descendant invalid; with a
        latest_valid_hash, also invalidate ancestors whose payloads come
        after it (they cannot be valid if a descendant's ancestry breaks
        there). Rebuilds the best-child links afterwards."""
        start = self.indices.get(root)
        if start is None:
            return
        invalid = {start}
        # ancestors back to latest_valid_hash
        if latest_valid_hash is not None:
            idx = self.nodes[start].parent
            while idx is not None:
                node = self.nodes[idx]
                if node.execution_block_hash == bytes(latest_valid_hash):
                    break
                if node.execution_status in ("optimistic", "invalid"):
                    invalid.add(idx)
                    idx = node.parent
                else:
                    break
        # descendants: nodes are insertion-ordered, parents precede children
        for i, n in enumerate(self.nodes):
            if n.parent in invalid:
                invalid.add(i)
        for i in invalid:
            if self.nodes[i].execution_status == "valid":
                # the engine vouched VALID for a block in the subtree it now
                # calls invalid -- surface the inconsistency loudly (the
                # valid path raises on the mirror-image conflict)
                raise ProtoArrayError(
                    "engine inconsistency: invalidating a subtree containing "
                    f"a VALID block {self.nodes[i].root.hex()[:12]}"
                )
        for i in invalid:
            self.nodes[i].execution_status = "invalid"
        self._rebuild_best_links()

    def _rebuild_best_links(self) -> None:
        for n in self.nodes:
            n.best_child = None
            n.best_descendant = None
        for i in range(len(self.nodes) - 1, -1, -1):
            # bottom-up so child_leads chains are already settled
            n = self.nodes[i]
            if n.parent is not None:
                self._maybe_update_best_child_and_descendant(n.parent, i)

    # -- pruning (proto_array.rs maybe_prune) --------------------------------

    def maybe_prune(self, finalized_root: bytes) -> None:
        idx = self.indices.get(finalized_root)
        if idx is None:
            raise ProtoArrayError("finalized root unknown")
        if idx < self.prune_threshold:
            return
        keep = self.nodes[idx:]
        self.indices = {}
        remap = {}
        for new_i, node in enumerate(keep):
            remap[idx + new_i] = new_i
        for new_i, node in enumerate(keep):
            node.parent = (
                remap.get(node.parent) if node.parent is not None else None
            )
            node.best_child = (
                remap.get(node.best_child)
                if node.best_child is not None
                else None
            )
            node.best_descendant = (
                remap.get(node.best_descendant)
                if node.best_descendant is not None
                else None
            )
            self.indices[node.root] = new_i
        self.nodes = keep


class ProtoArrayForkChoice:
    """Vote bookkeeping + deltas over the proto array
    (proto_array_fork_choice.rs:294)."""

    def __init__(
        self,
        finalized_slot: int,
        finalized_root: bytes,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        slots_per_epoch: int | None = None,
    ):
        self.proto_array = ProtoArray(
            justified_checkpoint, finalized_checkpoint, slots_per_epoch
        )
        self.votes: dict[int, VoteTracker] = {}
        self.balances: list[int] = []
        # validators proven to equivocate (attester slashings): their
        # latest message is removed and future votes are ignored
        # (proto_array_fork_choice.rs process_attester_slashing)
        self.equivocating_indices: set[int] = set()
        self.proposer_boost_root: bytes | None = None
        self._previous_boost: tuple[bytes, int] | None = None
        self.proto_array.on_block(
            finalized_slot,
            finalized_root,
            None,
            justified_checkpoint,
            finalized_checkpoint,
        )

    def process_block(
        self,
        slot,
        root,
        parent_root,
        justified_checkpoint,
        finalized_checkpoint,
        execution_status: str = "irrelevant",
        execution_block_hash: bytes = b"",
        unrealized_justified_checkpoint=None,
    ):
        self.proto_array.on_block(
            slot,
            root,
            parent_root,
            justified_checkpoint,
            finalized_checkpoint,
            execution_status,
            execution_block_hash,
            unrealized_justified_checkpoint,
        )

    def on_valid_execution_payload(self, root: bytes) -> None:
        self.proto_array.on_valid_execution_payload(root)

    def on_invalid_execution_payload(
        self, root: bytes, latest_valid_hash: bytes | None = None
    ) -> None:
        self.proto_array.on_invalid_execution_payload(root, latest_valid_hash)

    def execution_status_of(self, root: bytes) -> str | None:
        idx = self.proto_array.indices.get(root)
        return self.proto_array.nodes[idx].execution_status if idx is not None else None

    def is_optimistic(self, root: bytes) -> bool:
        return self.execution_status_of(root) == "optimistic"

    def process_attester_slashing(self, validator_index: int) -> None:
        """Equivocation proven: drop the validator's fork-choice weight
        permanently. The vote removal itself happens lazily in
        _compute_deltas on the next find_head."""
        self.equivocating_indices.add(validator_index)

    def process_attestation(
        self, validator_index: int, block_root: bytes, target_epoch: int
    ):
        if validator_index in self.equivocating_indices:
            return
        vote = self.votes.setdefault(validator_index, VoteTracker())
        # a fresh tracker accepts any vote (incl. target epoch 0 in the
        # chain's first epoch -- the reference's `vote == default` escape)
        is_fresh = not vote.next_root and not vote.current_root
        if is_fresh or target_epoch > vote.next_epoch:
            vote.next_root = block_root
            vote.next_epoch = target_epoch

    def find_head(
        self,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        justified_state_balances: list[int],
        proposer_boost_amount: int = 0,
        current_epoch: int | None = None,
    ) -> bytes:
        new_balances = justified_state_balances
        deltas = self._compute_deltas(new_balances)

        # proposer boost: subtract previous boost, add current
        if self._previous_boost is not None:
            root, amount = self._previous_boost
            idx = self.proto_array.indices.get(root)
            if idx is not None:
                deltas[idx] -= amount
            self._previous_boost = None
        boost_root = None
        if self.proposer_boost_root is not None and proposer_boost_amount:
            boost_root = self.proposer_boost_root
            self._previous_boost = (boost_root, proposer_boost_amount)

        self.proto_array.apply_score_changes(
            deltas,
            justified_checkpoint,
            finalized_checkpoint,
            boost_root,
            proposer_boost_amount,
            current_epoch,
        )
        self.balances = list(new_balances)
        return self.proto_array.find_head(justified_checkpoint[1])

    def _compute_deltas(self, new_balances: list[int]) -> list[int]:
        """proto_array_fork_choice.rs compute_deltas: one delta per node
        from changed validator votes and balance changes."""
        deltas = [0] * len(self.proto_array.nodes)
        for validator, vote in self.votes.items():
            old_balance = (
                self.balances[validator]
                if validator < len(self.balances)
                else 0
            )
            new_balance = (
                new_balances[validator]
                if validator < len(new_balances)
                else 0
            )
            if validator in self.equivocating_indices:
                # remove the latest message once; the dead tracker then
                # never re-enters (process_attestation ignores the index)
                if vote.current_root:
                    idx = self.proto_array.indices.get(vote.current_root)
                    if idx is not None:
                        deltas[idx] -= old_balance
                vote.current_root = b""
                vote.next_root = b""
                continue
            if vote.current_root == vote.next_root and old_balance == new_balance:
                continue
            idx = self.proto_array.indices.get(vote.current_root)
            if idx is not None:
                deltas[idx] -= old_balance
            idx = self.proto_array.indices.get(vote.next_root)
            if idx is not None:
                deltas[idx] += new_balance
            vote.current_root = vote.next_root
        return deltas

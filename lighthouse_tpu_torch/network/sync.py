"""Sync algorithms over the req/resp protocols (reference
beacon_node/network/src/sync/: manager.rs dispatch, range_sync/ batched
forward sync with peer pools and retries, backfill_sync/ reverse fill
from a checkpoint anchor, block_lookups/ unknown-parent chasing).

The transport is whatever the node's bus speaks (in-process bus or the
socket-backed wire stack); the algorithms only use STATUS /
BLOCKS_BY_RANGE / BLOCKS_BY_ROOT requests plus the node's peer-score
table, mirroring how the reference's SyncManager drives
lighthouse_network through NetworkService messages.

The port's copy of lighthouse_tpu/network/sync.py.
"""

from __future__ import annotations

from ..chain.beacon_chain import BlockError

BATCH_SIZE = 32  # reference range_sync EPOCHS_PER_BATCH * slots (minimal)
MAX_BATCH_RETRIES = 3  # batch.rs MAX_BATCH_DOWNLOAD_ATTEMPTS
MAX_PARENT_DEPTH = 16  # block_lookups PARENT_DEPTH_TOLERANCE


class SyncManager:
    def __init__(
        self,
        node,
        batch_size: int = BATCH_SIZE,
        max_batch_retries: int = MAX_BATCH_RETRIES,
    ):
        self.node = node
        self.batch_size = batch_size
        self.max_batch_retries = max_batch_retries

    # -- peer pool -----------------------------------------------------------

    def _candidate_peers(self) -> list[str]:
        node = self.node
        peers = node.bus.peers_on(node._topic_block)
        return [
            p for p in peers if p != node.peer_id and not node.is_banned(p)
        ]

    def peer_status(self, peer: str) -> dict | None:
        from .node import STATUS_PROTOCOL

        try:
            return self.node.bus.request(
                self.node.peer_id, peer, STATUS_PROTOCOL, {}
            )
        except (ConnectionError, OSError):
            self.node.penalize(peer, -1)
            return None

    def _ranked_ahead(self) -> list[tuple[str, dict]]:
        """Peers whose head is ahead of ours, best head first
        (peer_manager's sync-committee peer selection seat)."""
        our_slot = self.node.chain.head_state.slot
        out = []
        for p in self._candidate_peers():
            status = self.peer_status(p)
            if status is not None and status["head_slot"] > our_slot:
                out.append((p, status))
        out.sort(key=lambda t: t[1]["head_slot"], reverse=True)
        return out

    # -- forward range sync (range_sync/chain.rs) ---------------------------

    def _request_batch(self, start_slot: int, count: int, peers: list[str]):
        """Try each peer in order until one returns a batch; penalize
        transport failures (which consume retry budget — an empty answer
        is a legitimate "I don't have that range" and does not).
        Returns (blocks, peer) or (None, None)."""
        from .node import BLOCKS_BY_RANGE

        failures = 0
        for peer in peers:
            if failures >= self.max_batch_retries:
                break
            try:
                blocks = self.node.bus.request(
                    self.node.peer_id,
                    peer,
                    BLOCKS_BY_RANGE,
                    {"start_slot": start_slot, "count": count},
                )
            except (ConnectionError, OSError):
                self.node.penalize(peer, -1)
                failures += 1
                continue
            if blocks:
                return blocks, peer
        return None, None

    def _import_batch(self, blocks) -> tuple[int, bool]:
        """Import a batch: segment-batched signature verification (ONE
        backend call for the whole parent-linked run,
        block_verification.rs:525) with a per-block fallback for segments
        that don't link cleanly. Returns (imported, progressed)."""
        from ..chain.block_verification import (
            signature_verify_chain_segment,
        )
        from ..state_transition import BlockSignatureStrategy

        chain = self.node.chain
        imported = 0
        # manual clocks (tests) advance with the sync frontier; a system
        # clock is already at wall time and has no set_slot
        set_slot = getattr(chain.slot_clock, "set_slot", None)
        if set_slot is not None and blocks:
            set_slot(
                max(chain.current_slot, max(b.message.slot for b in blocks))
            )
        try:
            verified = signature_verify_chain_segment(chain, list(blocks))
        except BlockError:
            verified = None
        if verified is not None:
            for sv in verified:
                try:
                    sv.import_into(chain)  # reuses the advanced pre-state
                    imported += 1
                except BlockError:
                    # every later block descends from this one; continuing
                    # with pre-states would install detached roots
                    break
            return imported, imported > 0
        for blk in blocks:  # fallback: per-block full verification
            try:
                chain.process_block(blk)
                imported += 1
            except BlockError:
                continue
        return imported, imported > 0

    def range_sync(self) -> int:
        """Catch the chain up to the best peers' head in batches; returns
        blocks imported. Peers are statused once per ranking round (the
        reference re-ranks only on batch failure, range_sync/chain.rs) and
        failed batches rotate to the next-best peer."""
        chain = self.node.chain
        imported = 0
        while True:
            ranked = self._ranked_ahead()
            if not ranked:
                break
            peers = [p for p, _ in ranked]
            target = ranked[0][1]["head_slot"]
            while chain.head_state.slot < target:
                start = chain.head_state.slot + 1
                blocks, peer = self._request_batch(
                    start, self.batch_size, peers
                )
                if blocks is None:
                    return imported
                got, progressed = self._import_batch(blocks)
                imported += got
                if not progressed:
                    # the batch may be an honest peer's FORK: its blocks
                    # descend from an ancestor we don't hold (a healed
                    # partition's other side). Chase the missing parent
                    # chain by root first (block_lookups) and retry; only
                    # a batch that STILL doesn't apply is penalized —
                    # banning honest fork-peers here is a liveness bug
                    # (the heal would never converge).
                    first_parent = bytes(blocks[0].message.parent_root)
                    if first_parent not in chain._states and self.lookup_block(
                        first_parent
                    ):
                        got, progressed = self._import_batch(blocks)
                        imported += got
                if not progressed:
                    # peer served a batch we can't use (bad chain / gap):
                    # penalize and re-rank — repeated offenders get banned
                    self.node.penalize(peer)
                    break
            # outer loop re-ranks: catches peers that advanced meanwhile;
            # terminates when no peer is ahead (or offenders are banned)
        return imported

    def sync_from(self, peer: str) -> int:
        """Single-peer forward sync (the old NetworkNode.sync_with)."""
        chain = self.node.chain
        status = self.peer_status(peer)
        if status is None:
            return 0
        imported = 0
        while chain.head_state.slot < status["head_slot"]:
            blocks, _ = self._request_batch(
                chain.head_state.slot + 1, self.batch_size, [peer]
            )
            if blocks is None:
                break
            got, progressed = self._import_batch(blocks)
            imported += got
            if not progressed:
                break
        return imported

    # -- backfill sync (backfill_sync/mod.rs) -------------------------------

    def backfill_sync(self) -> int:
        """Fill history below the anchor down to genesis: request ranges
        ending at the anchor, verify the hash chain links into the anchor's
        parent_root, and store the blocks without replaying them
        (historical_blocks.rs import_historical_block_batch)."""
        chain = self.node.chain
        stored = 0
        while chain.oldest_block_slot > 0 and any(chain.oldest_block_parent):
            start = max(0, chain.oldest_block_slot - self.batch_size)
            count = chain.oldest_block_slot - start
            blocks, peer = self._request_batch(
                start, count, self._candidate_peers()
            )
            if blocks is None:
                break
            # ascending batch must hash-chain and link into the anchor
            ok = True
            for a, b in zip(blocks, blocks[1:]):
                if bytes(b.message.parent_root) != a.message.tree_hash_root():
                    ok = False
                    break
            if ok and blocks[-1].message.tree_hash_root() != bytes(
                chain.oldest_block_parent
            ):
                ok = False
            if not ok:
                self.node.penalize(peer)
                continue
            # blocks + the advanced anchor commit atomically: a crash
            # between them would otherwise leave an anchor claiming
            # history the store does not hold (or vice versa)
            batch = chain.store.batch()
            for blk in blocks:
                chain.store.put_block(
                    blk.message.tree_hash_root(), blk, batch=batch
                )
                stored += 1
            first = blocks[0].message
            anchor_root = first.tree_hash_root()
            anchor_parent = bytes(first.parent_root)
            batch.stage_chain_item(b"oldest_block_root", anchor_root)
            batch.stage_chain_item(
                b"oldest_block_meta",
                first.slot.to_bytes(8, "little") + anchor_parent,
            )
            batch.commit()
            # in-memory mirrors advance only AFTER the batch is durable
            # (migrate_to_freezer's idiom): a failed commit must not leave
            # the running node claiming history the store does not hold
            chain.oldest_block_root = anchor_root
            chain.oldest_block_slot = first.slot
            chain.oldest_block_parent = anchor_parent
        return stored

    # -- unknown-block lookups (block_lookups/mod.rs) -----------------------

    def lookup_block(self, block_root: bytes) -> bool:
        """Fetch a block by root and import it, chasing unknown parents up
        to MAX_PARENT_DEPTH (the reference's parent-lookup chain)."""
        from .node import BLOCKS_BY_ROOT

        chain = self.node.chain
        to_import = []
        root = bytes(block_root)
        for _ in range(MAX_PARENT_DEPTH):
            if root in chain._states:
                break  # found the attachment point
            found = None
            for peer in self._candidate_peers():
                try:
                    blocks = self.node.bus.request(
                        self.node.peer_id,
                        peer,
                        BLOCKS_BY_ROOT,
                        {"roots": [root]},
                    )
                except (ConnectionError, OSError):
                    self.node.penalize(peer, -1)
                    continue
                if blocks and blocks[0].message.tree_hash_root() == root:
                    # a peer substituting a different (even valid) block
                    # must not satisfy the lookup
                    found = blocks[0]
                    break
                if blocks:
                    self.node.penalize(peer)
            if found is None:
                return False
            to_import.append(found)
            root = bytes(found.message.parent_root)
        else:
            return False  # parent chain too deep
        set_slot = getattr(chain.slot_clock, "set_slot", None)
        for blk in reversed(to_import):
            try:
                if set_slot is not None:
                    set_slot(max(chain.current_slot, blk.message.slot))
                chain.process_block(blk)
            except BlockError:
                return False
        return True

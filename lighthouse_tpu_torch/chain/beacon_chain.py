"""BeaconChain: the core chain runtime (reference
beacon_node/beacon_chain/src/beacon_chain.rs -- process_block:2520,
canonical head recompute, per-slot tasks). Wires store, fork choice, state
transition, and the signature backend on the card behind one object.

Block verification follows the reference's typestate pipeline
(block_verification.rs:588-619): gossip checks -> batched signature
verification (BlockSignatureVerifier, ONE backend call) -> state
transition -> fork-choice import -> head update.

The port's copy of lighthouse_tpu/chain/beacon_chain.py.
"""

from __future__ import annotations

from ..crypto.bls.api import verify_signature_sets
from ..fork_choice import ForkChoice, ForkChoiceError
from ..ssz import cached_root
from ..state_transition import (
    BlockProcessingError,
    BlockSignatureStrategy,
    ConsensusContext,
    clone_state,
    per_block_processing,
    process_slots,
)
from ..types import compute_epoch_at_slot, compute_start_slot_at_epoch
from ..types.presets import Preset
from ..store.hot_cold import HotColdDB, StoreError
from ..utils.slot_clock import ManualSlotClock
from ..utils.timeout_lock import TimeoutRLock


class BlockError(ValueError):
    pass


class BeaconChain:
    def __init__(
        self,
        store: HotColdDB,
        genesis_state,
        preset: Preset,
        spec,
        slot_clock=None,
        device=None,
    ):
        self.store = store
        self.preset = preset
        self.spec = spec
        self.slot_clock = slot_clock or ManualSlotClock(
            genesis_state.genesis_time, spec.seconds_per_slot
        )
        # anchor the continuous-batching scheduler's per-lane verdict-
        # delay histograms on this chain's injected clock (no-op unless
        # LIGHTHOUSE_TPU_CONT_BATCH routes lanes through the scheduler)
        from ..crypto.bls import scheduler as bls_scheduler

        bls_scheduler.set_slot_clock(self.slot_clock)

        genesis_state_root = genesis_state.tree_hash_root()
        # the canonical genesis block root: header with state_root filled,
        # exactly as the first process_slot will reference it
        from ..types.containers import BeaconBlockHeader

        hdr = genesis_state.latest_block_header
        genesis_root = BeaconBlockHeader(
            slot=hdr.slot,
            proposer_index=hdr.proposer_index,
            parent_root=hdr.parent_root,
            state_root=(
                bytes(hdr.state_root)
                if any(bytes(hdr.state_root))
                else genesis_state_root
            ),
            body_root=hdr.body_root,
        ).tree_hash_root()
        self.genesis_block_root = genesis_root

        # genesis checkpoints with zero roots alias the genesis block
        def _ckpt(cp):
            root = bytes(cp.root)
            return (cp.epoch, root if any(root) else genesis_root)

        jc = _ckpt(genesis_state.current_justified_checkpoint)
        fc = _ckpt(genesis_state.finalized_checkpoint)

        from ..fork_choice.fork_choice import _justified_balances

        self.fork_choice = ForkChoice(
            preset,
            spec,
            genesis_state.slot,
            genesis_root,
            jc,
            fc,
            state_lookup=lambda root: self._states.get(root),
        )
        self.fork_choice.justified_balances = _justified_balances(
            genesis_state, preset
        )
        # highest finalized epoch announced on event_sinks (events.rs
        # finalized_checkpoint stream); imports past this emit once
        self._finality_emitted_epoch = int(fc[0])

        # genesis/anchor init is ONE atomic batch: the state row, its
        # post-state mapping, the head pointer pair, and the anchors
        # commit together, so a crash mid-init leaves either a fresh
        # empty store or a complete chain — never a head pointing at a
        # state that was not written (write-ahead journal, store/kv.py)
        init_batch = store.batch()
        store.put_state(genesis_state_root, genesis_state, batch=init_batch)
        init_batch.stage_chain_item(
            b"block_post_state:" + genesis_root, genesis_state_root
        )
        init_batch.stage_chain_item(b"head_block_root", genesis_root)
        init_batch.stage_chain_item(b"head_state_root", genesis_state_root)
        # stable anchor for the freezer's chunked block-root fill (slot 0's
        # "block" is the genesis header, never a stored block). Keep an
        # existing anchor: a FromStore re-init passes the RESUMED head
        # state through here, which must not clobber the true genesis root.
        if store.get_chain_item(b"genesis_block_root") is None:
            init_batch.stage_chain_item(b"genesis_block_root", genesis_root)
        self.head_root = genesis_root
        self.head_state = clone_state(genesis_state)
        # bounded snapshot cache over the store (snapshot_cache.rs seat):
        # membership = every non-finalized block root; only recently-used
        # states stay materialized, misses replay from store snapshots
        from .state_cache import StateCache

        self._states = StateCache(store)
        self._states[genesis_root] = genesis_state
        # backfill anchor (historical_blocks.rs oldest_block_slot): the
        # earliest block this node holds; genesis start = nothing to fill.
        # Persisted so from_store restarts don't re-backfill known history.
        # Keep an existing anchor, like genesis_block_root above: a
        # FromStore re-init runs this with the RESUMED head state, and
        # clobbering the persisted anchor with the head (even transiently,
        # for from_store to restore in a later batch) opens a crash window
        # that durably re-anchors backfill at the head. from_anchor and
        # sync backfill advance the anchor through their own batches.
        self.oldest_block_root = genesis_root
        self.oldest_block_slot = genesis_state.slot
        self.oldest_block_parent = bytes(
            genesis_state.latest_block_header.parent_root
        )
        if store.get_chain_item(b"oldest_block_root") is None:
            init_batch.stage_chain_item(b"oldest_block_root", genesis_root)
            init_batch.stage_chain_item(
                b"oldest_block_meta",
                genesis_state.slot.to_bytes(8, "little")
                + self.oldest_block_parent,
            )
        init_batch.commit()
        # decompressed-pubkey cache + device-resident limb table
        # (validator_pubkey_cache.rs): decompress once at startup, append on
        # deposit processing; verification paths resolve keys through it.
        # `device` is the table's: None is the card, "cpu" only when asked
        from .pubkey_cache import ValidatorPubkeyCache

        self.pubkey_cache = ValidatorPubkeyCache(genesis_state, device=device)
        # optional engine handle (reference beacon_chain.execution_layer);
        # None = pre-merge / no EL configured
        self.execution_layer = None
        # SSE event subscribers (events.rs): fn(kind: str, payload: dict)
        self.event_sinks: list = []
        # optional per-validator observability (validator_monitor.rs)
        self.validator_monitor = None
        # attest-to-fresh-block fast path (early_attester_cache.rs)
        from .early_attester_cache import EarlyAttesterCache

        self.early_attester_cache = EarlyAttesterCache()
        # merge-transition blocks imported before their pow data was
        # available: block_root -> payload parent hash, re-checked each
        # tick (otb_verification_service.rs). PERSISTED: a pending TTD
        # re-verification must survive a restart, or the node permanently
        # follows an invalid payload subtree.
        self.optimistic_transition_blocks: dict[bytes, bytes] = {}
        self._otb_checked_slot = -1
        # timeout-guarded chain lock (timeout_rw_lock.rs seat): gossip
        # workers, the tick loop, and HTTP handlers all mutate chain
        # state; compound read-modify-write sequences must not
        # interleave, and a stuck holder raises instead of deadlocking
        self.lock = TimeoutRLock("beacon_chain")
        from ..store.kv import Column as _Col

        for key in self.store.kv.keys(_Col.CHAIN):
            if bytes(key).startswith(b"otb:"):
                parent = self.store.get_chain_item(key)
                if parent:
                    self.optimistic_transition_blocks[bytes(key)[4:]] = parent

    def emit(self, kind: str, payload: dict) -> None:
        for sink in self.event_sinks:
            sink(kind, payload)

    # -- alternative genesis resolution (client/src/config.rs:15-40) --------

    @classmethod
    def from_anchor(
        cls,
        store: HotColdDB,
        anchor_state,
        anchor_block,
        preset: Preset,
        spec,
        slot_clock=None,
        device=None,
    ) -> "BeaconChain":
        """Checkpoint-sync start (ClientGenesis::CheckpointSyncUrl /
        WeakSubjSszBytes, client/src/builder.rs:206-340): initialize from a
        finalized (state, block) pair instead of genesis. History below the
        anchor is absent until backfill fills it."""
        block = anchor_block.message
        block_root = block.tree_hash_root()
        state_root = cached_root(anchor_state)
        if bytes(block.state_root) != state_root:
            raise BlockError("anchor state does not match anchor block")
        chain = cls(
            store, anchor_state, preset, spec, slot_clock=slot_clock, device=device
        )
        if chain.genesis_block_root != block_root:
            raise BlockError("anchor state header does not match anchor block")
        chain.oldest_block_root = block_root
        chain.oldest_block_slot = block.slot
        chain.oldest_block_parent = bytes(block.parent_root)
        batch = store.batch()
        store.put_block(block_root, anchor_block, batch=batch)
        batch.stage_chain_item(b"oldest_block_root", block_root)
        batch.stage_chain_item(
            b"oldest_block_meta",
            block.slot.to_bytes(8, "little") + chain.oldest_block_parent,
        )
        batch.commit()
        return chain

    @classmethod
    def from_store(
        cls, store: HotColdDB, preset: Preset, spec, slot_clock=None, device=None
    ) -> "BeaconChain":
        """Node-restart resume (ClientGenesis::FromStore): reload the
        persisted chain and continue.

        Fork choice is re-anchored at the persisted FINALIZED checkpoint
        (when one resolves) and rebuilt by replaying the store's hot
        blocks above it — the seat of the reference's persisted fork
        choice. Anchoring at the raw head pointer would pin the proto
        array to whatever block happened to be head at the crash; if
        that block was a PRIVATE fork (produced and imported locally,
        killed before gossip), the node could never reorg onto the
        canonical chain its peers extended — the stuck-forever state the
        crash-recovery scenario asserts against.

        A corrupt head pointer (head_block_root that resolves to no
        stored block/state) is survivable: the node logs loudly and
        falls back to the persisted finalized checkpoint — losing the
        unfinalized tip beats refusing to start (the reference recovers
        the same way via fork_revert / the anchor on disk)."""
        from ..store.kv import Column as _Col

        head_root = store.get_chain_item(b"head_block_root")
        state_root = store.get_chain_item(b"head_state_root")
        if head_root is None or state_root is None:
            raise BlockError("store holds no persisted chain")
        # cheap head-resolvability probe (the fsck check): mapping exists
        # and the state row (full or summary) is present. The expensive
        # get_state replay of the head is NOT paid when the finalized
        # anchor is used — _replay_hot_blocks rebuilds the tip anyway.
        mapped = store.get_chain_item(b"block_post_state:" + head_root)
        head_resolvable = mapped is not None and (
            store.kv.get(_Col.STATE, mapped) is not None
            or store.kv.get(_Col.STATE_SUMMARY, mapped) is not None
        )
        if not head_resolvable:
            from ..utils.logging import Logger

            Logger(level="error").child(service="chain").crit(
                "head pointer corrupt; falling back to finalized checkpoint",
                head=head_root.hex(),
            )
        # pre-finality chains have no finalized_block_root yet: the
        # finalized checkpoint IS genesis, so anchor there
        fin_root = store.get_chain_item(
            b"finalized_block_root"
        ) or store.get_chain_item(b"genesis_block_root")
        anchor_state = None
        if fin_root is not None and (
            fin_root != head_root or not head_resolvable
        ):
            fin_state_root = store.get_chain_item(
                b"block_post_state:" + fin_root
            )
            if fin_state_root is not None:
                try:
                    anchor_state = store.get_state(fin_state_root)
                except StoreError:
                    anchor_state = None  # fall through to head anchoring
        if anchor_state is None:
            if not head_resolvable:
                raise BlockError("persisted head state missing")
            try:
                # get_state replays from the nearest stored snapshot when
                # the head landed between snapshot slots (summary entry)
                anchor_state = store.get_state(state_root)
            except StoreError as e:
                raise BlockError(
                    f"persisted head AND finalized states missing: {e}"
                ) from None
        # the persisted anchor survives __init__ untouched (its keep-existing
        # guard); only the in-memory mirror needs restoring — no store write,
        # so there is no crash window that could tear the anchor
        oldest = store.get_chain_item(b"oldest_block_root")
        meta = store.get_chain_item(b"oldest_block_meta")
        chain = cls(
            store, anchor_state, preset, spec, slot_clock=slot_clock, device=device
        )
        if oldest is not None and meta is not None:
            chain.oldest_block_root = oldest
            chain.oldest_block_slot = int.from_bytes(meta[:8], "little")
            chain.oldest_block_parent = meta[8:]
        # pass the ORIGINAL head pointer: __init__ just re-persisted the
        # anchor as the head, so the store's copy no longer names the tip
        chain._replay_hot_blocks(head_root)
        return chain

    def _replay_hot_blocks(self, persisted_head: bytes | None = None) -> None:
        """Rebuild fork choice from the store's hot blocks above the
        anchor (FromStore's persisted-fork-choice seat): every stored
        non-finalized fork re-imports in slot order, so the resumed node
        can still reorg between them once votes arrive. Signature
        re-verification is skipped — these blocks were verified before
        they were stored. Blocks that no longer attach (pruned parents,
        stale sub-finality forks) are skipped; resume must not refuse to
        start over a dangling row."""
        from ..store.kv import Column as _Col

        anchor_slot = int(self.head_state.slot)
        by_root: dict[bytes, object] = {}
        for root in self.store.kv.keys(_Col.BLOCK):
            blk = self.store.get_block(root)
            if blk is not None and int(blk.message.slot) > anchor_slot:
                by_root[bytes(root)] = blk
        # the persisted head's ancestry may dip into the FREEZER: a crash
        # between a migration's content sub-batches and its split-slot
        # marker leaves canonical blocks frozen while the stale marker
        # anchors us below them — walk the head pointer down to the
        # anchor through both temperatures so the tip still re-imports
        root = (
            persisted_head
            if persisted_head is not None
            else self.store.get_chain_item(b"head_block_root")
        )
        while root and any(root):
            r = bytes(root)
            blk = by_root.get(r) or self.store.get_block_any_temperature(r)
            if blk is None or int(blk.message.slot) <= anchor_slot:
                break
            by_root[r] = blk
            root = bytes(blk.message.parent_root)
        blocks = list(by_root.values())
        if not blocks:
            return
        blocks.sort(key=lambda b: (int(b.message.slot), b.message.tree_hash_root()))
        set_slot = getattr(self.slot_clock, "set_slot", None)
        if set_slot is not None:
            set_slot(
                max(
                    self.current_slot,
                    max(int(b.message.slot) for b in blocks),
                )
            )
        for blk in blocks:
            try:
                self.process_block(
                    blk, strategy=BlockSignatureStrategy.NO_VERIFICATION
                )
            except BlockError:
                continue

    # -- time ----------------------------------------------------------------

    @property
    def current_slot(self) -> int:
        return self.slot_clock.current_slot()

    def on_tick(self) -> None:
        with self.lock:
            self.fork_choice.on_tick(self.current_slot)
            # throttle OTB re-verification to once per slot
            # (otb_verification_service.rs polls on epoch intervals)
            slot = self.current_slot
            run_otb = slot != self._otb_checked_slot
            if run_otb:
                self._otb_checked_slot = slot
        if run_otb:
            # engine polling happens OUTSIDE the chain lock: a hung EL
            # endpoint must delay only OTB checks, not block import
            self.verify_optimistic_transition_blocks()

    def verify_optimistic_transition_blocks(self) -> None:
        """Re-check merge-transition blocks imported while their pow data
        was unavailable (otb_verification_service.rs): once the EL can
        serve the pow chain, a TTD-invalid transition block invalidates
        its payload subtree in fork choice. Engine round-trips run
        unlocked; only the fork-choice mutation takes the chain lock."""
        if self.execution_layer is None:
            return
        for root, parent_hash in list(
            self.optimistic_transition_blocks.items()
        ):
            if root not in self.fork_choice.proto.proto_array.indices:
                # pruned out of fork choice (finalized past, or already
                # discarded): nothing left to re-verify -- without this,
                # an engine with no pow surface re-polls forever
                self.optimistic_transition_blocks.pop(root, None)
                self.store.delete_chain_item(b"otb:" + root)
                continue
            verdict = self.execution_layer.validate_merge_block(
                parent_hash, self.spec
            )
            if verdict is None:
                continue  # still no pow data; keep waiting
            self.optimistic_transition_blocks.pop(root, None)
            self.store.delete_chain_item(b"otb:" + root)
            if verdict is False:
                with self.lock:
                    self.fork_choice.on_invalid_execution_payload(root)
                self.recompute_head()

    # -- block import (beacon_chain.rs:2520 process_block) ------------------

    def state_for_block_production(self, slot: int):
        with self.lock:
            state = clone_state(self.head_state)
        return process_slots(state, slot, self.preset, self.spec)

    def process_block(
        self,
        signed_block,
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
        pre_state=None,
    ) -> bytes:
        """Full import: signature batch -> transition -> store -> fork
        choice -> head update. Returns the block root. Phases are timed
        into the metrics registry (reference metrics.rs:37-80
        BLOCK_PROCESSING_* family)."""
        from ..utils import metrics as M
        from ..utils import tracing

        with self.lock, M.BLOCK_PROCESSING_TIMES.time(), tracing.span(
            "block_import", slot=int(signed_block.message.slot)
        ):
            try:
                block_root, fresh = self._process_block_timed(
                    signed_block, strategy, pre_state
                )
            except BlockError:
                M.BLOCKS_REJECTED.inc()
                raise
        if not fresh:
            return block_root  # duplicate: no metrics, no monitor
        M.BLOCKS_IMPORTED.inc()
        M.observe_slot_delay(
            M.BLOCK_IMPORTED_DELAY,
            self.slot_clock,
            int(signed_block.message.slot),
        )
        if self.validator_monitor is not None:
            # import time comes from the injected slot clock, so a replay
            # of the same blocks reports the same timings (wallclock rule)
            self.validator_monitor.on_block_imported(
                block_root, signed_block.message, self.slot_clock.now()
            )
        return block_root

    def _process_block_timed(self, signed_block, strategy, pre_state=None):
        from ..utils import metrics as M
        from ..utils import tracing

        self.on_tick()
        block = signed_block.message
        if block.slot > self.current_slot:
            # checked BEFORE any transition/store work: fork choice would
            # reject it anyway, but only after a partial import
            raise BlockError("block from the future")
        block_root = block.tree_hash_root()
        if block_root in self._states:
            return block_root, False  # duplicate import

        parent_root = bytes(block.parent_root)
        if parent_root not in self._states:
            # checked on BOTH paths: importing on a pre-state whose parent
            # was never imported would register a detached fork-choice root
            raise BlockError(f"unknown parent {parent_root.hex()[:12]}")
        if pre_state is not None:
            # gossip pipeline already cloned + slot-advanced the parent
            # (block_verification.rs ExecutionPendingBlock state reuse)
            state = pre_state
        else:
            parent_state = self._states[parent_root]
            state = clone_state(parent_state)
            with M.BLOCK_TRANSITION_TIMES.time():
                state = process_slots(
                    state, block.slot, self.preset, self.spec
                )
        ctxt = ConsensusContext(self.preset, self.spec)
        # merge-transition TTD validation (spec validate_merge_block via
        # the EL's pow surface): provably wrong terminal blocks are
        # rejected; unavailable pow data imports optimistically and the
        # OTB service re-checks on ticks
        otb_parent_hash = None
        if self.execution_layer is not None and hasattr(
            block.body, "execution_payload"
        ):
            from ..state_transition.per_block import is_merge_transition_block

            if is_merge_transition_block(state, block.body):
                parent_hash = bytes(block.body.execution_payload.parent_hash)
                verdict = self.execution_layer.validate_merge_block(
                    parent_hash, self.spec
                )
                if verdict is False:
                    raise BlockError(
                        "merge transition block fails TTD validation"
                    )
                if verdict is None:
                    otb_parent_hash = parent_hash
        if self.execution_layer is not None:
            # engine round trip runs INSIDE process_execution_payload (spec
            # order: after the parent-hash/randao/timestamp checks); the
            # hook records the verdict on the context for fork choice.
            def _notify(payload, _ctxt=ctxt):
                status = self.execution_layer.notify_new_payload(payload)
                _ctxt.payload_verification_status = status
                return True

            ctxt.notify_new_payload = _notify
        try:
            with M.BLOCK_TRANSITION_TIMES.time(), tracing.span(
                "block_transition"
            ):
                per_block_processing(
                    state,
                    signed_block,
                    self.preset,
                    self.spec,
                    strategy=strategy,
                    ctxt=ctxt,
                    # table-tagged keys: the bulk batch gathers limb rows
                    # from the device-resident pubkey table, so block
                    # import is one device program
                    get_pubkey=self.pubkey_cache.getter(state),
                    resolve_pubkey=self.pubkey_cache.resolve,
                )
        except BlockProcessingError as e:
            raise BlockError(str(e)) from None
        except Exception as e:
            from ..execution_layer import PayloadInvalid

            if isinstance(e, PayloadInvalid):
                raise BlockError(f"invalid execution payload: {e}") from None
            raise

        execution_status = "irrelevant"
        execution_block_hash = b""
        if ctxt.payload_verification_status is not None:
            from ..execution_layer import PayloadVerificationStatus

            execution_block_hash = bytes(
                block.body.execution_payload.block_hash
            )
            execution_status = (
                "valid"
                if ctxt.payload_verification_status
                is PayloadVerificationStatus.VERIFIED
                else "optimistic"
            )
        with M.BLOCK_STATE_ROOT_TIMES.time(), tracing.span("state_root"):
            state_root = cached_root(state)
        if bytes(block.state_root) != state_root:
            raise BlockError("block state_root mismatch")

        # deposits may have appended validators: decompress + upload the
        # new keys now (import_new_pubkeys, validator_pubkey_cache.rs:79)
        self.pubkey_cache.import_new_pubkeys(state)

        # the block row, its post-state, the post-state mapping, and any
        # OTB marker commit as ONE atomic batch: a crash mid-import can
        # never store a block whose state (or mapping) is missing
        import_batch = self.store.batch()
        self.store.put_block(block_root, signed_block, batch=import_batch)
        # drop the incremental-hash cache before retaining: stored states
        # are never re-rooted in place (later work clones them), so keeping
        # the merkle layers would ~double per-state memory for nothing
        state.__dict__.pop("_lh_tree_cache", None)
        self.store.put_state(state_root, state, batch=import_batch)
        import_batch.stage_chain_item(
            b"block_post_state:" + block_root, state_root
        )
        if otb_parent_hash is not None:
            import_batch.stage_chain_item(
                b"otb:" + block_root, otb_parent_hash
            )
        import_batch.commit()
        self._states[block_root] = state
        self.early_attester_cache.add(self.preset, block_root, block, state)
        if otb_parent_hash is not None:
            self.optimistic_transition_blocks[block_root] = otb_parent_hash

        with M.BLOCK_FORK_CHOICE_TIMES.time(), tracing.span("fork_choice"):
            self._fork_choice_import(
                signed_block, block_root, state, ctxt,
                execution_status, execution_block_hash,
            )
        self.emit(
            "block",
            {"slot": block.slot, "block": "0x" + block_root.hex()},
        )
        fin_epoch, fin_root = self.fork_choice.finalized_checkpoint
        if int(fin_epoch) > self._finality_emitted_epoch:
            self._finality_emitted_epoch = int(fin_epoch)
            self.emit(
                "finalized_checkpoint",
                {
                    "epoch": int(fin_epoch),
                    "block": "0x" + bytes(fin_root).hex(),
                },
            )
        self._prune_on_finality()
        return block_root, True

    def _fork_choice_import(
        self, signed_block, block_root, state, ctxt,
        execution_status, execution_block_hash,
    ) -> None:
        block = signed_block.message
        try:
            self.fork_choice.on_block(
                signed_block,
                block_root,
                state,
                execution_status=execution_status,
                execution_block_hash=execution_block_hash,
            )
        except ForkChoiceError as e:
            # surface fork-choice admission failures (e.g. a fork that no
            # longer descends from the finalized checkpoint — exactly what
            # a healed partition's losing side gossips) as BlockError so
            # every import caller's reject handling covers them; the block
            # row already committed, which is harmless (it is unreachable
            # from fork choice and dedup treats a retry as duplicate)
            raise BlockError(str(e)) from None
        if execution_status == "valid":
            # engine-API semantics: a VALID payload implies its ancestors'
            # payloads are valid too -- clear any stale optimistic marks
            self.fork_choice.on_valid_execution_payload(block_root)
        # fork-choice also counts the block's attestations
        for att in block.body.attestations:
            indexed = ctxt.get_indexed_attestation(state, att)
            self.fork_choice.on_attestation(
                att.data.slot,
                list(indexed.attesting_indices),
                bytes(att.data.beacon_block_root),
                from_block=True,
            )
            if self.validator_monitor is not None:
                self.validator_monitor.on_attestation_included(
                    list(indexed.attesting_indices),
                    att.data.slot,
                    block.slot,
                )
        # ... and strips equivocators' fork-choice weight (spec
        # on_attester_slashing; fork_choice.rs on_attester_slashing)
        for slashing in block.body.attester_slashings:
            self.fork_choice.on_attester_slashing(slashing)
        old_head = self.head_root
        self.recompute_head()
        if self.head_root != old_head:
            if self.head_root == block_root:
                from ..utils import metrics as M

                # the just-imported block became the canonical head: the
                # final slot-relative milestone (beacon_block_delay_head)
                M.observe_slot_delay(
                    M.BLOCK_HEAD_DELAY, self.slot_clock, int(block.slot)
                )
            head_state_root = self.store.get_chain_item(
                b"block_post_state:" + self.head_root
            )
            self.emit(
                "head",
                {
                    "slot": self.head_state.slot,
                    "block": "0x" + self.head_root.hex(),
                    "state": "0x" + (head_state_root or b"").hex(),
                },
            )

    # -- attestations (gossip path) -----------------------------------------

    def produce_attestation_data(self, slot: int, index: int):
        """AttestationData for (slot, committee index): the early-attester
        cache serves the just-imported-block case without state access
        (early_attester_cache.rs); misses derive from the head state (the
        produce_unaggregated_attestation fallback, beacon_chain.rs)."""
        data = self.early_attester_cache.try_attest(slot, index, self.preset)
        if data is not None:
            return data
        from ..types.containers import AttestationData, Checkpoint
        from ..types.helpers import get_block_root_at_slot

        head_root, state = self.head()
        epoch = compute_epoch_at_slot(slot, self.preset)
        block_root = (
            get_block_root_at_slot(state, slot, self.preset)
            if slot < state.slot
            else head_root
        )
        target_slot = compute_start_slot_at_epoch(epoch, self.preset)
        target_root = (
            get_block_root_at_slot(state, target_slot, self.preset)
            if target_slot < state.slot
            else block_root
        )
        # current-or-future epoch (a lagging head at an epoch boundary is
        # still "current"): the CURRENT justified checkpoint; only a
        # genuinely previous-epoch request uses the previous one
        source = (
            state.current_justified_checkpoint
            if epoch >= compute_epoch_at_slot(state.slot, self.preset)
            else state.previous_justified_checkpoint
        )
        return AttestationData(
            slot=slot,
            index=index,
            beacon_block_root=block_root,
            source=Checkpoint(epoch=source.epoch, root=bytes(source.root)),
            target=Checkpoint(epoch=epoch, root=target_root),
        )

    def apply_attestation(self, attestation, indexed_indices) -> None:
        """Feed a verified unaggregated/aggregate attestation into fork
        choice (verification lives in the processor/verification layer).

        Fork choice's spec recency asserts are stricter than gossip
        admission (gossip accepts anything within ATTESTATION_PROPAGATION_
        SLOT_RANGE; fork choice wants current/previous epoch only), so a
        stale-but-gossip-valid attestation is DROPPED here rather than
        propagated — the reference maps this to a non-fatal error at the
        same boundary (beacon_chain.rs apply_attestation_to_fork_choice)."""
        try:
            with self.lock:
                self.fork_choice.on_attestation(
                    attestation.data.slot,
                    indexed_indices,
                    bytes(attestation.data.beacon_block_root),
                )
        except ForkChoiceError:
            pass

    # -- head (canonical_head.rs recompute_head) ----------------------------

    def recompute_head(self) -> bytes:
        with self.lock:
            return self._recompute_head_locked()

    def _recompute_head_locked(self) -> bytes:
        head = self.fork_choice.get_head()
        if head != self.head_root:
            self.head_root = head
            # Clone: callers advance/mutate the head state (block production,
            # duty lookahead); aliasing the cached post-state would corrupt
            # the canonical chain (reference snapshots in canonical_head.rs).
            self.head_state = clone_state(self._states[head])
            # persist the head pointer PAIR atomically for FromStore
            # restart resume: a crash between the two writes would leave
            # a head block pointing at the previous head's state
            batch = self.store.batch()
            batch.stage_chain_item(b"head_block_root", head)
            state_root = self.store.get_chain_item(
                b"block_post_state:" + head
            )
            if state_root is not None:
                batch.stage_chain_item(b"head_state_root", state_root)
            batch.commit()
            if self.validator_monitor is not None:
                # per-epoch grading from the head state's participation
                # flags (validator_monitor.rs process_valid_state); the
                # monitor dedups by epoch internally
                self.validator_monitor.evaluate_epoch(
                    self.head_state, self.preset
                )
        return head

    def head(self):
        return self.head_root, self.head_state

    def state_for_block_root(self, block_root: bytes):
        """Post-state for ANY known block root: the hot cache first, then
        memoized store reconstruction -- finalized history included, which
        is what a weak-subjectivity light-client bootstrap asks for."""
        return self._states.get_any(block_root)

    # -- optimistic sync / payload invalidation (fork_revert.rs analogue) ---

    def on_invalid_payload(
        self, block_root: bytes, latest_valid_hash: bytes | None = None
    ) -> bytes:
        """The engine ruled an optimistically-imported payload INVALID
        (e.g. via a later forkchoiceUpdated): poison the subtree in fork
        choice and recompute the head away from it."""
        self.fork_choice.on_invalid_execution_payload(
            block_root, latest_valid_hash
        )
        head = self.recompute_head()
        self.emit(
            "invalid_payload",
            {"block": "0x" + bytes(block_root).hex(), "new_head": "0x" + head.hex()},
        )
        return head

    def is_optimistic(self, block_root: bytes) -> bool:
        return self.fork_choice.is_optimistic(block_root)

    @property
    def finalized_checkpoint(self):
        return self.fork_choice.finalized_checkpoint

    @property
    def justified_checkpoint(self):
        return self.fork_choice.justified_checkpoint

    # -- finality housekeeping ----------------------------------------------

    def _prune_on_finality(self) -> None:
        fin_epoch, fin_root = self.fork_choice.finalized_checkpoint
        if fin_epoch == 0 or fin_root not in self._states:
            return
        fin_slot = compute_start_slot_at_epoch(fin_epoch, self.preset)
        # canonical chain: walk head ancestry
        canonical = set()
        root = self.head_root
        while root in self._states:
            canonical.add(root)
            blk = self.store.get_block(root)
            if blk is None:
                break
            root = bytes(blk.message.parent_root)
        # drop in-memory states for pruned forks below finality
        for root in list(self._states.keys()):
            blk = self.store.get_block(root)
            if blk is None:
                continue
            if blk.message.slot < fin_slot and root != fin_root:
                del self._states[root]
        self.store.migrate_to_freezer(
            fin_slot,
            canonical,
            finalized_state=self._states.get(fin_root),
            finalized_block_root=fin_root,
        )
        self.fork_choice.proto.proto_array.maybe_prune(fin_root)

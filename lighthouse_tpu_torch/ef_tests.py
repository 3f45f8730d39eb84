"""EF consensus-spec-tests runner (reference testing/ef_tests/src/
handler.rs:10-41 + cases/*): walks the official vector layout

    <root>/tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>/

and executes each case against this framework's state transition, SSZ,
and BLS backends. The official vectors are a multi-GB download
(reference Makefile:176-182 make-ef-tests); point LIGHTHOUSE_TPU_EF_TESTS
at an extracted tree to run them. The same machinery executes the
in-repo synthesized mini-tree (tests/test_ef_vectors.py), so the walker,
ssz_snappy loading, and case semantics stay exercised offline.

Implemented runners (cases/{operations,epoch_processing,sanity,bls,
genesis_initialization,genesis_validity,shuffling,fork,ssz_static,
fork_choice}.rs):

  operations/{attestation,attester_slashing,proposer_slashing,
              voluntary_exit,deposit,sync_aggregate}
  epoch_processing/* (full epoch transition per handler)
  sanity/{slots,blocks}
  bls/{verify,aggregate_verify,fast_aggregate_verify,batch_verify}
  genesis/{initialization,validity}
  shuffling/core
  fork/fork (phase0->altair, altair->bellatrix upgrades)
  ssz_static/<Type> (round-trip + tree-hash root)
  fork_choice/* (scripted tick/block/attestation/slashing steps + checks)

The port's copy of lighthouse_tpu/ef_tests.py.
"""

from __future__ import annotations

import os

import yaml

from .crypto.bls import api as bls
from .network.snappy import decompress
from .state_transition import (
    BlockProcessingError,
    BlockSignatureStrategy,
    per_block_processing,
    process_epoch,
    process_slots,
)
from .state_transition.context import ConsensusContext
from .state_transition.per_block import (
    process_attestation,
    process_attester_slashing,
    process_deposit,
    process_proposer_slashing,
    process_sync_aggregate,
    process_voluntary_exit,
)
from .types import ChainSpec, state_class_for, types_for
from .types.presets import MAINNET, MINIMAL


class CaseResult:
    def __init__(self, path: str, ok: bool, message: str = ""):
        self.path = path
        self.ok = ok
        self.message = message

    def __repr__(self):
        return f"{'ok ' if self.ok else 'FAIL'} {self.path} {self.message}"


def _load(case_dir: str, name: str) -> bytes | None:
    p = os.path.join(case_dir, name)
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return decompress(f.read())


def _load_yaml(case_dir: str, name: str):
    p = os.path.join(case_dir, name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return yaml.safe_load(f)


def _spec_for(config: str, fork: str) -> tuple:
    """The OFFICIAL config's spec (minimal/mainnet constants -- the
    vectors were generated under them; interop constants would fail
    domain- and period-dependent cases), with the target fork active from
    genesis (handler.rs fork_from_env runs each fork's vectors that
    way)."""
    preset = MINIMAL if config == "minimal" else MAINNET
    spec = ChainSpec.minimal() if config == "minimal" else ChainSpec.mainnet()
    spec.altair_fork_epoch = 0 if fork in ("altair", "bellatrix") else None
    spec.bellatrix_fork_epoch = 0 if fork == "bellatrix" else None
    return preset, spec


_OPERATION_FILES = {
    "attestation": ("attestation.ssz_snappy", "Attestation", process_attestation),
    "attester_slashing": (
        "attester_slashing.ssz_snappy",
        "AttesterSlashing",
        process_attester_slashing,
    ),
    "proposer_slashing": (
        "proposer_slashing.ssz_snappy",
        "ProposerSlashing",
        process_proposer_slashing,
    ),
    "voluntary_exit": (
        "voluntary_exit.ssz_snappy",
        "SignedVoluntaryExit",
        process_voluntary_exit,
    ),
    "deposit": ("deposit.ssz_snappy", "Deposit", process_deposit),
    "sync_aggregate": (
        "sync_aggregate.ssz_snappy",
        "SyncAggregate",
        process_sync_aggregate,
    ),
}


def _run_execution_payload_case(case_dir, config, fork) -> CaseResult:
    """operations/execution_payload (cases/operations.rs:249-310): the
    payload applies iff the engine verdict in execution.yaml says the
    payload is executable AND the consensus checks pass."""
    from types import SimpleNamespace

    from .state_transition.per_block import process_execution_payload

    if fork in ("phase0", "altair"):
        return CaseResult(case_dir, True, "pre-bellatrix (skipped)")
    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state_cls = state_class_for(t, fork)
    pre = state_cls.from_ssz_bytes(_load(case_dir, "pre.ssz_snappy"))
    payload = t.ExecutionPayload.from_ssz_bytes(
        _load(case_dir, "execution_payload.ssz_snappy")
    )
    meta = _load_yaml(case_dir, "execution.yaml") or {}
    execution_valid = bool(meta.get("execution_valid", False))
    post_raw = _load(case_dir, "post.ssz_snappy")
    body = SimpleNamespace(execution_payload=payload)
    error = None
    try:
        if not execution_valid:
            raise BlockProcessingError("execution engine rejected payload")
        process_execution_payload(pre, body, preset, spec)
        applied = True
    except (BlockProcessingError, IndexError, ValueError) as e:
        applied = False
        error = str(e)
    if post_raw is None:
        if applied:
            return CaseResult(case_dir, False, "invalid payload accepted")
        return CaseResult(case_dir, True)
    if not applied:
        return CaseResult(case_dir, False, f"valid payload rejected: {error}")
    if pre.tree_hash_root() != state_cls.from_ssz_bytes(post_raw).tree_hash_root():
        return CaseResult(case_dir, False, "post-state root mismatch")
    return CaseResult(case_dir, True)


def _run_operation_case(case_dir, handler, config, fork) -> CaseResult:
    if handler == "execution_payload":
        return _run_execution_payload_case(case_dir, config, fork)
    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state_cls = state_class_for(t, fork)
    fname, type_name, process = _OPERATION_FILES[handler]
    pre = state_cls.from_ssz_bytes(_load(case_dir, "pre.ssz_snappy"))
    op_raw = _load(case_dir, fname)
    from .types.containers import (
        Deposit,
        ProposerSlashing,
        SignedVoluntaryExit,
    )

    op_cls = {
        "Attestation": t.Attestation,
        "AttesterSlashing": t.AttesterSlashing,
        "ProposerSlashing": ProposerSlashing,
        "SignedVoluntaryExit": SignedVoluntaryExit,
        "Deposit": Deposit,
        "SyncAggregate": t.SyncAggregate,
    }[type_name]
    op = op_cls.from_ssz_bytes(op_raw)
    post_raw = _load(case_dir, "post.ssz_snappy")
    ctxt = ConsensusContext(preset, spec)
    try:
        if handler == "voluntary_exit":
            process(pre, op, preset, spec)
        else:
            process(pre, op, preset, spec, ctxt=ctxt)
        applied = True
    except (BlockProcessingError, IndexError, ValueError) as e:
        applied = False
        error = str(e)
    if post_raw is None:
        if applied:
            return CaseResult(case_dir, False, "invalid op was accepted")
        return CaseResult(case_dir, True)
    if not applied:
        return CaseResult(case_dir, False, f"valid op rejected: {error}")
    if pre.tree_hash_root() != state_cls.from_ssz_bytes(post_raw).tree_hash_root():
        return CaseResult(case_dir, False, "post-state root mismatch")
    return CaseResult(case_dir, True)


def _run_sanity_case(case_dir, handler, config, fork) -> CaseResult:
    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state_cls = state_class_for(t, fork)
    pre = state_cls.from_ssz_bytes(_load(case_dir, "pre.ssz_snappy"))
    post_raw = _load(case_dir, "post.ssz_snappy")
    try:
        if handler == "slots":
            n = _load_yaml(case_dir, "slots.yaml")
            pre = process_slots(pre, pre.slot + int(n), preset, spec)
        else:  # blocks
            meta = _load_yaml(case_dir, "meta.yaml") or {}
            from .types import block_classes_for

            _, signed_cls, _ = block_classes_for(t, fork)
            for i in range(int(meta.get("blocks_count", 0))):
                raw = _load(case_dir, f"blocks_{i}.ssz_snappy")
                signed = signed_cls.from_ssz_bytes(raw)
                pre = process_slots(pre, signed.message.slot, preset, spec)
                per_block_processing(
                    pre,
                    signed,
                    preset,
                    spec,
                    strategy=BlockSignatureStrategy.VERIFY_BULK,
                )
        applied = True
    except (BlockProcessingError, ValueError) as e:
        applied = False
        error = str(e)
    if post_raw is None:
        return (
            CaseResult(case_dir, True)
            if not applied
            else CaseResult(case_dir, False, "invalid sanity case accepted")
        )
    if not applied:
        return CaseResult(case_dir, False, f"valid case rejected: {error}")
    if pre.tree_hash_root() != state_cls.from_ssz_bytes(post_raw).tree_hash_root():
        return CaseResult(case_dir, False, "post-state root mismatch")
    return CaseResult(case_dir, True)


def _run_epoch_case(case_dir, handler, config, fork) -> CaseResult:
    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state_cls = state_class_for(t, fork)
    pre = state_cls.from_ssz_bytes(_load(case_dir, "pre.ssz_snappy"))
    post_raw = _load(case_dir, "post.ssz_snappy")
    try:
        # the official vectors' post-states reflect ONLY the named
        # sub-transition (epoch_processing.rs EpochTransition impls), so
        # run exactly that step, not the full transition
        from .state_transition.per_epoch import run_epoch_sub_transition

        run_epoch_sub_transition(pre, handler, preset, spec)
        applied = True
    except (BlockProcessingError, ValueError) as e:
        applied, error = False, str(e)
    if post_raw is None:
        return (
            CaseResult(case_dir, True)
            if not applied
            else CaseResult(case_dir, False, "invalid epoch case accepted")
        )
    if not applied:
        return CaseResult(case_dir, False, f"valid case rejected: {error}")
    if pre.tree_hash_root() != state_cls.from_ssz_bytes(post_raw).tree_hash_root():
        return CaseResult(case_dir, False, "post-state root mismatch")
    return CaseResult(case_dir, True)


def _run_bls_case(case_dir, handler, config, fork) -> CaseResult:
    data = _load_yaml(case_dir, "data.yaml")
    if data is None:
        return CaseResult(case_dir, False, "missing data.yaml")
    inp, expected = data["input"], data["output"]

    def _b(h):
        return bytes.fromhex(str(h).removeprefix("0x"))

    try:
        if handler == "verify":
            pk = bls.PublicKey.from_bytes(_b(inp["pubkey"]))
            sig = bls.Signature.from_bytes(_b(inp["signature"]))
            got = bls.verify(sig, [pk], _b(inp["message"]))
        elif handler == "fast_aggregate_verify":
            pks = [bls.PublicKey.from_bytes(_b(p)) for p in inp["pubkeys"]]
            sig = bls.Signature.from_bytes(_b(inp["signature"]))
            got = bls.verify(sig, pks, _b(inp["message"]))
        elif handler == "aggregate_verify":
            pks = [bls.PublicKey.from_bytes(_b(p)) for p in inp["pubkeys"]]
            sig = bls.Signature.from_bytes(_b(inp["signature"]))
            got = bls.aggregate_verify(
                sig, pks, [_b(m) for m in inp["messages"]]
            )
        elif handler == "batch_verify":
            sets = []
            for pk_h, m_h, sig_h in zip(
                inp["pubkeys"], inp["messages"], inp["signatures"]
            ):
                pk = bls.PublicKey.from_bytes(_b(pk_h))
                sig = bls.Signature.from_bytes(_b(sig_h))
                sets.append(bls.SignatureSet.single_pubkey(sig, pk, _b(m_h)))
            got = bls.verify_signature_sets(sets, seed=1)
        else:
            return CaseResult(case_dir, False, f"unknown bls handler {handler}")
    except (bls.BlsError, ValueError):
        got = False  # undecodable inputs are failing verifications
    if bool(got) != bool(expected):
        return CaseResult(case_dir, False, f"got {got}, expected {expected}")
    return CaseResult(case_dir, True)


def _run_genesis_case(case_dir, handler, config, fork) -> CaseResult:
    """genesis/{initialization,validity} (cases/genesis_initialization.rs,
    genesis_validity.rs)."""
    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state_cls = state_class_for(t, fork)
    from .state_transition.genesis import (
        initialize_beacon_state_from_eth1,
        is_valid_genesis_state,
    )

    if handler == "validity":
        genesis = state_cls.from_ssz_bytes(_load(case_dir, "genesis.ssz_snappy"))
        want = bool(_load_yaml(case_dir, "is_valid.yaml"))
        got = is_valid_genesis_state(genesis, preset, spec)
        if got != want:
            return CaseResult(case_dir, False, f"validity {got} != {want}")
        return CaseResult(case_dir, True)

    if handler != "initialization":
        return CaseResult(case_dir, False, f"unknown genesis handler {handler}")
    eth1 = _load_yaml(case_dir, "eth1.yaml")
    meta = _load_yaml(case_dir, "meta.yaml") or {}
    from .types.containers import Deposit

    deposits = [
        Deposit.from_ssz_bytes(_load(case_dir, f"deposits_{i}.ssz_snappy"))
        for i in range(int(meta.get("deposits_count", 0)))
    ]
    header = None
    if meta.get("execution_payload_header"):
        raw = _load(case_dir, "execution_payload_header.ssz_snappy")
        header = t.ExecutionPayloadHeader.from_ssz_bytes(raw)
    block_hash = bytes.fromhex(str(eth1["eth1_block_hash"]).removeprefix("0x"))
    state = initialize_beacon_state_from_eth1(
        block_hash,
        int(eth1["eth1_timestamp"]),
        deposits,
        preset,
        spec,
        execution_payload_header=header,
    )
    want = state_cls.from_ssz_bytes(_load(case_dir, "state.ssz_snappy"))
    if state.tree_hash_root() != want.tree_hash_root():
        return CaseResult(case_dir, False, "genesis state root mismatch")
    return CaseResult(case_dir, True)


def _run_shuffling_case(case_dir, handler, config, fork) -> CaseResult:
    """shuffling/core (cases/shuffling.rs): both compute_shuffled_index
    and the whole-list fast path must reproduce the mapping, under the
    config's round count (mainnet 90 / minimal 10)."""
    from .utils.shuffle import compute_shuffled_index, shuffle_list

    _, spec = _spec_for(config, fork)
    rounds = spec.shuffle_round_count
    data = _load_yaml(case_dir, "mapping.yaml")
    count = int(data["count"])
    mapping = [int(x) for x in data["mapping"]]
    if count == 0:
        return CaseResult(case_dir, mapping == [])
    seed = bytes.fromhex(str(data["seed"]).removeprefix("0x"))
    got = [compute_shuffled_index(i, count, seed, rounds) for i in range(count)]
    if got != mapping:
        return CaseResult(case_dir, False, "compute_shuffled_index mismatch")
    # the vector's mapping[i] is shuffled(i); shuffle_list's backwards
    # direction reproduces exactly that on the identity list
    got_list = shuffle_list(list(range(count)), seed, forwards=False, rounds=rounds)
    if got_list != mapping:
        return CaseResult(case_dir, False, "shuffle_list mismatch")
    return CaseResult(case_dir, True)


def _run_fork_case(case_dir, handler, config, fork) -> CaseResult:
    """fork/fork (cases/fork.rs): upgrade the previous fork's pre-state."""
    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    from .state_transition.upgrades import upgrade_to_altair, upgrade_to_bellatrix

    prev = {"altair": "phase0", "bellatrix": "altair"}.get(fork)
    if prev is None:
        return CaseResult(case_dir, False, f"fork test for {fork}")
    pre_cls = state_class_for(t, prev)
    post_cls = state_class_for(t, fork)
    pre = pre_cls.from_ssz_bytes(_load(case_dir, "pre.ssz_snappy"))
    upgraded = (
        upgrade_to_altair(pre, preset, spec)
        if fork == "altair"
        else upgrade_to_bellatrix(pre, preset, spec)
    )
    want = post_cls.from_ssz_bytes(_load(case_dir, "post.ssz_snappy"))
    if upgraded.tree_hash_root() != want.tree_hash_root():
        return CaseResult(case_dir, False, "fork post-state root mismatch")
    return CaseResult(case_dir, True)


def _ssz_static_class(name: str, t, fork: str):
    """Type-name -> class under the given preset/fork, or None if the
    container is not part of this framework's surface."""
    from .types import block_classes_for
    from .types import containers as C

    if name == "BeaconState":
        return state_class_for(t, fork)
    if name in ("BeaconBlock", "SignedBeaconBlock", "BeaconBlockBody"):
        block_cls, signed_cls, body_cls = block_classes_for(t, fork)
        return {
            "BeaconBlock": block_cls,
            "SignedBeaconBlock": signed_cls,
            "BeaconBlockBody": body_cls,
        }[name]
    if fork == "bellatrix" and name == "ExecutionPayload":
        return t.ExecutionPayload
    if fork == "bellatrix" and name == "ExecutionPayloadHeader":
        return t.ExecutionPayloadHeader
    fork_aware = {
        "Attestation": t.Attestation,
        "AttesterSlashing": t.AttesterSlashing,
        "IndexedAttestation": t.IndexedAttestation,
        "PendingAttestation": getattr(t, "PendingAttestation", None),
        "HistoricalBatch": getattr(t, "HistoricalBatch", None),
        "SyncAggregate": getattr(t, "SyncAggregate", None) if fork != "phase0" else None,
        "SyncCommittee": getattr(t, "SyncCommittee", None) if fork != "phase0" else None,
    }
    if name in fork_aware:
        return fork_aware[name]
    return getattr(C, name, None)


def _run_ssz_static_case(case_dir, handler, config, fork) -> CaseResult:
    """ssz_static/<Type> (cases/ssz_static.rs): decode -> re-encode must
    round-trip and the tree-hash root must match roots.yaml."""
    preset, _ = _spec_for(config, fork)
    t = types_for(preset)
    cls = _ssz_static_class(handler, t, fork)
    if cls is None:
        return CaseResult(case_dir, True, "type not in surface (skipped)")
    raw = _load(case_dir, "serialized.ssz_snappy")
    roots = _load_yaml(case_dir, "roots.yaml")
    try:
        value = cls.from_ssz_bytes(raw)
    except Exception as e:  # noqa: BLE001
        return CaseResult(case_dir, False, f"decode failed: {e}")
    if value.as_ssz_bytes() != raw:
        return CaseResult(case_dir, False, "re-encode mismatch")
    want_root = bytes.fromhex(str(roots["root"]).removeprefix("0x"))
    if value.tree_hash_root() != want_root:
        return CaseResult(case_dir, False, "tree-hash root mismatch")
    return CaseResult(case_dir, True)


def _run_fork_choice_case(case_dir, handler, config, fork) -> CaseResult:
    """fork_choice/* scripted steps (cases/fork_choice.rs): anchor state +
    block, then tick / block / attestation / attester_slashing steps with
    interleaved head & checkpoint checks. Ticks are ABSOLUTE seconds
    (slot = (tick - genesis_time) // seconds_per_slot, set_tick at
    fork_choice.rs:366)."""
    from .fork_choice import ForkChoice
    from .state_transition import clone_state
    from .state_transition.context import ConsensusContext
    from .types import block_classes_for, compute_epoch_at_slot

    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state_cls = state_class_for(t, fork)
    block_cls, signed_cls, _ = block_classes_for(t, fork)
    anchor_state = state_cls.from_ssz_bytes(
        _load(case_dir, "anchor_state.ssz_snappy")
    )
    anchor_block = block_cls.from_ssz_bytes(
        _load(case_dir, "anchor_block.ssz_snappy")
    )
    anchor_root = anchor_block.tree_hash_root()
    states = {anchor_root: anchor_state}
    anchor_epoch = compute_epoch_at_slot(anchor_state.slot, preset)
    anchor_cp = (anchor_epoch, anchor_root)
    fc = ForkChoice(
        preset,
        spec,
        genesis_slot=anchor_block.slot,
        genesis_root=anchor_root,
        justified_checkpoint=anchor_cp,
        finalized_checkpoint=anchor_cp,
        state_lookup=lambda root: states.get(root),
    )
    genesis_time = anchor_state.genesis_time
    time_now = genesis_time + anchor_state.slot * spec.seconds_per_slot

    def att_indices(att):
        """Indexed attestation via the attested block's state advanced to
        the attestation slot (committees are epoch+seed functions of it)."""
        base = states.get(bytes(att.data.beacon_block_root))
        if base is None:
            raise ValueError("attestation for unknown block")
        st = base
        if st.slot < att.data.slot:
            st = process_slots(clone_state(st), att.data.slot, preset, spec)
        ctxt = ConsensusContext(preset, spec)
        return list(ctxt.get_indexed_attestation(st, att).attesting_indices)

    steps = _load_yaml(case_dir, "steps.yaml") or []
    for step in steps:
        if "tick" in step:
            time_now = int(step["tick"])
            fc.on_tick_time(time_now, genesis_time)
        elif "block" in step:
            raw = _load(case_dir, f"{step['block']}.ssz_snappy")
            signed = signed_cls.from_ssz_bytes(raw)
            block = signed.message
            expected_valid = bool(step.get("valid", True))
            try:
                parent = states.get(bytes(block.parent_root))
                if parent is None:
                    raise ValueError("unknown parent")
                st = process_slots(
                    clone_state(parent), block.slot, preset, spec
                )
                ctxt = ConsensusContext(preset, spec)
                per_block_processing(
                    st,
                    signed,
                    preset,
                    spec,
                    strategy=BlockSignatureStrategy.VERIFY_BULK,
                    ctxt=ctxt,
                )
                root = block.tree_hash_root()
                fc.on_block(signed, root, st)
                states[root] = st
                # spec on_block: the block's attestations and slashings
                # feed the store too (is_from_block semantics)
                for att in block.body.attestations:
                    fc.on_attestation(
                        att.data.slot,
                        att_indices(att),
                        bytes(att.data.beacon_block_root),
                        from_block=True,
                    )
                for sl in block.body.attester_slashings:
                    fc.on_attester_slashing(sl)
                applied = True
            except (BlockProcessingError, ValueError, KeyError):
                applied = False
            if applied != expected_valid:
                return CaseResult(
                    case_dir,
                    False,
                    f"block {step['block']}: applied={applied} "
                    f"expected valid={expected_valid}",
                )
        elif "attestation" in step:
            raw = _load(case_dir, f"{step['attestation']}.ssz_snappy")
            att = t.Attestation.from_ssz_bytes(raw)
            expected_valid = bool(step.get("valid", True))
            try:
                fc.on_attestation(
                    att.data.slot,
                    att_indices(att),
                    bytes(att.data.beacon_block_root),
                )
                applied = True
            except (ValueError, KeyError):
                applied = False
            if applied != expected_valid:
                return CaseResult(
                    case_dir,
                    False,
                    f"attestation {step['attestation']}: applied={applied} "
                    f"expected valid={expected_valid}",
                )
        elif "attester_slashing" in step:
            raw = _load(case_dir, f"{step['attester_slashing']}.ssz_snappy")
            sl = t.AttesterSlashing.from_ssz_bytes(raw)
            expected_valid = bool(step.get("valid", True))
            try:
                fc.on_attester_slashing(sl)
                applied = True
            except (ValueError, KeyError):
                applied = False
            if applied != expected_valid:
                return CaseResult(
                    case_dir,
                    False,
                    f"attester_slashing: applied={applied} "
                    f"expected valid={expected_valid}",
                )
        elif "checks" in step:
            checks = step["checks"]
            if "head" in checks:
                head = fc.get_head()
                want = bytes.fromhex(
                    str(checks["head"]["root"]).removeprefix("0x")
                )
                if head != want:
                    return CaseResult(
                        case_dir,
                        False,
                        f"head {head.hex()} != {want.hex()}",
                    )
                idx = fc.proto.proto_array.indices[head]
                if fc.proto.proto_array.nodes[idx].slot != int(
                    checks["head"]["slot"]
                ):
                    return CaseResult(case_dir, False, "head slot mismatch")
            for key, attr in (
                ("justified_checkpoint", fc.justified_checkpoint),
                ("finalized_checkpoint", fc.finalized_checkpoint),
                ("u_justified_checkpoint", fc.unrealized_justified_checkpoint),
                ("u_finalized_checkpoint", fc.unrealized_finalized_checkpoint),
            ):
                if key in checks and checks[key] is not None:
                    want_cp = (
                        int(checks[key]["epoch"]),
                        bytes.fromhex(
                            str(checks[key]["root"]).removeprefix("0x")
                        ),
                    )
                    if attr != want_cp:
                        return CaseResult(
                            case_dir, False, f"{key} {attr} != {want_cp}"
                        )
            if "proposer_boost_root" in checks:
                got = fc.proto.proposer_boost_root or bytes(32)
                want = bytes.fromhex(
                    str(checks["proposer_boost_root"]).removeprefix("0x")
                )
                if got != want:
                    return CaseResult(
                        case_dir, False, "proposer_boost_root mismatch"
                    )
            if "time" in checks and checks["time"] is not None:
                if time_now != int(checks["time"]):
                    return CaseResult(case_dir, False, "time mismatch")
            if "genesis_time" in checks and checks["genesis_time"] is not None:
                if genesis_time != int(checks["genesis_time"]):
                    return CaseResult(case_dir, False, "genesis_time mismatch")
    return CaseResult(case_dir, True)


def _deltas_container():
    from .ssz import List, container, uint64

    # built via type(): this module uses `from __future__ import
    # annotations`, which would turn class-body annotations into strings
    # the @container decorator cannot evaluate
    cls = type(
        "Deltas",
        (),
        {
            "__annotations__": {
                "rewards": List(uint64, 1 << 40),
                "penalties": List(uint64, 1 << 40),
            }
        },
    )
    return container(cls)


def _run_rewards_case(case_dir, handler, config, fork) -> CaseResult:
    """rewards/{basic,leak,random} (cases/rewards.rs): per-component
    reward/penalty deltas against the pre-state."""
    from .state_transition.per_epoch import (
        _total_active_balance,
        attestation_component_deltas,
        flag_component_deltas,
    )

    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state = state_class_for(t, fork).from_ssz_bytes(
        _load(case_dir, "pre.ssz_snappy")
    )
    total = _total_active_balance(state, preset, spec)
    if fork == "phase0":
        comps = attestation_component_deltas(state, preset, spec, {}, total)
    else:
        comps = flag_component_deltas(state, preset, spec, total)
    files = {
        "source_deltas": "source",
        "target_deltas": "target",
        "head_deltas": "head",
        "inclusion_delay_deltas": "inclusion_delay",
        "inactivity_penalty_deltas": "inactivity",
    }
    Deltas = _deltas_container()
    for fname, comp in files.items():
        raw = _load(case_dir, f"{fname}.ssz_snappy")
        if raw is None:
            continue  # inclusion_delay is phase0-only
        if comp not in comps:
            return CaseResult(case_dir, False, f"unexpected {fname}")
        want = Deltas.from_ssz_bytes(raw)
        got_r, got_p = comps[comp]
        if list(want.rewards) != got_r or list(want.penalties) != got_p:
            return CaseResult(case_dir, False, f"{fname} mismatch")
    return CaseResult(case_dir, True)


def _run_transition_case(case_dir, handler, config, fork) -> CaseResult:
    """transition/core (cases/transition.rs): apply blocks across a fork
    boundary; pre-fork blocks decode under the previous fork, the rest
    under the target fork, upgrades happen inside process_slots."""
    from .state_transition import clone_state
    from .types import block_classes_for

    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    meta = _load_yaml(case_dir, "meta.yaml")
    fork_epoch = int(meta["fork_epoch"])
    prev = {"altair": "phase0", "bellatrix": "altair"}.get(fork)
    if prev is None:
        return CaseResult(case_dir, False, f"transition to {fork}")
    # the pre-fork phase runs under the PREVIOUS fork's rules until
    # fork_epoch; rebuild the spec with the real schedule
    if fork == "altair":
        spec.altair_fork_epoch = fork_epoch
        spec.bellatrix_fork_epoch = None
    else:
        spec.altair_fork_epoch = 0
        spec.bellatrix_fork_epoch = fork_epoch
    pre_cls = state_class_for(t, prev)
    _, signed_prev, _ = block_classes_for(t, prev)
    _, signed_post, _ = block_classes_for(t, fork)
    state = pre_cls.from_ssz_bytes(_load(case_dir, "pre.ssz_snappy"))
    fork_block = meta.get("fork_block")
    fork_block = -1 if fork_block is None else int(fork_block)
    try:
        for i in range(int(meta["blocks_count"])):
            raw = _load(case_dir, f"blocks_{i}.ssz_snappy")
            cls = signed_prev if i <= fork_block else signed_post
            signed = cls.from_ssz_bytes(raw)
            state = process_slots(state, signed.message.slot, preset, spec)
            per_block_processing(
                state,
                signed,
                preset,
                spec,
                strategy=BlockSignatureStrategy.VERIFY_BULK,
            )
        applied = True
    except (BlockProcessingError, ValueError) as e:
        applied, error = False, str(e)
    post_raw = _load(case_dir, "post.ssz_snappy")
    if not applied:
        return CaseResult(case_dir, False, f"valid transition rejected: {error}")
    want = state_class_for(t, fork).from_ssz_bytes(post_raw)
    if state.tree_hash_root() != want.tree_hash_root():
        return CaseResult(case_dir, False, "transition post-state mismatch")
    return CaseResult(case_dir, True)


def _mk_container(name: str, fields: dict):
    """Container class via type(): this module's `from __future__ import
    annotations` would stringify class-body annotations."""
    from .ssz import container

    return container(type(name, (), {"__annotations__": dict(fields)}))


import functools


@functools.lru_cache(maxsize=1)
def _ssz_generic_test_types():
    """The spec's ssz_generic test containers (cases/ssz_generic.rs),
    built once."""
    from .ssz import (
        Bitlist,
        Bitvector,
        List,
        Vector,
        uint8,
        uint16,
        uint32,
        uint64,
    )

    single = _mk_container("SingleFieldTestStruct", {"A": uint8})
    small = _mk_container("SmallTestStruct", {"A": uint16, "B": uint16})
    fixed = _mk_container(
        "FixedTestStruct", {"A": uint8, "B": uint64, "C": uint32}
    )
    var = _mk_container(
        "VarTestStruct",
        {"A": uint16, "B": List(uint16, 1024), "C": uint8},
    )
    cplx = _mk_container(
        "ComplexTestStruct",
        {
            "A": uint16,
            "B": List(uint16, 128),
            "C": uint8,
            "D": List(uint8, 256),
            "E": var.ssz_type,
            "F": Vector(fixed.ssz_type, 4),
            "G": Vector(var.ssz_type, 2),
        },
    )
    bits = _mk_container(
        "BitsStruct",
        {
            "A": Bitlist(5),
            "B": Bitvector(2),
            "C": Bitvector(1),
            "D": Bitlist(6),
            "E": Bitvector(8),
        },
    )
    return {
        "SingleFieldTestStruct": single,
        "SmallTestStruct": small,
        "FixedTestStruct": fixed,
        "VarTestStruct": var,
        "ComplexTestStruct": cplx,
        "BitsStruct": bits,
    }


def _ssz_generic_type(handler: str, case: str):
    """Resolve the SSZ type descriptor a case name encodes, or None if
    out of surface."""
    from .ssz import (
        Bitlist,
        Bitvector,
        Vector,
        boolean,
        uint8,
        uint16,
        uint32,
        uint64,
        uint128,
        uint256,
    )

    uints = {
        "8": uint8,
        "16": uint16,
        "32": uint32,
        "64": uint64,
        "128": uint128,
        "256": uint256,
    }
    elems = {"bool": boolean, **{f"uint{k}": v for k, v in uints.items()}}
    parts = case.split("_")
    if handler == "boolean":
        return boolean
    if handler == "uints":
        return uints.get(parts[1])
    if handler == "basic_vector" and len(parts) >= 3:
        elem = elems.get(parts[1])
        try:
            length = int(parts[2])
        except ValueError:
            return None
        if elem is None or length == 0:
            return None
        return Vector(elem, length)
    if handler == "bitvector" and len(parts) >= 2:
        try:
            return Bitvector(int(parts[1]))
        except ValueError:
            return None
    if handler == "bitlist":
        try:
            limit = int(parts[1])
        except (ValueError, IndexError):
            limit = 2048  # e.g. bitlist_no_delimiter_*: decode must fail
        return Bitlist(limit)
    if handler == "containers":
        cls = _ssz_generic_test_types().get(parts[0])
        return None if cls is None else cls.ssz_type
    return None


def _run_ssz_generic_case(case_dir, handler, config, fork) -> CaseResult:
    """ssz_generic/<handler>/{valid,invalid} (cases/ssz_generic.rs):
    valid cases must round-trip and match the meta root; invalid
    serializations must FAIL to decode."""
    suite = os.path.basename(os.path.dirname(case_dir))
    case = os.path.basename(case_dir)
    ssz_type = _ssz_generic_type(handler, case)
    if ssz_type is None:
        return CaseResult(case_dir, True, "type not in surface (skipped)")
    raw = _load(case_dir, "serialized.ssz_snappy")
    if suite == "invalid":
        try:
            ssz_type.decode(raw)
        except Exception:  # noqa: BLE001 -- any decode failure is a pass
            return CaseResult(case_dir, True)
        return CaseResult(case_dir, False, "invalid bytes decoded")
    meta = _load_yaml(case_dir, "meta.yaml") or {}
    try:
        value = ssz_type.decode(raw)
    except Exception as e:  # noqa: BLE001
        return CaseResult(case_dir, False, f"valid case failed decode: {e}")
    if ssz_type.encode(value) != raw:
        return CaseResult(case_dir, False, "re-encode mismatch")
    want_root = meta.get("root")
    if want_root is not None:
        got = ssz_type.hash_tree_root(value)
        if got != bytes.fromhex(str(want_root).removeprefix("0x")):
            return CaseResult(case_dir, False, "root mismatch")
    if handler in ("uints", "boolean"):
        want_value = _load_yaml(case_dir, "value.yaml")
        if want_value is not None and int(value) != int(want_value):
            return CaseResult(case_dir, False, "value mismatch")
    return CaseResult(case_dir, True)


def _run_merkle_proof_case(case_dir, handler, config, fork) -> CaseResult:
    """light_client/single_merkle_proof (cases/merkle_proof_validity.rs):
    the state must PRODUCE the vector's branch for the generalized index,
    and the branch must verify against the state root."""
    from .ssz.merkle_proof import (
        MerkleTree,
        generalized_index_depth,
        verify_merkle_proof,
    )

    if handler not in ("single_merkle_proof", "single_proof"):
        return CaseResult(case_dir, True, "handler not in surface (skipped)")
    preset, spec = _spec_for(config, fork)
    t = types_for(preset)
    state = state_class_for(t, fork).from_ssz_bytes(
        _load(case_dir, "object.ssz_snappy")
        or _load(case_dir, "state.ssz_snappy")
    )
    proof = _load_yaml(case_dir, "proof.yaml")
    leaf = bytes.fromhex(str(proof["leaf"]).removeprefix("0x"))
    gi = int(proof["leaf_index"])
    branch = [
        bytes.fromhex(str(b).removeprefix("0x")) for b in proof["branch"]
    ]
    root = state.tree_hash_root()
    if not verify_merkle_proof(leaf, branch, gi, root):
        return CaseResult(case_dir, False, "branch does not verify")
    # regenerate: the vectors' indices live at the container-field level
    # (e.g. altair current_sync_committee = gi 54); deeper paths would
    # need recursive descent, which no current vector uses
    fields = state.ssz_fields
    depth = generalized_index_depth(gi)
    field_level = max(len(fields) - 1, 0).bit_length()
    if depth == field_level:
        field_idx = gi - (1 << depth)
        if field_idx >= len(fields):
            return CaseResult(case_dir, False, "index beyond field count")
        roots = [
            ftype.hash_tree_root(getattr(state, name))
            for name, ftype in fields
        ]
        tree = MerkleTree(roots)
        if roots[field_idx] != leaf:
            return CaseResult(case_dir, False, "leaf is not the field root")
        if tree.proof(field_idx) != branch:
            return CaseResult(case_dir, False, "generated branch mismatch")
    return CaseResult(case_dir, True)


def _run_update_ranking_case(case_dir, handler, config, fork) -> CaseResult:
    """light_client/update_ranking: the vector's updates are ordered from
    highest to lowest precedence; every later update must NOT rank better
    than an earlier one (spec is_better_update)."""
    from .chain.light_client import is_better_update, light_client_types

    preset, _ = _spec_for(config, fork)
    lt = light_client_types(preset)
    meta = _load_yaml(case_dir, "meta.yaml") or {}
    count = int(meta.get("updates_count", 0))
    updates = [
        lt.LightClientUpdate.from_ssz_bytes(
            _load(case_dir, f"updates_{i}.ssz_snappy")
        )
        for i in range(count)
    ]
    for i in range(len(updates) - 1):
        if is_better_update(updates[i + 1], updates[i], preset):
            return CaseResult(
                case_dir, False, f"update {i + 1} ranks above update {i}"
            )
        if not is_better_update(updates[i], updates[i + 1], preset):
            return CaseResult(
                case_dir, False, f"update {i} does not outrank {i + 1}"
            )
    return CaseResult(case_dir, True)


def _run_light_client_sync_case(case_dir, handler, config, fork) -> CaseResult:
    """light_client/sync: scripted steps driving a spec store —
    process_update / force_update with finalized/optimistic header
    checks after each step."""
    from .chain.light_client import LightClientStore, light_client_types

    preset, spec = _spec_for(config, fork)
    lt = light_client_types(preset)
    meta = _load_yaml(case_dir, "meta.yaml") or {}
    trusted = bytes.fromhex(
        str(meta["trusted_block_root"]).removeprefix("0x")
    )
    gvr = bytes.fromhex(
        str(meta["genesis_validators_root"]).removeprefix("0x")
    )
    bootstrap = lt.LightClientBootstrap.from_ssz_bytes(
        _load(case_dir, "bootstrap.ssz_snappy")
    )
    store = LightClientStore(trusted, bootstrap, preset, spec, gvr)
    steps = _load_yaml(case_dir, "steps.yaml") or []

    def _check(checks) -> str | None:
        for name, want in (checks or {}).items():
            header = getattr(store, name, None)
            if header is None:
                return f"unknown check target {name}"
            if int(header.slot) != int(want["slot"]):
                return f"{name} slot {header.slot} != {want['slot']}"
            want_root = want.get("beacon_root", want.get("root"))
            if want_root is not None and header.tree_hash_root() != (
                bytes.fromhex(str(want_root).removeprefix("0x"))
            ):
                return f"{name} root mismatch"
        return None

    for step in steps:
        if "process_update" in step:
            p = step["process_update"]
            update = lt.LightClientUpdate.from_ssz_bytes(
                _load(case_dir, f"{p['update']}.ssz_snappy")
            )
            store.process_spec_update(update, int(p["current_slot"]))
            err = _check(p.get("checks"))
        elif "force_update" in step:
            p = step["force_update"]
            store.force_update(int(p["current_slot"]))
            err = _check(p.get("checks"))
        else:
            # an unsupported step kind ends the case as an explicit SKIP —
            # continuing would run later checks against missed state, and
            # a bare pass would be a false green in a conformance runner
            kind = next(iter(step), "?")
            return CaseResult(
                case_dir, True, f"skipped at unsupported step {kind!r}"
            )
        if err:
            return CaseResult(case_dir, False, err)
    return CaseResult(case_dir, True)


def _run_light_client_case(case_dir, handler, config, fork) -> CaseResult:
    if handler == "update_ranking":
        return _run_update_ranking_case(case_dir, handler, config, fork)
    if handler == "sync":
        return _run_light_client_sync_case(case_dir, handler, config, fork)
    return _run_merkle_proof_case(case_dir, handler, config, fork)


_RUNNERS = {
    "operations": _run_operation_case,
    "sanity": _run_sanity_case,
    "random": _run_sanity_case,
    "epoch_processing": _run_epoch_case,
    "bls": _run_bls_case,
    "genesis": _run_genesis_case,
    "shuffling": _run_shuffling_case,
    "fork": _run_fork_case,
    "ssz_static": _run_ssz_static_case,
    "fork_choice": _run_fork_choice_case,
    "transition": _run_transition_case,
    "rewards": _run_rewards_case,
    "light_client": _run_light_client_case,
    "merkle": _run_merkle_proof_case,
    "merkle_proof": _run_merkle_proof_case,
    "ssz_generic": _run_ssz_generic_case,
}


def run_tree(root: str, configs=("general", "minimal", "mainnet")) -> list[CaseResult]:
    """Walk <root>/tests/... and run every recognized case (the Handler
    walk, handler.rs:37-70). Unrecognized runners are skipped silently --
    the official tree carries many runner kinds."""
    results = []
    tests = os.path.join(root, "tests")
    for config in configs:
        cfg_dir = os.path.join(tests, config)
        if not os.path.isdir(cfg_dir):
            continue
        for fork in sorted(os.listdir(cfg_dir)):
            if fork not in ("phase0", "altair", "bellatrix"):
                continue
            fork_dir = os.path.join(cfg_dir, fork)
            for runner in sorted(os.listdir(fork_dir)):
                run_case = _RUNNERS.get(runner)
                if run_case is None:
                    continue
                runner_dir = os.path.join(fork_dir, runner)
                for handler in sorted(os.listdir(runner_dir)):
                    handler_dir = os.path.join(runner_dir, handler)
                    for suite in sorted(os.listdir(handler_dir)):
                        suite_dir = os.path.join(handler_dir, suite)
                        for case in sorted(os.listdir(suite_dir)):
                            case_dir = os.path.join(suite_dir, case)
                            if not os.path.isdir(case_dir):
                                continue
                            try:
                                results.append(
                                    run_case(case_dir, handler, config, fork)
                                )
                            except Exception as e:  # noqa: BLE001
                                results.append(
                                    CaseResult(case_dir, False, f"crash: {e}")
                                )
    return results

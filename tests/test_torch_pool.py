"""The port's pools, reprocess queue and validator monitor
(lighthouse_tpu_torch/pool/{max_cover,naive_aggregation,operation_pool}.py,
processor/reprocess.py, chain/validator_monitor.py) against the JAX
package's on the CPU, with exact equality:

- `max_cover` picks the same items in the same order over seeded
  candidate sets;
- the NaiveAggregationPool aggregates the same attestations (a MINIMAL
  interop state of 64 validators, real signatures made on the port and
  carried as SSZ bytes) into the same SSZ bytes, and refuses the same
  inserts;
- the OperationPool packs the same attestations in the same order, holds
  the same slashings and exits, writes the same bytes under the same keys
  of a MemoryStore-backed HotColdDB, and loads them (whole or truncated)
  into the same pool;
- the ReprocessQueue (injected clock) releases the same items with the
  same stats;
- the ValidatorMonitor fed the same events, and the one a BeaconChain
  feeds while it imports the same block, report the same stats and move
  the metric families by the same amounts.

On the card (`gpu`): the naive pool's aggregates and the block the
operation pool packs verify on torch_cuda, the keys gathered from the
pubkey table there. No XLA compile."""

import importlib.util
import random
from pathlib import Path
from types import SimpleNamespace

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.chain import BeaconChain as JBeaconChain
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.chain import validator_monitor as JVM
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.pool import max_cover as jmax_cover
from lighthouse_tpu.pool import NaiveAggregationPool as JNaive
from lighthouse_tpu.pool import OperationPool as JOps
from lighthouse_tpu.processor import reprocess as JRQ
from lighthouse_tpu.state_transition import BlockSignatureStrategy as JStrategy
from lighthouse_tpu.store.hot_cold import HotColdDB as JHotColdDB
from lighthouse_tpu.store.kv import MemoryStore as JMemoryStore
from lighthouse_tpu.types import containers as JC
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain import BeaconChain
from lighthouse_tpu_torch.chain import validator_monitor as TVM
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.pool import NaiveAggregationPool as TNaive
from lighthouse_tpu_torch.pool import OperationPool as TOps
from lighthouse_tpu_torch.pool import max_cover as tmax_cover
from lighthouse_tpu_torch.processor import reprocess as TRQ
from lighthouse_tpu_torch.state_transition import BlockSignatureStrategy
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from lighthouse_tpu_torch.state_transition import signature_sets as TSS
from lighthouse_tpu_torch.store.hot_cold import HotColdDB
from lighthouse_tpu_torch.store.kv import MemoryStore
from lighthouse_tpu_torch.types import containers as TC
from lighthouse_tpu_torch.utils import metrics as TM
from torch_port_util import jax_keys_from_port, need_card, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

JSPEC = J.ChainSpec.interop(altair_fork_epoch=0)
TSPEC = T.ChainSpec.interop(altair_fork_epoch=0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    jax_keys_from_port(monkeypatch)
    monkeypatch.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _jax(obj):
    """A port SSZ object as the JAX package's, through its bytes."""
    name = type(obj).__name__
    cls = getattr(J.types_for(J.MINIMAL), name, None) or getattr(JC, name)
    return cls.from_ssz_bytes(obj.as_ssz_bytes())


# --- max_cover -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_max_cover_picks_the_same_items_in_order(seed):
    rng = random.Random(seed)
    items = [(i, {rng.randrange(40): rng.choice((1, 1, 2)) for _ in range(rng.randrange(1, 12))})
             for i in range(30)]
    limit = rng.choice((3, 8, 40))
    got = tmax_cover(items, lambda it: it[1], None, limit)
    assert got == jmax_cover(items, lambda it: it[1], None, limit)
    assert 0 < len(got) <= limit
    assert tmax_cover([], lambda it: it[1], None, 4) == []


# --- a MINIMAL state and its attestations -----------------------------------------


@pytest.fixture(scope="module")
def world():
    """The port's MINIMAL altair interop state (64 validators) at slot 3;
    the 8 unaggregated attestations of slot 2 (2 committees of 4), signed;
    and aggregates of slots 0-2 over seeded bit subsets (the operation
    pool does not parse signatures: each gets distinct stand-in bytes)."""
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        jax_keys_from_port(mp)
        C = CS.consensus_modules()
        preset = T.MINIMAL
        genesis = T.interop_genesis_state(64, preset, TSPEC)
        state = TPS.process_slots(TPS.clone_state(genesis), 3, preset, TSPEC)

        def secret_of(i):
            return T.interop_secret_key(i).scalar

        unagg = CS.gossip_unaggregated(C, state, preset, TSPEC, secret_of, 2, 8,
                                       CS.HostCrypto())
        t = T.types_for(preset)
        rng = random.Random(7)
        aggs = []
        cache = C.context.ConsensusContext(preset, TSPEC).committee_cache(state, 0)
        for slot in range(3):
            for index in range(cache.committees_per_slot):
                size = len(cache.get_beacon_committee(slot, index))
                data = CS.attestation_data(C, state, slot, index, preset)
                for _ in range(3):
                    bits = tuple(rng.random() < 0.6 for _ in range(size))
                    aggs.append(t.Attestation(aggregation_bits=bits, data=data,
                                              signature=bytes([len(aggs) + 1]) * 96))
        return SimpleNamespace(C=C, genesis=genesis, state=state, unagg=unagg,
                               aggs=aggs, secret_of=secret_of)


def _naive(pkg, world):
    pool = TNaive() if pkg == "torch" else JNaive()
    conv = (lambda a: a) if pkg == "torch" else _jax
    out = []
    for a in world.unagg + world.unagg[:2]:
        out.append(pool.insert(conv(a)))
    two = type(world.unagg[0]).from_ssz_bytes(world.unagg[0].as_ssz_bytes())
    two.aggregation_bits = (True, True) + tuple(two.aggregation_bits[2:])
    with pytest.raises(ValueError, match="single-bit"):
        pool.insert(conv(two))
    t = T.types_for(T.MINIMAL) if pkg == "torch" else J.types_for(J.MINIMAL)
    datas = {a.data.tree_hash_root(): a.data for a in world.unagg}
    aggs = [pool.get_aggregate(t, conv(d)).as_ssz_bytes() for d in datas.values()]
    missing = type(world.unagg[0].data).from_ssz_bytes(world.unagg[0].data.as_ssz_bytes())
    missing.index = 7
    return out, aggs, pool.get_aggregate(t, conv(missing))


def test_naive_pool_aggregates_equal_jax(world):
    got = _naive("torch", world)
    assert got == _naive("jax", world)
    inserted, aggs, missing = got
    assert inserted == [True] * 8 + [False, False]
    assert len(aggs) == 2 and missing is None
    a = T.types_for(T.MINIMAL).Attestation.from_ssz_bytes(aggs[0])
    assert all(a.aggregation_bits)
    # the aggregate verifies over its committee on the cpu oracle
    tapi.set_backend("cpu")
    C = world.C
    ind = C.context.ConsensusContext(T.MINIMAL, TSPEC).get_indexed_attestation(
        world.state, a)
    cache = C.pubkey_cache.ValidatorPubkeyCache(world.state, device="cpu")
    assert tapi.verify_signature_sets([TSS.indexed_attestation_signature_set(
        world.state, cache.getter(world.state), ind, T.MINIMAL, TSPEC)], seed=3) is True


# --- the operation pool ------------------------------------------------------------


def _ops_ops(pkg):
    """A voluntary exit and a proposer slashing, in the package's types."""
    M = TC if pkg == "torch" else JC
    exit_op = M.SignedVoluntaryExit(message=M.VoluntaryExit(epoch=0, validator_index=3),
                                    signature=b"\x11" * 96)
    h1, h2 = M.SignedBeaconBlockHeader.default(), M.SignedBeaconBlockHeader.default()
    h1.message.proposer_index = h2.message.proposer_index = 5
    h2.message.slot = 1
    return exit_op, M.ProposerSlashing(signed_header_1=h1, signed_header_2=h2)


def _ops(pkg, world):
    torch_side = pkg == "torch"
    conv = (lambda a: a) if torch_side else _jax
    preset, spec = (T.MINIMAL, TSPEC) if torch_side else (J.MINIMAL, JSPEC)
    Ops = TOps if torch_side else JOps
    state = world.state if torch_side else J.decode_state_any_fork(
        world.state.as_ssz_bytes(), J.MINIMAL)
    pool = Ops(preset, spec)
    for a in world.aggs + world.unagg:
        pool.insert_attestation(conv(a))
    exit_op, slashing = _ops_ops(pkg)
    pool.insert_voluntary_exit(exit_op)
    pool.insert_proposer_slashing(slashing)
    packed = [a.as_ssz_bytes() for a in pool.get_attestations(state)]
    ops = pool.get_slashings_and_exits(state)
    store = (HotColdDB(MemoryStore(), preset, spec) if torch_side
             else JHotColdDB(JMemoryStore(), preset, spec))
    pool.persist(store)
    written = {c: dict(kv) for c, kv in store.kv._data.items()}
    loaded = Ops.load(store, preset, spec)
    repacked = [a.as_ssz_bytes() for a in loaded.get_attestations(state)]
    blob = store.get_chain_item(Ops._PERSIST_KEY)
    batch = store.batch()
    batch.stage_chain_item(Ops._PERSIST_KEY, blob[: len(blob) // 3])
    batch.commit()
    torn = Ops.load(store, preset, spec, log=SimpleNamespace(warn=lambda *a, **k: None))
    pool.prune(state)
    return (pool.num_attestations(), packed, [[o.as_ssz_bytes() for o in x] for x in ops],
            written, loaded.num_attestations(), repacked, torn.num_attestations(),
            torn.persist_load_error, sorted(loaded._voluntary_exits),
            sorted(loaded._proposer_slashings), pool.num_attestations())


def test_operation_pool_packs_and_persists_like_jax(world):
    got = _ops("torch", world)
    assert got == _ops("jax", world)
    held, packed, ops, written, n_loaded, repacked, n_torn, torn_err, exits, \
        slashings, after_prune = got
    assert 8 <= len(packed) <= held and repacked == packed and n_loaded == held
    assert written and n_torn < held and torn_err.startswith("SszError")
    assert exits == [3] and slashings == [5]
    assert len(ops[0]) == 1 and ops[1:] == [[], []]  # validator 5 is slashable
    # max_cover's first pick covers the most validators
    t = T.types_for(T.MINIMAL)
    first = t.Attestation.from_ssz_bytes(packed[0])
    assert sum(first.aggregation_bits) == max(
        sum(a.aggregation_bits) for a in world.aggs + world.unagg
        if a.data.slot + 1 <= world.state.slot)


def test_operation_pool_load_of_an_empty_store():
    for Ops, store, preset, spec in (
            (TOps, HotColdDB(MemoryStore(), T.MINIMAL, TSPEC), T.MINIMAL, TSPEC),
            (JOps, JHotColdDB(JMemoryStore(), J.MINIMAL, JSPEC), J.MINIMAL, JSPEC)):
        pool = Ops.load(store, preset, spec)
        assert pool.num_attestations() == 0 and pool.persist_load_error is None


# --- the reprocess queue ------------------------------------------------------------


def _reprocess(RQ):
    now = [0.0]
    rq = RQ.ReprocessQueue(delay_s=10.0, clock=lambda: now[0])
    log = []
    log.append(rq.defer("gossip_attestation", "att1", b"\x01" * 32, b"k1"))
    log.append(rq.defer("gossip_aggregate", "agg1", b"\x01" * 32, b"k2"))
    log.append(rq.defer("gossip_attestation", "att2", b"\x02" * 32, b"k3"))
    now[0] = 5.0
    log.append(rq.defer("gossip_attestation", "att3", b"\x03" * 32, b"k4"))
    log.append(len(rq))
    log.append(rq.on_block_imported(b"\x01" * 32))
    log.append(rq.on_block_imported(b"\x01" * 32))
    log.append(rq.poll())
    now[0] = 11.0
    log.append(rq.poll())
    log.append(rq.defer("gossip_attestation", "att2", b"\x02" * 32, b"k3"))
    now[0] = 16.0
    log.append(rq.poll())
    rq.MAX_WAITING = 1
    log.append(rq.defer("q", 1, b"\x09" * 32, b"a"))
    log.append(rq.defer("q", 2, b"\x09" * 32, b"b"))
    log.append(len(rq))
    return log, dict(rq.stats)


def test_reprocess_queue_equals_jax():
    got = _reprocess(TRQ)
    assert got == _reprocess(JRQ)
    log, stats = got
    assert log[5] == [("gossip_attestation", "att1"), ("gossip_aggregate", "agg1")]
    assert log[8] == [("gossip_attestation", "att2")] and log[9] is False
    assert stats == {"deferred": 5, "flushed_by_block": 2, "matured": 2,
                     "expired_refused": 1, "shed": 1}


# --- the validator monitor ----------------------------------------------------------


FAMILIES = ("VALIDATOR_MONITOR_PROPOSALS", "VALIDATOR_MONITOR_ATTESTATIONS",
            "VALIDATOR_MONITOR_TARGET_MISSES", "VALIDATOR_MONITOR_HEAD_MISSES",
            "VALIDATOR_MONITOR_SYNC_SIGNATURES", "VALIDATOR_MONITOR_SLASHED")


def _metric_values(M):
    return [getattr(M, n).value for n in FAMILIES] + [
        M.VALIDATOR_MONITOR_INCLUSION_DELAY.count]


def _monitor(VM, M, states):
    before = _metric_values(M)
    mon = VM.ValidatorMonitor()
    auto = VM.ValidatorMonitor(auto_register=True)
    for m in (mon, auto):
        for i in (1, 3, 5, 60):
            m.register_validator(i)
        m.on_block_observed(b"\x07" * 32, 9, 100.0)
        m.on_block_imported(b"\x07" * 32, SimpleNamespace(slot=9, proposer_index=3), 100.5)
        m.on_attestation_included([1, 2, 3], 8, 9)
        m.on_attestation_included([1, 5], 6, 9)
        m.on_attestation_included([1], 8, 12)
        m.on_gossip_attestation([1, 5, 7], 8)
        m.on_sync_committee_message(5, 9)
        m.on_sync_committee_message(8, 9)
        m.on_exit_observed(60, 1)
        m.on_slashing_observed([3, 4], 1)
        for s in states:
            m.evaluate_epoch(s, T.MINIMAL if VM is TVM else J.MINIMAL)
    out = [(sorted(m.validators), [m.stats(i) for i in sorted(m.validators)],
            m.stats(999), m.block_times[b"\x07" * 32].import_latency)
           for m in (mon, auto)]
    return out, [a - b for a, b in zip(_metric_values(M), before)]


def test_validator_monitor_equals_jax(world):
    """Direct feeds, then per-epoch grading over states at epochs 2, 3
    and (a reorg to) 2 again, participation flags set for some
    validators."""
    states = []
    s = world.genesis
    for slot, flags in ((2 * 8, {1: 7, 5: 2}), (3 * 8, {1: 3}), (2 * 8 + 1, {})):
        s2 = TPS.process_slots(TPS.clone_state(world.genesis), slot, T.MINIMAL, TSPEC)
        part = list(s2.previous_epoch_participation)
        for i, f in flags.items():
            part[i] = f
        s2.previous_epoch_participation = part
        states.append(s2)
    jstates = [J.decode_state_any_fork(x.as_ssz_bytes(), J.MINIMAL) for x in states]
    got = _monitor(TVM, TM, states)
    assert got == _monitor(JVM, JM, jstates)
    (fixed, auto), deltas = got
    assert fixed[0] == [1, 3, 5, 60] and len(auto[0]) > 4
    assert fixed[3] == 0.5 and fixed[2] is None
    assert deltas[0] == 2 and deltas[4] == 3  # the auto-registering one counts 8 too


def _chain_monitor(pkg, world, block):
    torch_side = pkg == "torch"
    if torch_side:
        chain = BeaconChain(HotColdDB(MemoryStore(), T.MINIMAL, TSPEC), world.genesis,
                            T.MINIMAL, TSPEC, device="cpu")
        chain.validator_monitor = TVM.ValidatorMonitor(auto_register=True)
        strategy = BlockSignatureStrategy.NO_VERIFICATION
    else:
        jgenesis = J.decode_state_any_fork(world.genesis.as_ssz_bytes(), J.MINIMAL)
        chain = JBeaconChain(JHotColdDB(JMemoryStore(), J.MINIMAL, JSPEC), jgenesis,
                             J.MINIMAL, JSPEC)
        chain.validator_monitor = JVM.ValidatorMonitor(auto_register=True)
        block = J.decode_block_any_fork(block.as_ssz_bytes(), J.MINIMAL)
        strategy = JStrategy.NO_VERIFICATION
    chain.slot_clock.set_slot(int(block.message.slot))
    root = chain.process_block(block, strategy=strategy)
    mon = chain.validator_monitor
    return root, sorted(mon.validators), [mon.stats(i) for i in sorted(mon.validators)]


def test_beacon_chain_feeds_the_monitor_like_jax(world):
    """A block at slot 3 with the attestations of slots 0-2 imports into
    both packages' BeaconChain with an auto-registering monitor: the same
    proposer and inclusion-delay stats."""
    C = world.C
    block, _ = CS.produce_block(C, world.state, T.MINIMAL, TSPEC, world.secret_of,
                                CS.HostCrypto())
    got = _chain_monitor("torch", world, block)
    assert got == _chain_monitor("jax", world, block)
    root, indices, stats = got
    assert root == block.message.tree_hash_root()
    proposer = int(block.message.proposer_index)
    assert stats[indices.index(proposer)]["blocks_proposed"] == 1
    assert sum(s["attestations_included"] for s in stats) > 0


@pytest.mark.gpu
def test_pool_aggregates_and_packed_block_verify_on_the_card(world):
    need_card()
    C = world.C
    tapi.set_backend("torch_cuda")
    pool, ops = TNaive(), TOps(T.MINIMAL, TSPEC)
    for a in world.unagg:
        pool.insert(a)
        ops.insert_attestation(a)
    t = T.types_for(T.MINIMAL)
    cache = C.pubkey_cache.ValidatorPubkeyCache(world.state)
    ctxt = C.context.ConsensusContext(T.MINIMAL, TSPEC)
    sets = []
    for data in {a.data.tree_hash_root(): a.data for a in world.unagg}.values():
        agg = pool.get_aggregate(t, data)
        sets.append(TSS.indexed_attestation_signature_set(
            world.state, cache.getter(world.state),
            ctxt.get_indexed_attestation(world.state, agg), T.MINIMAL, TSPEC))
    assert tapi.verify_signature_sets(sets) is True
    packed = ops.get_attestations(world.state)
    block, _ = CS.produce_block(C, world.state, T.MINIMAL, TSPEC, world.secret_of,
                                CS.HostCrypto(), attestations=packed)
    chain = BeaconChain(HotColdDB(MemoryStore(), T.MINIMAL, TSPEC), world.genesis,
                        T.MINIMAL, TSPEC)
    chain.slot_clock.set_slot(3)
    assert chain.process_block(block) == block.message.tree_hash_root()

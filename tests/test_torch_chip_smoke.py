"""chip_smoke.py's host-side helpers on the CPU: the kernel metadata it
reports, the profiler keys it reads each kernel's device time from, the
launch counts it holds every verify to, its summary of nvcc's ptxas
report, the host side of the block and attestations phases at MINIMAL
(the tiled registry, the block's set and key counts, the gossip batches
through the processor, the bisection bound), and of the chain phase (a
block built with its state root imports, a 4-block segment links and
verifies in one call of all its sets, the forged segment is rejected,
the oracle's verdict over parts), of the sync and pool phases, and of
the genesis and finality phases (the deposits and their tree, the EF
tree's BLS cases through the port's walker on the cpu oracle, the
harness's first blocks over a NativeStore, a forged block, fsck and the
store reopened), and of the http phase (the card checks on its chains,
its request and SSE helpers over a server). (The script itself needs a
card: `python3 chip_smoke.py`.)"""

import glob
import importlib.util
import os
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K
from lighthouse_tpu_torch.crypto.bls.gpu import pairing as TP

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)


def test_every_kernel_has_its_metadata():
    assert set(CS.KERNEL_META) == set(K.LAUNCHES)
    assert set(CS.KERNEL_SYMBOL) == set(K.LAUNCHES)
    assert set(CS.ROW_BYTES) == set(K.LAUNCHES)
    assert set(CS._op_counts()) == set(K.LAUNCHES)


@pytest.mark.parametrize("name", sorted(K.LAUNCHES))
def test_profiler_key_names_exactly_its_kernel(name):
    """Among the demangled names of all seven kernels, a wrapper's symbol
    matches its own only (fp_mul_kernel is not fp6_mul_kernel or
    fp12_mul_kernel), and its source defines a kernel of that name."""
    keys = {n: "(anonymous namespace)::%s(int*, int const*, int)" % sym
            for n, sym in CS.KERNEL_SYMBOL.items()}
    symbol = CS.KERNEL_SYMBOL[name]
    assert [n for n, key in keys.items() if CS.is_kernel_key(symbol, key)] == [name]
    assert CS.is_kernel_key(symbol, symbol)
    src = (ROOT / CS.KERNEL_META[name][0]).read_text()
    assert re.search(r"__global__[^;{]*\b%s\(" % symbol, src)


@pytest.mark.parametrize("name", ["fp_sq", "fp_mul", "fp12_mul"])
def test_kernels_phase_times_the_main_paths_one_row(name):
    """The kernels phase runs fp_sq, fp_mul and fp12_mul at one row, the
    shape of most of their launches (the inversions' and the final
    exponentiation's chains), and reports it first (the JSON line's
    shape); fp_sq and fp_mul also at the aggregate batch's largest launch
    of each (2048 and 98,304 rows); each kernel's profiler symbol is a
    __global__ of its source."""
    rows = CS.KERNEL_ROWS[name]
    assert rows[0] == 1 and len(set(rows)) == len(rows)
    assert {"fp_sq": 2048, "fp_mul": 98304}.get(name, 1) in rows
    src = (ROOT / CS.KERNEL_META[name][0]).read_text()
    assert re.search(r"__global__[^;{]*\b%s\(" % CS.KERNEL_SYMBOL[name], src)
    assert set(CS.KERNEL_ROWS) == set(K.LAUNCHES)


def test_launch_rows_tally_by_row_count_and_reset(monkeypatch):
    """row_tally counts each launch of the kernels' launch function by its
    row count (a zero-row call launches nothing), launch_rows gives the
    tally as {kernel: {rows: launches}} in ascending rows, and the launch
    function is put back when the block ends."""
    seen = []

    def stub(what, lib, fn, outs, ins, n):
        seen.append((what, n))

    monkeypatch.setattr(K, "_launch", stub)
    with CS.row_tally(K) as tally:
        for n in (1024, 1, 128, 1, 0, 1):
            K._launch("fp_sq", "fp", "lh_fp_sq", [], [], n)
    assert K._launch is stub
    assert len(seen) == 6
    rows = CS.launch_rows(tally)
    assert set(rows) == set(K.LAUNCHES)
    assert list(rows["fp_sq"].items()) == [("1", 3), ("128", 1), ("1024", 1)]
    assert rows["fp_mul"] == {}


def test_launch_rows_tally_graph_replays_not_captures(monkeypatch):
    """A launch made inside a graph capture is recorded, neither counted
    nor tallied; each replay of the graph counts and tallies its capture's
    record, rows and all; both functions are put back when the block
    ends."""
    def stub(what, lib, fn, outs, ins, n):  # the launch function's counting
        log = getattr(K._capture, "log", None)
        if log is None:
            K.LAUNCHES[what] += 1
        else:
            log.append((what, n))

    monkeypatch.setattr(K, "_launch", stub)
    monkeypatch.setattr(K, "LAUNCHES", dict.fromkeys(K.LAUNCHES, 0))
    replay = K.count_replay
    with CS.row_tally(K) as tally:
        with K.recording() as record:
            K._launch("fp_sq", "fp", "lh_fp_sq", [], [], 1)
            K._launch("fp12_mul", "tower", "lh_fp12_mul", [], [], 64)
        assert record == [("fp_sq", 1), ("fp12_mul", 64)]
        assert not any(K.LAUNCHES.values())
        assert not any(tally.values())
        for _ in range(2):
            K.count_replay(tuple(record))
        K._launch("fp_sq", "fp", "lh_fp_sq", [], [], 1)
    assert K._launch is stub and K.count_replay is replay
    assert K.LAUNCHES["fp_sq"] == 3 and K.LAUNCHES["fp12_mul"] == 2
    rows = CS.launch_rows(tally)
    assert rows["fp_sq"] == {"1": 3} and rows["fp12_mul"] == {"64": 2}


def test_build_directory_keyed_by_its_sources(monkeypatch, tmp_path):
    """The kernels build into a directory named by a hash of the sources,
    so an edited source never loads the libraries built before it."""
    for p in K.CSRC.glob("*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(K, "CSRC", tmp_path)
    base = K._source_hash()
    assert K._source_hash() == base
    src = tmp_path / "fp_kernels.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert K._source_hash() != base


@pytest.mark.parametrize("pairs, fp12_mul", [(65, 42), (33, 41), (257, 44), (5, 38),
                                             (9, 39), (17, 40)])
def test_expected_launches_of_one_verify(pairs, fp12_mul):
    """63 doubling and 5 addition steps (|x|'s bits after the leading one,
    and its one-bits), 5 x 63 + 1 cyclotomic squares, one fp6_mul, and 35
    fp12_mul plus ceil(log2(pairs)): the gossip batch's 65 pairs, the
    aggregate batch's 33 (and the sync phase's contributions), the gossip
    batch padded to 256 sets; the sync and pool phases' 512 messages over
    one root, the light-client update and a 3-set aggregate (5), the
    confirmed aggregates (9) and the contributions' bisection halves
    (17)."""
    assert CS.expected_launches(TP, pairs) == {
        "miller_dbl_step": 63,
        "miller_add_step": 5,
        "fp12_cyclotomic_sq": 316,
        "fp12_mul": fp12_mul,
        "fp6_mul": 1,
    }


PTXAS = """\
ptxas info    : 5632 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__1c08517f_16_tower_kernels_cu_947dd55a20fp12_cyclo_sq_kernelEPiPKii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__1c08517f_16_tower_kernels_cu_947dd55a20fp12_cyclo_sq_kernelEPiPKii
    72 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 72 bytes cumulative stack size, 19876 bytes smem
ptxas info    : Compile time = 122.732 ms
ptxas info    : Function properties for _ZNK2lh4coop4Warp6fp2_sqEPKi
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__1c08517f_16_tower_kernels_cu_947dd55a15fp12_mul_kernelEPiPKiS2_i' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__1c08517f_16_tower_kernels_cu_947dd55a15fp12_mul_kernelEPiPKiS2_i
    12224 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 12224 bytes cumulative stack size
"""


def test_ptxas_summary_names_each_kernel_with_its_resources():
    """One line per entry function (its name unmangled out of the
    anonymous namespace, registers, stack, shared memory), then the most
    spill bytes of any function of the library."""
    assert CS.ptxas_summary(PTXAS) == [
        "fp12_cyclo_sq_kernel: Used 32 registers, used 1 barriers, 72 bytes "
        "cumulative stack size, 19876 bytes smem",
        "fp12_mul_kernel: Used 168 registers, used 0 barriers, 12224 bytes "
        "cumulative stack size",
        "most spill bytes of any function: 4",
    ]


def test_pipeline_phase_runs_last_on_warmed_buckets():
    """The pipeline phase comes after every phase it can reuse; each of its
    buckets but the aggregate batch's is one warm_compile captures by
    default, the scheduler's 16-set entries' natural bucket among them,
    and the gossip batch merges to exactly a warm capacity."""
    from lighthouse_tpu_torch.crypto.bls import scheduler as S
    from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as B

    at = CS.ALL_PHASES.index("pipeline")
    assert set(CS.ALL_PHASES[:at]) >= {"gossip", "aggregate", "warm", "table"}
    # after it only the phases that reuse none of its state
    assert CS.ALL_PHASES[at + 1:] == ("monolith", "windowed", "correct", "adversary",
                                      "block", "attestations", "chain", "sync", "pool",
                                      "genesis", "finality", "merge", "network", "http",
                                      "scenario")
    warm = set(B.DEFAULT_WARM_BUCKETS)
    assert [b for b in CS.PIPELINE_BUCKETS if b not in warm] == [(1024, 4, 32)]
    assert (16, 4, 16) in warm and S.warm_capacity(64) == 64
    assert CS.STREAM_K == 8


class _Future:
    def __init__(self, verdict, done):
        self.verdict, self.is_done = verdict, done

    def done(self):
        return self.is_done

    def result(self):
        return self.verdict


class _StreamApi:
    """Sync verdicts from the sets; futures that report `done` as told,
    with verdicts optionally flipped."""

    def __init__(self, done, flip=()):
        self.done, self.flip, self.n = done, set(flip), 0

    def verify_signature_sets(self, sets, seed=None):
        return "bad" not in sets

    def verify_signature_sets_async(self, sets, seed=None):
        n, self.n = self.n, self.n + 1
        v = self.verify_signature_sets(sets, seed)
        return _Future(v != (n in self.flip), self.done(n))


class _StreamK:
    """Launch counts as a stream of `stream` would leave them."""

    def __init__(self, stream):
        self.stream = stream

    def reset_launches(self):
        self.LAUNCHES = dict.fromkeys(K.LAUNCHES, 0)
        for _, pairs in self.stream:
            for name, n in CS.expected_launches(TP, pairs).items():
                self.LAUNCHES[name] += n
        self.LAUNCHES["fp_mul"] = self.LAUNCHES["fp_sq"] = 1


class _Torch:
    class cuda:  # noqa: N801 -- torch.cuda's shape
        @staticmethod
        def synchronize():
            pass


class _Pipeline:
    @staticmethod
    def configure(**kw):
        pass


STREAM = [(["ok"], 65), (["ok"], 33), (["bad"], 65), (["ok"], 33)] * 2


@pytest.mark.parametrize("done, flip, fails", [
    (lambda n: False, (), None),
    (lambda n: n == 3, (), None),  # one batch may finish early
    (lambda n: n in (3, 5), (), "already done right after submit"),
    (lambda n: True, (), "already done right after submit"),
    (lambda n: False, (2,), "futures"),
])
def test_pipeline_stream_needs_sync_verdicts_and_pending_futures(done, flip, fails):
    """The stream's needs: every future's verdict is the sync verify's, and
    future N is still pending right after submit(N+1) for at least K - 2
    batches; a dispatch that synced the card would leave them done."""
    run = lambda: CS.pipeline_stream(  # noqa: E731
        _Torch, _StreamK(STREAM), TP, _StreamApi(done, flip), _Pipeline,
        "stream", STREAM, {}, "card")
    if fails is None:
        out = run()
        assert out["verdicts"] == [s[0] != "bad" for s, _ in STREAM]
        assert out["batches"] == 8 and len(out["not_done_after_next"]) == 7
    else:
        with pytest.raises(CS.Fail, match=fails):
            run()


def test_scheduler_run_merges_four_lanes_into_one_launch(monkeypatch):
    """The scheduler part of the pipeline phase on the fake backend: four
    entries on the four validator lanes merge into one launch, in lane
    order, and no stage graph is captured."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls import pipeline as P
    from lighthouse_tpu_torch.crypto.bls import scheduler as S
    from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as B
    from lighthouse_tpu_torch.utils import metrics as M

    class Set:
        pubkeys = [1]

    monkeypatch.setenv("LIGHTHOUSE_TPU_CONT_BATCH", "1")
    saved = api._BACKEND, api._BACKEND_NAME
    api.set_backend("fake")
    try:
        P.configure(depth=2)
        lanes = ("block", "aggregate", "unaggregated", "sync")
        verdicts, sched, _, captured, new = CS.scheduler_run(
            api, S, B, M, "sched", [[Set()] * 16] * 4, lanes, 80)
    finally:
        api._BACKEND, api._BACKEND_NAME = saved
        S.configure()
        P.configure()
    assert verdicts == [True] * 4 and (captured, new) == (0, 0)
    assert sched.stats["launches"] == 1 and sched.stats["real_sets"] == 64
    assert sched.stats["pad_sets"] == 0 and sched.launch_log[0]["lanes"] == lanes


def _spin_torch(spin_s=0.2):
    """torch as busy_card_dispatch sees it: `_sleep` queues a spin that
    `synchronize` (and anything that syncs) waits out."""
    import time
    from types import SimpleNamespace

    state = {"until": 0.0}

    def _sleep(cycles):
        state["until"] = time.perf_counter() + spin_s

    def synchronize():
        time.sleep(max(0.0, state["until"] - time.perf_counter()))

    class Host:
        def to(self, device):  # a pageable copy: waits for the stream
            synchronize()
            return self

    return SimpleNamespace(cuda=SimpleNamespace(_sleep=_sleep, synchronize=synchronize),
                           zeros=lambda n: Host())


@pytest.mark.parametrize("dispatch_waits", [False, True])
def test_busy_card_dispatch_needs_submits_that_do_not_wait(dispatch_waits):
    """Behind a spin, a pageable copy waits it out (the method's own
    check) and a submit must not: one that synchronizes fails the run."""
    torch = _spin_torch()

    class Api:
        def verify_signature_sets_async(self, sets, seed=None):
            if dispatch_waits:
                torch.cuda.synchronize()
            return _Future(True, False)

    batches = {"gossip": (["g"], None, 65), "aggregate": (["a"], None, 33)}
    if dispatch_waits:
        with pytest.raises(CS.Fail, match="dispatch waited on the card"):
            CS.busy_card_dispatch(torch, Api(), _Pipeline, batches, "card")
        return
    out = CS.busy_card_dispatch(torch, Api(), _Pipeline, batches, "card")
    assert out["pageable_copy_ms"] > out["spin_ms"] / 2
    assert out["gossip"]["submit_ms"] < out["spin_ms"] / 4


def test_env_pinned_sets_and_restores(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_MONOLITH", "0")
    monkeypatch.delenv("LIGHTHOUSE_TPU_PALLAS", raising=False)
    import os

    with CS.env_pinned(LIGHTHOUSE_TPU_MONOLITH="1", LIGHTHOUSE_TPU_PALLAS="1"):
        assert os.environ["LIGHTHOUSE_TPU_MONOLITH"] == "1"
        assert os.environ["LIGHTHOUSE_TPU_PALLAS"] == "1"
    assert os.environ["LIGHTHOUSE_TPU_MONOLITH"] == "0"
    assert "LIGHTHOUSE_TPU_PALLAS" not in os.environ


class _Proc:
    def __init__(self, rc, paths):
        import json

        self.returncode = rc
        self.stdout = "card line\n" + json.dumps({"paths": paths}) + "\n{\"ok\": true}"
        self.stderr = ""


@pytest.mark.parametrize("rc, fails", [(0, None), (1, "child exited 1")])
def test_windowed_phase_runs_a_child_with_the_switch(monkeypatch, rc, fails):
    """The windowed phase starts this script again with
    LIGHTHOUSE_TPU_PALLAS=1 and the windowed-child phase, fails on its
    nonzero exit, and adds the child's launches to the run's."""
    import subprocess

    seen = {}
    counts = {"fp_mul": 3, "fp_sq": 4}
    child = {"gossip": {"launches": counts}, "aggregate": {"launches": counts}}

    def run(cmd, env, **kw):
        seen.update(cmd=cmd, pallas=env.get("LIGHTHOUSE_TPU_PALLAS"))
        return _Proc(rc, {"windowed-child": child})

    monkeypatch.setattr(subprocess, "run", run)
    launches = {"fp_mul": 1}
    if fails:
        with pytest.raises(CS.Fail, match=fails):
            CS.phase_windowed("card", launches)
        return
    out = CS.phase_windowed("card", launches)
    assert seen["pallas"] == "1" and seen["cmd"][-2:] == ["--phases", "build,windowed-child"]
    assert launches == {"fp_mul": 7, "fp_sq": 8} and out["gossip"] == child["gossip"]
    assert "windowed-child" in CS.CHILD_PHASES and "windowed-child" not in CS.ALL_PHASES


# --- the block and attestations phases' host side, at MINIMAL ------------------


def test_block_and_attestations_phases_run_last():
    """Last but for the chain phase, which imports the block phase's block,
    the sync and pool phases, which go on from its chain, the genesis
    and finality phases, which run over their own MINIMAL chains, and the
    merge, network and http phases, and the scenario phase."""
    assert CS.ALL_PHASES[-11:-9] == ("block", "attestations")
    assert "block " in CS.__doc__ and "attestations " in CS.__doc__
    assert CS.BLOCK_VALIDATORS // 32 // 128 == 4 and CS.BLOCK_DISTINCT_KEYS >= 1024
    assert (CS.GOSSIP_UNAGGREGATED, CS.GOSSIP_AGGREGATES) == (64, 32)
    assert [len(b) for b in CS.FORGED_UNAGGREGATED] == [1]
    assert [len(b) for b in CS.FORGED_AGGREGATES] == [1]


@pytest.mark.parametrize("k, n, bound", [
    (1, 64, 7), (3, 64, 21), (1, 32, 6), (3, 32, 18), (1, 1024, 11), (2, 7, 8),
    (1, 1, 0)])
def test_bisection_bound_is_k_log_n(k, n, bound):
    """k (ceil(log2 n) + 1): tests/test_bls_pipeline.py's
    test_k_bad_costs_k_log_n and its 11 calls for one bad item in 1024."""
    assert CS.bisection_bound(k, n) == bound


@pytest.fixture(scope="module")
def minimal_chain():
    """A MINIMAL altair registry of 64 validators tiled from 16 interop
    keys at slot 7, its pubkey cache on the CPU, and the block the phase
    builds over it."""
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    C = CS.consensus_modules()
    T = C.types
    preset, spec = T.MINIMAL, T.ChainSpec.interop(altair_fork_epoch=0)
    state, secret_of = CS.registry_state(C, preset, spec, 64, 16, CS.HostCrypto())
    state = C.per_slot.process_slots(state, 7, preset, spec)
    cache = C.pubkey_cache.ValidatorPubkeyCache(state, device="cpu")
    block, _ = CS.produce_block(C, state, preset, spec, secret_of, CS.HostCrypto())
    return C, state, preset, spec, secret_of, cache, block


def test_registry_is_tiled_interop_genesis(minimal_chain):
    C, state, preset, spec, secret_of, cache, _ = minimal_chain
    T = C.types
    assert state.fork_name == "altair" and len(state.validators) == 64
    for i in (0, 15, 16, 63):
        sk, pk = T.interop_keypair(i % 16)
        assert bytes(state.validators[i].pubkey) == pk.to_bytes()
        assert secret_of(i) == sk.scalar
    assert state.eth1_deposit_index == 64
    assert len(cache) == 64 and cache.getter(state)(17).validator_index == 17


def test_block_builder_set_and_key_counts(minimal_chain):
    """At slot 7 of MINIMAL (2 committees of 4 a slot): 14 full-committee
    attestations of slots 0-6, one more of each slot-6 committee without
    one member, a full sync aggregate (32 keys), randao and proposal: 19
    sets, 96 keys, every key table-tagged; a forged attestation changes
    one signature only."""
    C, state, preset, spec, secret_of, cache, block = minimal_chain
    from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as B

    atts = block.message.body.attestations
    assert len(atts) == 16
    assert [sum(a.aggregation_bits) for a in atts] == [4] * 14 + [3, 3]
    assert all(a.data.slot == 6 for a in atts[-4:])
    v = C.bsv.BlockSignatureVerifier(state, preset, spec, get_pubkey=cache.getter(state),
                                     resolve_pubkey=cache.resolve)
    v.include_all_signatures(block)
    assert len(v.sets) == 19 and CS.block_key_count(v.sets) == 96
    assert B._common_table(v.sets) is cache
    forged = CS.forge_attestation(C, state, preset, spec, secret_of, block, 7,
                                    CS.HostCrypto())
    diff = [i for i, (a, b) in enumerate(zip(atts, forged.message.body.attestations))
            if a.as_ssz_bytes() != b.as_ssz_bytes()]
    assert diff == [7]


def test_block_verdicts_on_the_cpu_oracle(minimal_chain):
    C, state, preset, spec, secret_of, cache, block = minimal_chain
    from lighthouse_tpu_torch.crypto.bls.backends import cpu as CPU

    for signed, want in ((block, True),
                         (CS.forge_attestation(C, state, preset, spec, secret_of,
                                               block, 7, CS.HostCrypto()), False)):
        v = C.bsv.BlockSignatureVerifier(state, preset, spec,
                                         get_pubkey=cache.getter(state),
                                         resolve_pubkey=cache.resolve)
        v.include_all_signatures(signed)
        assert CPU.verify_signature_sets(v.sets, seed=31) is want


def test_gossip_through_the_processor_isolates_forgeries(minimal_chain):
    """The attestations phase's wiring on the cpu backend: the handlers'
    PendingBatches resolve through the processor; with a forged item in
    each batch, that item alone is rejected, within the bisection bound,
    and every other item verified."""
    C, state, preset, spec, secret_of, cache, _ = minimal_chain
    host = CS.HostCrypto()
    saved = (C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE)
    C.api.set_backend("cpu")
    try:
        chain = CS.gossip_chain(C, state, preset, spec, cache, 7)
        un = CS.gossip_unaggregated(C, state, preset, spec, secret_of, 6, 4, host)
        ag = CS.gossip_aggregates(C, state, preset, spec, secret_of, 2, host)
        bad_un = CS.forge_gossip(C, state, preset, spec, secret_of, un, (1,), host)
        bad_ag = CS.forge_gossip(C, state, preset, spec, secret_of, ag, (0,), host)
        calls0 = C.metrics.BLS_BISECTION_CALLS.value
        res, bp = CS.process_gossip(C, chain, bad_un, bad_ag)
        assert bp.processed["gossip_attestation"] == 4
        assert bp.processed["gossip_aggregate"] == 2
        assert C.metrics.BLS_BISECTION_CALLS.value - calls0 <= (
            CS.bisection_bound(1, 4) + CS.bisection_bound(1, 2))
        got, rejected = CS.verdicts(bad_un, res["unaggregated"])
        assert rejected == {bad_un[1].tree_hash_root(): "invalid signature"}
        assert got == {a.tree_hash_root() for i, a in enumerate(un) if i != 1}
        got, rejected = CS.verdicts(bad_ag, res["aggregate"])
        assert rejected == {bad_ag[0].tree_hash_root(): "invalid signature"}
        assert got == {ag[1].tree_hash_root()}
    finally:
        C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE = saved


# --- the chain phase's host side, at MINIMAL ------------------------------------


def test_chain_phase_runs_after_block_and_attestations():
    """It imports the block phase's block, over the registry they share."""
    assert CS.ALL_PHASES[-11:-8] == ("block", "attestations", "chain")
    assert "chain " in CS.__doc__
    assert CS.CHAIN_SEGMENT == 4 and 0 < CS.CHAIN_FORGED < CS.CHAIN_SEGMENT


class _OracleHost:
    """HostCrypto's oracle as a list of the parts it was asked about, each
    part's verdict False iff it holds a set named "bad"."""

    def __init__(self):
        self.parts = []

    def oracle(self, batches, seed):
        self.parts.extend(batches)
        return lambda: ["bad" not in b for b in batches]


@pytest.mark.parametrize("n, bad", [(1, False), (7, False), (524, False), (524, True)])
def test_oracle_verdict_splits_a_batch_over_the_pool(n, bad):
    """The cpu oracle's verdict on a batch is the AND of its parts' (at
    most one a worker), which cover the batch once, in order."""
    sets = ["ok"] * n
    if bad:
        sets[300] = "bad"
    host = _OracleHost()
    assert CS.oracle_verdict(host, sets, 37)() is not bad
    assert len(host.parts) == min(n, 8)
    assert [x for p in host.parts for x in p] == sets


@pytest.fixture(scope="module")
def minimal_import():
    """MINIMAL altair genesis of 64 validators tiled from 16 keys; a
    segment of 4 blocks at slots 1-4 built as the chain phase builds them
    (each with its state root, on the post-state of the one before); and
    the segment's first two blocks with attestation 1 of the second
    forged."""
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    C = CS.consensus_modules()
    T = C.types
    preset, spec = T.MINIMAL, T.ChainSpec.interop(altair_fork_epoch=0)
    host = CS.HostCrypto()
    genesis, secret_of = CS.registry_state(C, preset, spec, 64, 16, host)
    segment, posts = CS.produce_segment(C, genesis, preset, spec, secret_of, host, 4)
    forged, _ = CS.produce_segment(C, posts[0], preset, spec, secret_of, host, 1,
                                   forge=1)
    return C, genesis, preset, spec, segment, posts, [segment[0]] + forged


def _ssz(state):
    """A state as a Twin takes its genesis: (fork, SSZ bytes)."""
    return state.fork_name, state.as_ssz_bytes()


def _chain_on(C, genesis, preset, spec, device="cpu"):
    return C.beacon_chain.BeaconChain(
        C.hot_cold.HotColdDB(C.kv.MemoryStore(), preset, spec), genesis, preset, spec,
        device=device)


@pytest.fixture
def backend(minimal_import):
    """Select a backend of the port for the test (restored after)."""
    C = minimal_import[0]
    saved = (C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE)
    yield C.api.set_backend
    C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE = saved


def _fake_calls(monkeypatch, C):
    from lighthouse_tpu_torch.crypto.bls.backends import fake

    calls, real = [], fake.verify_signature_sets

    def spy(sets, *a, **kw):
        calls.append(len(sets))
        return real(sets, *a, **kw)

    monkeypatch.setattr(fake, "verify_signature_sets", spy)
    return calls


def test_chain_phase_block_with_its_state_root_imports(minimal_import, backend,
                                                       monkeypatch):
    """Through process_gossip_block on the fake backend: the proposal
    alone, then the block's other sets; the head moves to the block and
    its state is produce_block's post-state."""
    C, genesis, preset, spec, segment, posts, _ = minimal_import
    backend("fake")
    calls = _fake_calls(monkeypatch, C)
    chain = _chain_on(C, genesis, preset, spec)
    chain.slot_clock.set_slot(1)
    root = C.bv.process_gossip_block(chain, segment[0])
    n_sets = len(segment[0].message.body.attestations) + 3
    assert calls == [1, n_sets - 1]
    assert chain.head_root == root == segment[0].message.tree_hash_root()
    assert C.ssz.cached_root(chain.head_state) == C.ssz.cached_root(posts[0])
    assert chain.pubkey_cache._device == "cpu"


def test_chain_phase_segment_links_in_one_call(minimal_import, backend, monkeypatch):
    """signature_verify_chain_segment over the 4 blocks makes one backend
    call of every block's sets; importing them moves the head to the last,
    as on a twin chain that imports them without signature checks."""
    C, genesis, preset, spec, segment, posts, _ = minimal_import
    backend("fake")
    calls = _fake_calls(monkeypatch, C)
    chain = _chain_on(C, genesis, preset, spec)
    chain.slot_clock.set_slot(4)
    verified = C.bv.signature_verify_chain_segment(chain, segment)
    assert calls == [sum(len(b.message.body.attestations) + 3 for b in segment)]
    roots = [v.import_into(chain) for v in verified]
    assert len(calls) == 1 and chain.head_root == roots[-1]
    assert [b.message.parent_root for b in segment[1:]] == roots[:-1]
    twin = _chain_on(C, genesis, preset, spec)
    for b in segment:
        twin.slot_clock.set_slot(b.message.slot)
        twin.process_block(b, strategy=C.per_block.BlockSignatureStrategy.NO_VERIFICATION)
    assert CS.chain_view(C, twin) == CS.chain_view(C, chain)


def test_twin_in_its_worker_holds_the_chain_to_its_view(minimal_import, monkeypatch):
    """A Twin in its own worker process (`twin_worker`) gets the genesis
    and the blocks as SSZ, imports them with NO_VERIFICATION and gives
    back its view after each: the chain that imported the same blocks
    here is held equal to it at its head. (The worker imports the script
    by its name, as it imports the script's own `__main__` in a run.)"""
    import sys

    monkeypatch.setitem(sys.modules, "chip_smoke", CS)
    C, genesis, preset, spec, segment = minimal_import[:5]
    chain = _chain_on(C, genesis, preset, spec)
    for b in segment:
        chain.slot_clock.set_slot(b.message.slot)
        chain.process_block(b, strategy=C.per_block.BlockSignatureStrategy.NO_VERIFICATION)
    with CS.twin_worker() as worker:
        twin = CS.Twin(_ssz(genesis), preset, spec, worker=worker)
        twin.import_(segment[:2])
        twin.import_(segment)  # the first two are not given again
        twin.expect("t", chain, C)
        twin.check()
        twin.close()
    assert [b.message.tree_hash_root() for b in twin.imported] == [
        b.message.tree_hash_root() for b in segment]
    assert set(twin.views) == set(b.message.tree_hash_root() for b in segment)
    assert twin.seconds > 0


def test_adversary_host_paths_survive_the_trip_to_a_worker():
    """The adversary phase runs the host-only paths of each batch on the
    host pool: a batch pickled as the pool sends it gets the verdicts the
    same paths give it here, and the card's paths and the host's make up
    the matrix's paths but the mesh."""
    import pickle

    from lighthouse_tpu_torch.crypto.bls import adversary as A

    assert CS.ADVERSARY_PATHS == tuple(p for p in A.PATHS if p != "mesh_grouped")
    assert set(CS.HOST_PATHS) < set(CS.ADVERSARY_PATHS)
    probe = A.BATCHES["weight-collision"](0)[0]
    got = CS._host_paths(pickle.loads(pickle.dumps(probe)), 11, CS.HOST_PATHS)
    assert got == {p: A.run_path(p, probe, seed=11) for p in CS.HOST_PATHS}
    assert got == {"cpu": False, "fallback": False}


def test_chain_phase_forged_segment_rejected_on_the_cpu_oracle(minimal_import, backend):
    """The segment with the forged attestation fails its one batch on the
    cpu backend, with the head unchanged."""
    C, genesis, preset, spec, _, _, forged = minimal_import
    backend("cpu")
    chain = _chain_on(C, genesis, preset, spec)
    chain.slot_clock.set_slot(2)
    head = chain.head_root
    with pytest.raises(C.beacon_chain.BlockError, match="segment signature batch failed"):
        C.bv.signature_verify_chain_segment(chain, forged)
    assert chain.head_root == head


# --- the same on the card (`gpu`) ------------------------------------------------


def _card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card: python3 chip_smoke.py "
                    "--phases build,block,attestations")
    return torch


@pytest.fixture
def card_chain(minimal_chain):
    """minimal_chain with its pubkey cache's table on the card and the
    torch_cuda backend selected (restored after)."""
    torch = _card()
    C, state, preset, spec, secret_of, _, block = minimal_chain
    saved = (C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE)
    C.api.set_backend("torch_cuda")
    cache = C.pubkey_cache.ValidatorPubkeyCache(state)
    assert cache.device_table().device.type == "cuda"
    yield torch, C, state, preset, spec, secret_of, cache, block
    C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE = saved


@pytest.mark.gpu
def test_block_verdicts_on_the_card_equal_the_cpu_oracle(card_chain):
    """Honest True and forged False on the card through the chain's
    wiring, as the cpu oracle says; the table-gathered pk equals the
    host-packed one."""
    torch, C, state, preset, spec, secret_of, cache, block = card_chain
    from lighthouse_tpu_torch.crypto.bls.backends import cpu as CPU
    from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as B

    forged = CS.forge_attestation(C, state, preset, spec, secret_of, block, 7,
                                    CS.HostCrypto())
    for signed, want in ((block, True), (forged, False)):
        v = C.bsv.BlockSignatureVerifier(state, preset, spec,
                                         get_pubkey=cache.getter(state),
                                         resolve_pubkey=cache.resolve)
        v.include_all_signatures(signed)
        assert B._common_table(v.sets) is cache
        assert v.verify(slot=7) is want
        assert CPU.verify_signature_sets(v.sets, seed=31) is want
        gathered = B._marshal_batch(v.sets, "cuda", seed=3).pk
        packed = B._marshal_batch(CS.untagged(C, v.sets), "cuda", seed=3).pk
        assert gathered.device.type == "cuda" and torch.equal(gathered, packed)


@pytest.mark.gpu
def test_forged_gossip_item_isolated_on_the_card(card_chain):
    torch, C, state, preset, spec, secret_of, cache, _ = card_chain
    host = CS.HostCrypto()
    chain = CS.gossip_chain(C, state, preset, spec, cache, 7)
    un = CS.gossip_unaggregated(C, state, preset, spec, secret_of, 6, 8, host)
    bad = CS.forge_gossip(C, state, preset, spec, secret_of, un, (5,), host)
    calls0 = C.metrics.BLS_BISECTION_CALLS.value
    res, _ = CS.process_gossip(C, chain, bad)
    assert C.metrics.BLS_BISECTION_CALLS.value - calls0 <= CS.bisection_bound(1, 8)
    got, rejected = CS.verdicts(bad, res["unaggregated"])
    assert rejected == {bad[5].tree_hash_root(): "invalid signature"}
    assert got == {a.tree_hash_root() for i, a in enumerate(un) if i != 5}


@pytest.mark.gpu
def test_chain_verdicts_on_the_card(minimal_import, backend):
    """The gossip block and the segment import through torch_cuda on the
    card (the chain's pubkey table there); the forged segment is
    rejected."""
    _card()
    C, genesis, preset, spec, segment, _, forged = minimal_import
    backend("torch_cuda")
    chain = _chain_on(C, genesis, preset, spec, device=None)
    assert chain.pubkey_cache.device_table().device.type == "cuda"
    chain.slot_clock.set_slot(4)
    with pytest.raises(C.beacon_chain.BlockError, match="segment signature batch failed"):
        C.bv.signature_verify_chain_segment(chain, forged)
    assert C.bv.process_gossip_block(chain, segment[0]) == chain.head_root
    verified = C.bv.signature_verify_chain_segment(chain, segment[1:])
    roots = [v.import_into(chain) for v in verified]
    assert chain.head_root == roots[-1] == segment[-1].message.tree_hash_root()


# --- the sync and pool phases' host side, at MINIMAL -----------------------------


def test_sync_and_pool_phases_run_last_on_the_chain():
    """They go on from the chain phase's chain: asked for without it, the
    script stops before it touches a card."""
    assert CS.ALL_PHASES[-8:-6] == ("sync", "pool")
    assert "sync " in CS.__doc__ and "pool " in CS.__doc__
    with pytest.raises(SystemExit, match="chain"):
        CS.main(["--phases", "build,sync"])
    assert [len(b) for b in CS.SYNC_FORGED_MESSAGES] == [1]
    assert [len(b) for b in CS.SYNC_FORGED_CONTRIBUTIONS] == [1]
    assert max(max(b) for b in CS.SYNC_FORGED_CONTRIBUTIONS) < 4 * CS.SYNC_AGGREGATORS
    assert (CS.POOL_BATCH, CS.POOL_AGGREGATES) == (64, 32)
    assert len(CS.SPECULATE_FAMILIES) == 10


@pytest.fixture(scope="module")
def minimal_head(minimal_import):
    """A chain on the MINIMAL genesis with the 4-block segment imported
    (head at slot 4, no signature checks), its twin's registry namespace,
    and the slot-4 sync messages over the head."""
    C, genesis, preset, spec, segment, posts, _ = minimal_import
    chain = _chain_on(C, genesis, preset, spec)
    for b in segment:
        chain.slot_clock.set_slot(b.message.slot)
        chain.process_block(b, strategy=C.per_block.BlockSignatureStrategy.NO_VERIFICATION)
    from types import SimpleNamespace

    T = C.types

    def secret_of(i):
        return T.interop_secret_key(i % 16).scalar

    host = CS.HostCrypto()
    twin = CS.Twin(_ssz(genesis), preset, spec)
    twin.import_(segment)
    reg = SimpleNamespace(chain=chain, genesis=genesis, preset=preset, spec=spec,
                          twin=twin)
    msgs = CS.sync_messages(C, chain.head_state, preset, spec, secret_of, 4,
                            chain.head_root, host)
    return C, reg, secret_of, host, msgs


def test_sync_phase_items_through_the_processor_fill_the_pools(minimal_head, backend):
    """One sender a committee position; the messages through the
    processor (one call) fill the message pool, whose contributions (4 a
    subnet) through the processor (one call of 3 sets each) fill the
    contribution pool; its full sync aggregate rides the next block,
    which the chain imports as the twin does; a forged contribution
    changes only its own signature."""
    C, reg, secret_of, host, msgs = minimal_head
    chain, preset, spec = reg.chain, reg.preset, reg.spec
    backend("fake")
    state, head = chain.head_state, chain.head_root
    members = CS.sync_committee_members(C, state, preset)
    pairs = {(v, p // preset.sync_subcommittee_size) for p, v in enumerate(members)}
    assert len(msgs) == 32 and {m.validator_index for m, _ in msgs} == set(members)
    assert len({m.beacon_block_root for m, _ in msgs}) == 1
    pools = CS.sync_pools(C, preset)
    chain.slot_clock.set_slot(4)
    monitor = C.monitor.ValidatorMonitor(auto_register=True)
    chain.validator_monitor = monitor
    try:
        res, bp = CS.process_sync(C, chain, pools, messages=msgs)
    finally:
        chain.validator_monitor = None
    verified, rejected = res["messages"]
    assert len(verified) == len(pairs) and len(rejected) == 32 - len(pairs)
    assert sum(v.sync_signatures for v in monitor.validators.values()) == len(verified)
    contribs = CS.sync_contributions(C, state, preset, spec, secret_of, 4, head,
                                     pools.messages, host)
    assert len(contribs) == 4 * CS.SYNC_AGGREGATORS
    forged = CS.forge_contributions(C, state, preset, secret_of, contribs, (5,), host)
    assert [i for i, (a, b) in enumerate(zip(contribs, forged))
            if a.as_ssz_bytes() != b.as_ssz_bytes()] == [5]
    res, _ = CS.process_sync(C, chain, pools, contributions=contribs)
    assert len(res["contributions"][0]) == len(contribs)
    agg = pools.contributions.get_sync_aggregate(C.types.types_for(preset), 4, head)
    assert all(agg.sync_committee_bits)
    pre = C.per_slot.process_slots(C.per_slot.clone_state(state), 5, preset, spec)
    block, _ = CS.produce_block(C, pre, preset, spec, secret_of, host, sync_aggregate=agg)
    chain.slot_clock.set_slot(5)
    assert chain.process_block(block) == block.message.tree_hash_root()
    reg.twin.import_([block])
    reg.twin.expect("sync", chain, C)
    reg.twin.check()
    assert len(reg.twin.imported) == 5 and block.message.tree_hash_root() in reg.twin.views


def test_sync_phase_light_client_update_verifies_on_the_cpu_oracle(minimal_head, backend):
    """The store bootstrapped at the genesis block follows the optimistic
    update whose aggregate the committee signed over the head (the
    phase's construction, its parse cache seeded with untagged keys as
    the phase seeds it), on the cpu oracle; with one member's
    signature over a wrong root it is rejected."""
    C, reg, secret_of, host, _ = minimal_head
    backend("cpu")
    L, T, preset = C.light, C.types, reg.preset
    chain = _chain_on(C, reg.genesis, preset, reg.spec)
    state, head = chain.head_state, chain.head_root  # the genesis block
    members = CS.sync_committee_members(C, state, preset)
    domain = T.get_domain(state, T.DOMAIN_SYNC_COMMITTEE, 0, preset)
    signing = T.SigningData(object_root=head, domain=domain).tree_hash_root()
    sig, rest, bad = host.sign([([secret_of(v) for v in members], signing),
                                ([secret_of(v) for v in members[1:]], signing),
                                ([secret_of(members[0])], CS.wrong_root(signing))])
    t = T.types_for(preset)
    agg = t.SyncAggregate(sync_committee_bits=(True,) * len(members),
                          sync_committee_signature=sig)
    boot = L.light_client_bootstrap(reg.genesis, preset)
    store = L.LightClientStore(chain.genesis_block_root, boot, preset, reg.spec,
                               bytes(state.genesis_validators_root))
    CS.seed_light_client(C, store, boot.current_sync_committee, chain.pubkey_cache)
    parsed = store._parsed_committees[boot.current_sync_committee.tree_hash_root()]
    assert all(getattr(k, "table", None) is None and k.subgroup_ok() for k in parsed)
    assert [k.to_bytes() for k in parsed] == [
        bytes(pk) for pk in boot.current_sync_committee.pubkeys]
    update = L.light_client_optimistic_update(state, agg, 1, preset)
    assert update.attested_header.tree_hash_root() == head
    store.process_optimistic_update(update)
    assert store.current_max_active_participants == len(members)
    forged = type(update).from_ssz_bytes(update.as_ssz_bytes())
    forged.sync_aggregate.sync_committee_signature = C.api.AggregateSignature.aggregate(
        [C.api.Signature.from_bytes(rest), C.api.Signature.from_bytes(bad)]).to_bytes()
    with pytest.raises(L.LightClientError, match="signature invalid"):
        store.process_optimistic_update(forged)


def test_pool_phase_confirmable_aggregates_confirm_by_lookup(minimal_head, backend,
                                                             monkeypatch):
    """attach_speculation over the chain; the idle pass pre-verifies the
    next slot's committees; the phase's speculated aggregates for that
    slot then reach the backend as 2 sets each (the indexed set confirmed
    by lookup); the unaggregated attestations of the head's slot, in
    processor batches, fill the naive pool with full aggregates."""
    C, reg, secret_of, host, _ = minimal_head
    chain, preset, spec = reg.chain, reg.preset, reg.spec
    backend("fake")
    calls = _fake_calls(monkeypatch, C)
    slot = int(chain.head_state.slot)
    chain.slot_clock.set_slot(slot)

    def source(data, members, root):
        return host.sign([([secret_of(v) for v in members], root)])[0]

    idle = C.processor.BeaconProcessor(handlers={})
    sub = C.speculate.attach_speculation(chain, idle, signature_source=source)
    try:
        idle.run_until_idle()
        assert sub.verifier.stats["preverified"] == 2 and calls == [1, 1]
        chain.slot_clock.set_slot(slot + 1)
        aggs = CS.speculated_aggregates(C, chain, chain.head_state, preset, spec,
                                        secret_of, slot + 1, host, source)
        del calls[:]
        res, _ = CS.process_gossip(C, chain, aggregates=aggs)
        assert calls == [2 * len(aggs)] and sub.verifier.stats["confirms"] == len(aggs)
        assert len(res["aggregate"][0]) == len(aggs)
    finally:
        sub.detach()
    naive = C.pool.NaiveAggregationPool()
    ahead = C.per_slot.process_slots(C.per_slot.clone_state(chain.head_state), slot + 1,
                                     preset, spec)
    unagg = CS.gossip_unaggregated(C, ahead, preset, spec, secret_of, slot, 8, host)
    chain.slot_clock.set_slot(slot)
    del calls[:]
    res, _ = CS.process_gossip(C, chain, unagg, max_batch=4, sink=lambda name, vs: [
        naive.insert(v.attestation) for v in vs])
    assert calls == [4, 4] and len(res["unaggregated"][0]) == 8
    t = C.types.types_for(preset)
    assert all(all(naive.get_aggregate(t, a.data).aggregation_bits) for a in unagg)



# --- the genesis and finality phases' host side, at MINIMAL ---------------------


def test_genesis_and_finality_phases_run_last():
    """After the pool phase and before merge, each over its own MINIMAL
    chain; every call kind they add runs the pairs expected_launches is
    held to."""
    assert CS.ALL_PHASES[-6:-4] == ("genesis", "finality")
    assert "genesis " in CS.__doc__ and "finality " in CS.__doc__
    assert CS.GENESIS_DEPOSITS == 64 and 0 < CS.GENESIS_FORGED_AT < CS.GENESIS_SMALL
    assert CS.GENESIS_SMALL < CS.GENESIS_DEPOSITS
    assert CS.EF_KINDS == ("verify", "fast_aggregate_verify", "aggregate_verify",
                           "batch_verify")
    assert CS.FINALITY_VALIDATORS == 64 and CS.FINALITY_MAX_EPOCHS == 5


@pytest.mark.parametrize("kind, keys, pairs", [("aggregate", 3, 5), ("aggregate", 64, 65),
                                               ("sets", 1, 5), ("sets", 3, 5)])
def test_backend_calls_record_every_call_kind_with_its_pairs(monkeypatch, kind, keys,
                                                              pairs):
    """A deposit, a verify or a batch reaches torch_cuda's dispatch (its
    pairs off the Miller-pairs counter: n_b + 1); an aggregate_verify its
    own entry (the keys' bucket + 1): both are recorded, and a verify of
    those pairs launches what expected_launches says."""
    from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as B
    from lighthouse_tpu_torch.utils import metrics as M

    def dispatch(sets, *a, **kw):
        M.BLS_MILLER_PAIRS.inc(B._bucket(len(sets)) + 1)
        return True

    monkeypatch.setattr(B, "dispatch_verify_signature_sets", dispatch)
    monkeypatch.setattr(B, "aggregate_verify", lambda sig, pks, msgs, **kw: False)
    with CS.backend_calls(B, M) as calls:
        if kind == "aggregate":
            B.aggregate_verify("sig", ["pk"] * keys, [b"m"] * keys)
        else:
            B.dispatch_verify_signature_sets(["set"] * keys)
    assert B.aggregate_verify is not None and len(calls) == 1
    (c,) = calls
    assert c["pairs"] == pairs and (("agg" in c) is (kind == "aggregate"))
    assert CS.expected_launches(TP, pairs)["fp12_mul"] == 35 + (pairs - 1).bit_length()


def test_host_oracle_jobs_run_once_for_equal_batches():
    calls = []

    def job(*args):
        calls.append(args)
        return len(calls)

    host = CS.HostCrypto()
    assert host._submit(job, [1], b"m")() == 1
    assert host._submit(job, [1], b"m")() == 1
    assert host._submit(job, [2], b"m")() == 2 and len(calls) == 2


@pytest.fixture(scope="module")
def genesis_parts():
    C = CS.consensus_modules()
    spec = C.types.ChainSpec.minimal()
    datas = CS.genesis_deposit_data(C, spec, 4, CS.HostCrypto(), forged=(2,))
    return C, spec, datas


def test_genesis_phase_deposits_and_their_tree(genesis_parts):
    """Interop deposits at a full stake, each signed over the deposit
    domain but the forged one; each deposit's branch proves it against
    the root of the deposits up to it, as genesis replays them."""
    C, spec, datas = genesis_parts
    from lighthouse_tpu_torch.crypto.bls.backends import cpu

    tree, deposits = CS.deposit_list(C, datas)
    assert tree.root() == tree.root(4) and len(deposits) == 4
    for i, d in enumerate(deposits):
        assert C.per_block._verify_merkle_branch(
            d.data.tree_hash_root(), d.proof,
            C.types.MINIMAL.deposit_contract_tree_depth + 1, i, tree.root(i + 1))
        s = C.signature_sets.deposit_signature_set(d.data, spec)
        assert cpu.verify_signature_sets([s], seed=1) is (i != 2)
        assert d.data.amount == spec.max_effective_balance
    blocks = CS.genesis_eth1_blocks(spec, CS.ETH1_BLOCK_HASH, 64)
    qualifying = [b for b in blocks if b[1] + spec.genesis_delay >= spec.min_genesis_time
                  and b[2] >= spec.min_genesis_active_validator_count]
    assert qualifying[0] == (CS.ETH1_BLOCK_HASH, spec.min_genesis_time, 64)
    service = CS.genesis_service(tree, datas, blocks)
    assert service.block_cache[2].hash == CS.ETH1_BLOCK_HASH


def test_ef_tree_bls_cases_pass_the_ports_walker_on_the_cpu_oracle(genesis_parts,
                                                                    tmp_path):
    """Every kind of the official BLS suite for the four handlers, each
    case's expected output what the cpu oracle gives through the port's
    walker; the tree in the official layout."""
    C = genesis_parts[0]
    saved = (C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE)
    C.api.set_backend("cpu")
    try:
        cases = CS.write_ef_tree(C, str(tmp_path), CS.HostCrypto())
        results = C.ef_tests.run_tree(str(tmp_path))
    finally:
        C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE = saved
    kinds = {h: sorted(Path(d).name[len(h) + 1:] for d in cases
                       if Path(d).parts[-3] == h) for h in CS.EF_KINDS}
    assert kinds == {
        "verify": ["infinity_pubkey_and_infinity_signature", "tampered_signature",
                   "valid", "wrong_pubkey"],
        "fast_aggregate_verify": ["extra_pubkey", "infinity_pubkey",
                                  "na_pubkeys_and_infinity_signature",
                                  "na_pubkeys_and_zero_signature", "tampered_signature",
                                  "valid"],
        "aggregate_verify": ["infinity_pubkey", "na_pubkeys_and_infinity_signature",
                             "na_pubkeys_and_zero_signature", "tampered_signature",
                             "valid"],
        "batch_verify": ["invalid_set", "tampered_signature", "valid"]}
    assert len(results) == len(cases) == 18 and all(r.ok for r in results), [
        r for r in results if not r.ok]


def test_finality_phase_harness_over_a_native_store(tmp_path):
    """The finality phase's harness on the CPU: its first 2 blocks signed
    and imported on `fake`, the forged block refused on the cpu oracle
    with FORGED_BLOCK_ERROR and the head kept; fsck clean; the reopened
    NativeStore resumes the chain at the same head."""
    C = CS.consensus_modules()
    T = C.types
    saved = (C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE)
    C.api.set_backend("fake")
    path = str(tmp_path / "chain.db")
    kv = C.native_kv.NativeStore(path)
    try:
        h = C.harness.BeaconChainHarness(CS.FINALITY_VALIDATORS, T.MINIMAL,
                                         T.ChainSpec.minimal(), sign=True, kv=kv,
                                         device="cpu")
        head = h.extend_chain(2)
        forged, parent = CS.forged_harness_block(C, h, 3)
        assert parent == head and len(forged.message.body.attestations) == 2
        C.api.set_backend("cpu")
        h.chain.slot_clock.set_slot(3)
        with pytest.raises(C.beacon_chain.BlockError, match=CS.FORGED_BLOCK_ERROR):
            h.chain.process_block(forged, strategy=h.strategy)
        assert h.chain.head_root == head
        assert C.fsck.run_fsck(h.chain.store) == []
        kv.close()
        kv = C.native_kv.NativeStore(path)
        resumed = C.beacon_chain.BeaconChain.from_store(
            C.hot_cold.HotColdDB(kv, T.MINIMAL, h.spec), T.MINIMAL, h.spec, device="cpu")
        assert resumed.head_root == head
        assert resumed.finalized_checkpoint == h.chain.finalized_checkpoint
    finally:
        kv.close()
        C.api._BACKEND, C.api._BACKEND_NAME, C.api._DEVICE = saved


def test_merge_phase_runs_last_on_the_registry():
    """Last but for the network and http phases; it goes on from the registry (built
    when merge is asked for),
    and its MAINNET chain takes the registry's genesis unchanged: the
    genesis root is the same with bellatrix at epoch 1 and the mock
    engine's terminal block hash in the spec."""
    from lighthouse_tpu_torch import execution_layer as X
    from lighthouse_tpu_torch import types as T
    from lighthouse_tpu_torch.ssz import cached_root

    assert CS.ALL_PHASES[-4] == "merge" and "merge " in CS.__doc__
    assert CS.MERGE_BLOCKS == 3 and CS.MERGE_VALIDATORS == 64
    C = CS.consensus_modules()
    engine = X.MockExecutionEngine(T.types_for(T.MINIMAL))
    spec = CS.merge_spec(C, engine)
    assert (spec.altair_fork_epoch, spec.bellatrix_fork_epoch) == (0, 1)
    assert spec.terminal_block_hash == engine.genesis_hash
    assert X.ExecutionLayer(engine).validate_merge_block(engine.genesis_hash, spec) is True
    base = T.ChainSpec.interop(altair_fork_epoch=0)
    assert cached_root(T.interop_genesis_state(16, T.MINIMAL, spec)) == cached_root(
        T.interop_genesis_state(16, T.MINIMAL, base))


def test_engine_rig_times_every_notify_and_stops():
    """The merge phase's engine rig: a mock engine behind JWT HTTP, every
    notify_new_payload's (hash, status, ms) recorded; the server is
    stopped with the phase's ExitStack."""
    import contextlib
    import urllib.request

    from lighthouse_tpu_torch import types as T

    C = CS.consensus_modules()
    t = T.types_for(T.MINIMAL)
    with contextlib.ExitStack() as stack:
        engine, server, el = CS.engine_rig(C, t, stack)
        p = el.get_payload(engine.genesis_hash, 12, b"\x03" * 32)
        assert el.notify_new_payload(p) is C.execution_layer.PayloadVerificationStatus.VERIFIED
        assert [h for h, _, _ in el.notified] == [bytes(p.block_hash)]
        assert CS.notified_since(C, el, 0, C.execution_layer.PayloadVerificationStatus.VERIFIED,
                                 "t")[0] >= 0
        engine.force_syncing = 1
        el.notify_new_payload(p)
        with pytest.raises(CS.Fail, match="want verified"):
            CS.notified_since(C, el, 1, C.execution_layer.PayloadVerificationStatus.VERIFIED,
                              "t")
        url = server.url
    with pytest.raises(OSError):
        urllib.request.urlopen(url, data=b"{}", timeout=1.0)



# --- the network phase's host side, at MINIMAL ----------------------------------


def test_network_phase_runs_last_on_the_registry():
    """Last but for the http phase, over the registry the block, chain and
    merge phases share; its wire part takes the finality phase's chain when
    that phase ran."""
    assert CS.ALL_PHASES[-3] == "network" and "network " in CS.__doc__
    assert "network" in CS.REGISTRY_PHASES and "merge" in CS.REGISTRY_PHASES
    assert CS.ALL_PHASES.index("finality") < CS.ALL_PHASES.index("network")
    assert CS.NETWORK_ATTESTATIONS == 64 and CS.CHAIN_SEGMENT == 4
    assert CS.WIRE_BLOCKS >= 2


@pytest.mark.parametrize("table, backend_name, fails", [
    ("cuda", "torch_cuda", None),
    ("cpu", "torch_cuda", "network: a: the chain's pubkey table is on cpu"),
    ("cuda", "fake", "the backend is fake, not torch_cuda"),
])
def test_network_nodes_need_their_tables_on_the_card_and_torch_cuda(
        minimal_import, backend, monkeypatch, table, backend_name, fails):
    from types import SimpleNamespace

    C, genesis, preset, spec = minimal_import[:4]
    node = C.network.NetworkNode("a", _chain_on(C, genesis, preset, spec),
                                 C.network.MessageBus())
    if table == "cuda":
        monkeypatch.setattr(node.chain.pubkey_cache, "device_table",
                            lambda: SimpleNamespace(device=SimpleNamespace(type="cuda")))
    backend(backend_name, device="cpu") if backend_name == "torch_cuda" else backend(
        backend_name)
    if fails is None:
        CS.nodes_on_card(C, "network", [node])
    else:
        with pytest.raises(CS.Fail, match=fails):
            CS.nodes_on_card(C, "network", [node])


def test_network_calls_are_held_to_the_cpu_oracle(monkeypatch):
    """A step's backend call whose verdict differs from the cpu oracle's
    fails the phase at check_oracle."""
    from types import SimpleNamespace

    from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as B
    from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K

    C = CS.consensus_modules()
    monkeypatch.setattr(B, "dispatch_verify_signature_sets", lambda sets, *a, **k: True)

    class Host:
        def oracle(self, batches, seed):
            return lambda: [False for _ in batches]

    calls = CS.Calls(None, K, None, B, C, Host(), {}, "card")
    sets = [SimpleNamespace(pubkeys=[1])]
    _, step_calls = calls.step("network: x", lambda: B.dispatch_verify_signature_sets(sets),
                               [1])
    assert calls.rows["network: x"]["verdicts"] == [True]
    with pytest.raises(CS.Fail, match="network: x: card True, cpu oracle False"):
        calls.check_oracle("network")


def test_network_heads_are_held_to_the_twin(minimal_import):
    """Nodes whose chains imported the blocks pass; a node one block ahead
    fails the phase."""
    C, genesis, preset, spec, segment = minimal_import[:5]
    bus = C.network.MessageBus()
    NOV = C.per_block.BlockSignatureStrategy.NO_VERIFICATION
    nodes = []
    for name, blocks in (("a", segment[:2]), ("b", segment[:2]), ("c", segment[:3])):
        chain = _chain_on(C, genesis, preset, spec)
        for blk in blocks:
            chain.slot_clock.set_slot(blk.message.slot)
            chain.process_block(blk, strategy=NOV)
        nodes.append(C.network.NetworkNode(name, chain, bus))
    assert CS.network_twin(C, genesis, preset, spec, segment[:2], nodes[:2], "t") >= 0
    with pytest.raises(CS.Fail, match="the heads or checkpoints of \\['c'\\] differ"):
        CS.network_twin(C, genesis, preset, spec, segment[:2], nodes, "t")
    # the registry twin keeps its view after each block: the MAINNET part's
    # nodes are held to it at their heads, and fail where it has no block
    twin = CS.Twin(_ssz(genesis), preset, spec)
    twin.import_(segment[:3])
    for n in nodes:
        twin.expect(f"t: {n.peer_id}", n.chain, C)
    twin.check()
    assert twin.views[segment[1].message.tree_hash_root()] != CS.chain_view(C, nodes[2].chain)
    short = CS.Twin(_ssz(genesis), preset, spec)
    short.import_(segment[:2])
    short.expect("t: c", nodes[2].chain, C)
    with pytest.raises(CS.Fail, match="t: c: the twin imported no block"):
        short.check()


def test_network_double_vote_is_refused_by_the_honest_store(minimal_import):
    """The double vote the phase gossips: the honest ValidatorStore signs
    the first vote (the same bytes as the host's) and refuses the second
    with NotSafe; the byzantine store signs it and audits its override;
    the conflicting aggregate carries the voter's bit alone, a slashable
    pair with the honest vote, by an aggregator of the committee."""
    C, genesis, preset, spec, segment, posts = minimal_import[:6]
    host = CS.HostCrypto()
    state = C.per_slot.process_slots(C.per_slot.clone_state(posts[0]), 2, preset, spec)
    secret_of = (lambda i: C.types.interop_secret_key(i % 16).scalar)
    honest = CS.gossip_unaggregated(C, state, preset, spec, secret_of, 1, 1, host)[0]
    committee = C.context.ConsensusContext(preset, spec).committee_cache(
        state, 0).get_beacon_committee(1, 0)
    signed, voter, refused, byz = CS.double_vote(C, state, preset, spec, secret_of,
                                                 committee, honest, host)
    assert voter == committee[0] and "double vote" in refused
    assert [k for k, _, _ in byz.overrides] == ["attestation"]
    agg = signed.message.aggregate
    assert agg.aggregation_bits == honest.aggregation_bits
    assert signed.message.aggregator_index in committee
    assert C.per_block.is_slashable_attestation_data(honest.data, agg.data)
    assert bytes(agg.data.beacon_block_root) == C.helpers.get_block_root_at_slot(
        state, 0, preset)


def test_timed_attrs_label_and_restore():
    import types

    sink = []
    mod = types.ModuleType("pkg.mod")
    mod.f = lambda x: x + 1

    class Obj:
        def g(self, x):
            return x * 2

    obj = Obj()
    f0 = mod.f
    with CS.timed_attrs(sink, (mod, "f"), (obj, "g")):
        assert mod.f(1) == 2 and obj.g(3) == 6
    assert mod.f is f0 and "g" not in vars(obj)
    assert [label for label, _ in sink] == ["mod.f", "Obj.g"]
    assert CS.timed_ms(sink + [("mod.f", 0.5)])["mod.f"][0] == 2


# --- the http phase's host side, at MINIMAL -------------------------------------


def test_http_phase_runs_last_on_the_registry():
    """The last phase over the registry (block 31 and its bucket from the
    block phase; only the scenario phase, which needs no registry, follows
    it); its MINIMAL validator client stays at 16 distinct keys."""
    assert CS.ALL_PHASES[-2] == "http" and "http " in CS.__doc__
    assert "http" in CS.REGISTRY_PHASES
    assert CS.ALL_PHASES.index("network") < CS.ALL_PHASES.index("http")
    assert CS.VC_VALIDATORS == 16 and CS.HTTP_SYNC_MESSAGES >= 1
    assert len(CS.SERVING_FAMILIES) == 12
    from lighthouse_tpu_torch.utils import metrics as M

    assert all(hasattr(M, name) for name in CS.SERVING_FAMILIES)


@pytest.mark.parametrize("table, backend_name, fails", [
    ("cuda", "torch_cuda", None),
    ("cpu", "torch_cuda", "http: the chain's pubkey table is on cpu"),
    ("cuda", "fake", "the backend is fake, not torch_cuda"),
])
def test_http_chain_needs_its_table_on_the_card_and_torch_cuda(
        minimal_import, backend, monkeypatch, table, backend_name, fails):
    from types import SimpleNamespace

    C, genesis, preset, spec = minimal_import[:4]
    chain = _chain_on(C, genesis, preset, spec)
    if table == "cuda":
        monkeypatch.setattr(chain.pubkey_cache, "device_table",
                            lambda: SimpleNamespace(device=SimpleNamespace(type="cuda")))
    backend(backend_name, device="cpu") if backend_name == "torch_cuda" else backend(
        backend_name)
    if fails is None:
        CS.chain_on_card(C, "http", chain)
    else:
        with pytest.raises(CS.Fail, match=fails):
            CS.chain_on_card(C, "http", chain)


def test_http_helpers_over_a_server(minimal_import, backend):
    """http_request returns error statuses; the SSE subscriber attaches
    before the constructor returns and reads the block and head events of
    two imports; closed_port gives a refused connection."""
    import urllib.error
    import urllib.request

    C, genesis, preset, spec, blocks = minimal_import[:5]
    backend("fake")
    chain = _chain_on(C, genesis, preset, spec)
    server = C.http_api.BeaconApiServer(C.http_api.BeaconApi(
        C.vc.InProcessBeaconNode(chain)))
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        status, headers, body, ms = CS.http_request(base + "/eth/v1/no/route")
        assert status == 404 and b"no route" in body and ms > 0
        sub = CS.SseSubscriber(base, "block,head", 4, server.serving.broadcaster)
        for b in blocks[:2]:
            chain.slot_clock.set_slot(b.message.slot)
            chain.process_block(b)
        events = sub.join()
        assert sorted(k for k, _, _ in events) == ["block", "block", "head", "head"]
        roots = {p["block"] for _, p, _ in events}
        assert roots == {"0x" + b.message.tree_hash_root().hex() for b in blocks[:2]}
        status, headers, _, _ = CS.http_request(base + "/eth/v1/beacon/genesis")
        assert status == 200 and headers["X-Cache"] == "miss"
    finally:
        server.stop()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{CS.closed_port()}/", timeout=5)


# --- the scenario phase's host side ----------------------------------------------


def test_scenario_phase_runs_last_without_the_registry():
    """Last, needing no registry: tests/test_scenarios.py's small partition
    plan, the corpus in the checkout, and the pairing probe families of
    aggregation_soundness_plan, each a family the adversary batches."""
    from lighthouse_tpu_torch.crypto.bls import adversary as A
    from lighthouse_tpu_torch.harness import scenario as S
    from lighthouse_tpu_torch.types import MINIMAL

    assert CS.ALL_PHASES[-1] == "scenario" and "scenario " in CS.__doc__
    assert "scenario" not in CS.REGISTRY_PHASES
    plan = CS.scenario_plan(S, MINIMAL)
    assert (plan.node_count, plan.validator_count, plan.seed) == (3, 48, 0)
    assert [p.slots for p in plan.phases] == [8, 8, 16] and plan.phases[2].heal
    assert plan.phases[1].partition == ((0,), (1, 2))
    assert len(glob.glob(os.path.join(CS.CORPUS_DIR, "*.json"))) >= 2
    probes = S.aggregation_soundness_plan().aggregation_probes
    assert set(CS.SCENARIO_PROBE_FAMILIES) == set(A.BATCHES) == set(probes) - {
        "speculation-poisoning"}


def test_prevalidated_pubkeys_feed_the_pubkey_cache(monkeypatch):
    """prevalidate_pubkeys checks each distinct key once through
    PublicKey.from_bytes and leaves it in the cache's memo, so a chain's
    pubkey cache built after it decompresses nothing; its keys are the
    ones the cache would have made, subgroup-checked."""
    from lighthouse_tpu_torch import types as T
    from lighthouse_tpu_torch.chain import pubkey_cache as PC

    C = CS.consensus_modules()
    spec = T.ChainSpec.interop()
    state, _ = CS.registry_state(C, T.MINIMAL, spec, 32, 8, CS.HostCrypto())
    PC._validated.cache_clear()
    seen = []
    real = C.api.PublicKey.from_bytes
    monkeypatch.setattr(C.api.PublicKey, "from_bytes", classmethod(
        lambda cls, data: seen.append(bytes(data)) or real(data)))
    assert CS.prevalidate_pubkeys(C, CS.HostCrypto(), state) == 8
    assert len(seen) == 8 and PC._validated.cache_info().currsize == 8
    cache = PC.ValidatorPubkeyCache(state, device="cpu")
    assert len(seen) == 8 and len(cache) == 32
    for i in range(32):
        key = cache.get(i)
        assert key.to_bytes() == bytes(state.validators[i].pubkey)
        assert key.point == real(bytes(state.validators[i].pubkey)).point
        assert key.subgroup_ok()
    PC._validated.cache_clear()

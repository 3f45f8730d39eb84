"""The port's continuous-batching scheduler (lighthouse_tpu_torch/crypto/
bls/scheduler.py) against the JAX package's: the same lane submissions
give the same launch_log, stats, per-entry verdicts, pipeline events,
"sched" ledger records, metric deltas and verdict-delay observations --
on the fake backends (a merge fallback included) and on the cpu oracles
(a merge fallback over real signatures); routing through
verify_signature_sets_async; and the warm capacities are the set buckets
the port's warm_compile captures.

No test here compiles an XLA program (`no_xla_compile`)."""

import os

import pytest

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import pipeline as JP
from lighthouse_tpu.crypto.bls import scheduler as JS
from lighthouse_tpu.obs import ledger as JL
from lighthouse_tpu.resilience.primitives import EventLog as JEventLog
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu.utils import tracing as JT
from lighthouse_tpu.utils.slot_clock import ManualSlotClock
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls import pipeline as TP
from lighthouse_tpu_torch.crypto.bls import scheduler as TS
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.obs import ledger as TL
from lighthouse_tpu_torch.resilience.primitives import EventLog as TEventLog
from lighthouse_tpu_torch.utils import metrics as TM
from lighthouse_tpu_torch.utils import tracing as TT
from torch_port_util import both, make_signed, no_xla_compile

PKG = {
    "jax": (japi, JP, JS, JM, JT, JL, JEventLog),
    "torch": (tapi, TP, TS, TM, TT, TL, TEventLog),
}

SCHED_COUNTERS = ("BLS_SCHED_MERGES", "BLS_SCHED_LAUNCHES",
                  "BLS_SCHED_MERGE_FALLBACKS", "BLS_SCHED_PAD_SETS",
                  "BLS_SCHED_REAL_SETS", "SPECULATE_PREEMPTIONS")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_CONT_BATCH", "1")
    # restored at teardown; _run sets it for both schedulers
    monkeypatch.setenv("LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS", "64")
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE,
             JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT)
    with no_xla_compile():
        yield
    for _, P, S, *_ in PKG.values():
        S.configure()
        P.configure()
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE,
     JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT) = saved


class _Set:
    """What the fake backends read of a set: its pubkeys."""

    def __init__(self, i, keys=1):
        self.message = b"m%d" % i
        self.pubkeys = list(range(keys))


def _run(pkg, backend, script, resolve, max_sets=64):
    """Submit `script` ([(lane, sets, seed, slot)]) to a fresh scheduler
    over a fresh depth-2 pipeline on `backend`, launching at `max_sets`
    queued real sets, then resolve the futures in `resolve` order and
    drain; the scheduler's observable record. Both schedulers read their
    threshold from LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS at each submit."""
    api, P, S, M, T, L, EventLog = PKG[pkg]
    api.set_backend(backend)
    T.configure()
    L.configure()
    events = EventLog()
    clock = ManualSlotClock(genesis_time=0, seconds_per_slot=12)
    clock.set_slot(5)
    os.environ["LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS"] = str(max_sets)
    sched = S.configure(pipeline=P.VerifyPipeline(depth=2, events=events),
                        slot_clock=clock)
    before = {n: getattr(M, n).value for n in SCHED_COUNTERS}
    delays = {lane: M.SCHEDULER_VERDICT_DELAY[lane].snapshot()
              for lane in S.LANES}
    futs, done_at_submit = [], []
    for lane, sets, seed, slot in script:
        futs.append(sched.submit(sets, lane=lane, seed=seed, slot=slot))
        done_at_submit.append([f.done() for f in futs])
    verdicts = {k: futs[k].result() for k in resolve}
    sched.drain()
    verdicts.update({k: f.result() for k, f in enumerate(futs)})
    records = [r.to_dict() for r in L.default_ledger().records()]
    for r in records:
        r.pop("trace_id"), r.pop("span_id")
    return dict(
        launch_log=list(sched.launch_log), stats=dict(sched.stats),
        verdicts=verdicts, done=done_at_submit, events=events.events,
        records=records,
        counters={n: getattr(M, n).value - before[n] for n in SCHED_COUNTERS},
        delays={lane: M.SCHEDULER_VERDICT_DELAY[lane].snapshot()[1]
                - delays[lane][1] for lane in S.LANES},
        depth=[M.BLS_SCHED_QUEUE_DEPTH.get(lane) for lane in S.LANES],
    )


FAKE_SCRIPT = [
    ("speculative", [_Set(0), _Set(1)], 1, 6),
    ("sync", [_Set(2)] * 4, 2, 5),
    ("block", [_Set(3)], 3, 5),
    ("aggregate", [_Set(4)] * 3, None, 4),  # 8 real sets: launches
    ("unaggregated", [_Set(5), _Set(6, keys=0)], 5, None),
    ("block", [_Set(7)] * 5, 6, 7),
    ("aggregate", [], 7, 7),  # empty: False, no launch
    ("aggregate", [_Set(8)], None, 6),
    ("speculative", [_Set(9)], 9, None),
]


def test_fake_backends_same_launches_stats_and_verdicts():
    """Admission in (lane, deadline, arrival) order, a threshold launch,
    speculation withheld while real work is queued and run at the idle
    boundary, a merged launch made False by one entry (an empty pubkey
    list) recovered per entry, and the empty submission: the same in
    both packages."""
    want = _run("jax", "fake", FAKE_SCRIPT, resolve=[0, 5], max_sets=8)
    got = _run("torch", "fake", FAKE_SCRIPT, resolve=[0, 5], max_sets=8)
    for key in want:
        assert got[key] == want[key], key
    assert want["stats"]["merge_fallbacks"] == 1
    assert want["stats"]["preemptions"] >= 1
    assert want["verdicts"][4] is False and want["verdicts"][6] is False
    assert all(want["verdicts"][k] for k in (0, 1, 2, 3, 5, 7, 8))
    assert want["launch_log"][0]["lanes"] == ("block", "aggregate", "sync")


@pytest.mark.parametrize("max_sets", ["1", "64"])
def test_fake_backends_same_padding_at_each_threshold(max_sets):
    """Every submission launching alone (threshold 1), or all merging at
    the first result() (64): the same pad sets per warm capacity."""
    max_sets = int(max_sets)
    script = [(lane, [_Set(i)] * n, i, i % 3)
              for i, (lane, n) in enumerate([("sync", 3), ("block", 5),
                                             ("aggregate", 17), ("block", 2)])]
    want = _run("jax", "fake", script, resolve=[3], max_sets=max_sets)
    got = _run("torch", "fake", script, resolve=[3], max_sets=max_sets)
    for key in want:
        assert got[key] == want[key], key


def test_cpu_oracles_merge_fallback_exact_per_entry_verdicts():
    """Real signatures on the cpu backends: a merged launch with one
    forged entry verifies False; each entry's own re-verify gives
    (True, False, True) in both packages, with the same records."""
    jsets, tsets = both(make_signed(3, 2),
                        [((0,), 0, None), ((1,), 0, 1), ((2,), 0, None)])
    lanes = ("aggregate", "unaggregated", "sync")
    runs = {}
    for pkg, sets in (("jax", jsets), ("torch", tsets)):
        script = [(lane, [s], 40 + i, 3) for i, (lane, s) in enumerate(zip(lanes, sets))]
        runs[pkg] = _run(pkg, "cpu", script, resolve=[1])
    for key in runs["jax"]:
        assert runs["torch"][key] == runs["jax"][key], key
    assert [runs["jax"]["verdicts"][k] for k in range(3)] == [True, False, True]
    assert runs["jax"]["stats"]["merge_fallbacks"] == 1
    assert runs["jax"]["stats"]["launches"] == 1


def test_lane_routing_is_flagged_and_lane_gated(monkeypatch):
    tapi.set_backend("fake")
    TS.configure()
    s = [_Set(1)]
    fut = tapi.verify_signature_sets_async(s, lane="aggregate", slot=1)
    assert isinstance(fut, TS.ScheduledVerify) and fut.result() is True
    assert isinstance(tapi.verify_signature_sets_async(s), TP.VerifyFuture)
    monkeypatch.setenv("LIGHTHOUSE_TPU_CONT_BATCH", "0")
    assert isinstance(tapi.verify_signature_sets_async(s, lane="aggregate"),
                      TP.VerifyFuture)
    with pytest.raises(ValueError, match="unknown scheduler lane"):
        TS.default_scheduler().submit(s, lane="gossip")


def test_entries_for_other_devices_wait_for_their_own_launch():
    """An entry merges only with entries for the same device; each launch
    hands the pipeline its entries' device."""
    seen = []

    class Backend:
        def dispatch_verify_signature_sets(self, sets, seed=None, device=None):
            seen.append((len(sets), device))
            return True

    sched = TS.configure(pipeline=TP.VerifyPipeline(backend=Backend()))
    futs = [sched.submit([_Set(0)], lane="block", device="cpu"),
            sched.submit([_Set(1)] * 2, lane="block", device="cuda:1"),
            sched.submit([_Set(2)], lane="sync", device="cpu")]
    assert all(f.result() for f in futs)
    assert seen == [(2, "cpu"), (2, "cuda:1")]
    assert [e["lanes"] for e in sched.launch_log] == [("block", "sync"), ("block",)]


def test_warm_capacities_are_the_set_buckets_warm_compile_captures():
    """No merged launch pads to a bucket that warm_compile never captured;
    the lanes and capacities are the JAX package's."""
    assert TS.WARM_CAPACITIES == tuple(sorted({b[0] for b in TB.DEFAULT_WARM_BUCKETS}))
    assert TS.WARM_CAPACITIES == JS.WARM_CAPACITIES
    assert TS.LANES == JS.LANES and TS.LANE_PRIORITY == JS.LANE_PRIORITY
    assert TS.MAX_LAUNCH_SETS == JS.MAX_LAUNCH_SETS
    for n in (1, 4, 5, 16, 17, 64, 65, 256, 300, 512, 513):
        assert TS.warm_capacity(n) == JS.warm_capacity(n)

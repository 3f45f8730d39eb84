"""The port's observability copies against the JAX package's: the launch
ledger (one record script gives the same dump, stats_from_records and
format_report), the span tracer (one span script under a seeded tracer
gives the same Chrome trace), the metric registry types (one operation
script exposes the same text), the slice's metric families (the same
names, types, help texts, buckets and labels), and the counters that
torch_cuda's marshal/dispatch seam and warm pass feed.

No test here compiles an XLA program (`no_xla_compile`)."""

import random

import pytest

from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu.obs import ledger as JL
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu.utils import tracing as JT
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.obs import ledger as TL
from lighthouse_tpu_torch.utils import metrics as TM
from lighthouse_tpu_torch.utils import tracing as TT
from torch_port_util import both, make_signed, no_xla_compile


@pytest.fixture(autouse=True)
def _fresh():
    saved = JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT
    with no_xla_compile():
        yield
    JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT = saved


def _record_script(L, T):
    """Every seam kind, padded and not, with lanes, slots, cache verdicts
    and warm seconds; some records inside a span."""
    T.configure(clock=T.StepClock(start=10.0, step=0.5), rng=random.Random(3))
    led = L.configure(capacity=12)
    L.record("warm", bucket="4x4x4x0", real_sets=0, padded_sets=4,
             compile_seconds=1.25, cache_hit=False)
    L.record("warm", bucket="16x4x4x16", real_sets=0, padded_sets=16,
             compile_seconds=2.5, cache_hit=True)
    for i in range(6):
        with T.span("sched_launch", entries=2, sets=5 + i):
            L.record("sched", bucket=16, real_sets=5 + i, padded_sets=16,
                     entries=2, lanes=("block", "sync"),
                     lane_sets={"block": 2, "sync": 3 + i}, slot=i // 2,
                     speculative_withheld=i % 2, real_queued_before=2)
            L.record("pipeline", real_sets=5 + i, padded_sets=16, bucket=16,
                     entries=1)
            L.record("dispatch", bucket=16, real_sets=5 + i, padded_sets=16,
                     n_messages=3, miller_pairs=17, cache_hit=i != 0)
    with pytest.raises(ValueError, match="unknown ledger kind"):
        led.record("gossip")
    return led


def test_ledger_same_dump_stats_and_report():
    j, t = _record_script(JL, JT), _record_script(TL, TT)
    assert t.dump_json() == j.dump_json()
    assert t.status() == j.status() and t.dropped == j.dropped == 8
    assert TL.stats_from_records(t.records()) == JL.stats_from_records(j.records())
    assert t.stats(window_s=3.0) == j.stats(window_s=3.0)
    lanes = {"block": {"p50_ms": 1.5, "p95_ms": 4.0}}
    assert TL.format_report(t.stats(), lanes) == JL.format_report(j.stats(), lanes)
    assert t.chrome_counter_events() == j.chrome_counter_events()
    assert TL.KINDS == JL.KINDS


def test_ledger_switched_off_records_nothing():
    TL.configure(enabled=False)
    TL.record("pipeline", real_sets=1)
    assert TL.default_ledger().records() == []
    assert TL.default_ledger().status()["enabled"] is False
    TL.configure()
    assert TL.default_ledger().capacity == TL.DEFAULT_CAPACITY == 4096
    TL.record("pipeline", real_sets=1)
    assert len(TL.default_ledger().records()) == 1


def test_tracer_same_chrome_trace():
    dumps = []
    for T in (JT, TT):
        tr = T.Tracer(clock=T.StepClock(step=1e-3), rng=random.Random(11),
                      capacity=5, sample_rate=0.5)
        with tr.span("pipeline_submit", batch=0):
            ctx = tr.current()
            with tr.span("bls_marshal", sets=4):
                tr.instant("edge")
        for b in range(4):
            with tr.attach(ctx), tr.span("pipeline_resolve", batch=b):
                pass
        dumps.append((tr.dump_json(), tr.status()))
    assert dumps[0] == dumps[1]


def test_registry_types_expose_the_same_text():
    texts = []
    for M in (JM, TM):
        reg = M.Registry()
        c, g = reg.counter("c_total", "a\\b\nc"), reg.gauge("g", "gauge")
        h = reg.histogram("h_seconds", "hist", buckets=(0.1, 1.0))
        lg = reg.labeled_gauge("lg", "labeled", label="lane")
        c.inc(3)
        g.set(2), g.inc(), g.dec(0.5)
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        lg.set('a"b', 1), lg.set("z", 2)
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("c_total")
        texts.append((reg.expose(), h.quantile(0.5), h.quantile(0.99)))
    assert texts[0] == texts[1]


def _families(M):
    out = {}
    for name, m in M.REGISTRY._metrics.items():
        out[name] = (type(m).__name__, m.help, getattr(m, "buckets", None),
                     getattr(m, "label", None))
    return out


def test_metric_families_same_names_types_and_help():
    """Every family of the port's registry is the JAX package's, line for
    line, and the slice's families are all there."""
    want, got = _families(JM), _families(TM)
    for name, fam in got.items():
        assert want.get(name) == fam, name
    for attr in ("BLS_FALLBACK_EVENTS", "BLS_USING_FALLBACK", "BLS_PIPELINE_DEPTH",
                 "BLS_PIPELINE_OCCUPANCY", "BLS_PIPELINE_OCCUPANCY_PEAK",
                 "BLS_PIPELINE_BATCHES", "BLS_GATHER_HITS", "BLS_GATHER_MISSES",
                 "BLS_MILLER_PAIRS", "BLS_MILLER_PAIRS_LAST",
                 "BLS_AGGREGATION_RATIO", "BLS_AGGREGATED_BATCHES",
                 "BLS_WEIGHT_REDRAWS", "BLS_SCHED_MERGES", "BLS_SCHED_LAUNCHES",
                 "BLS_SCHED_MERGE_FALLBACKS", "BLS_SCHED_PAD_SETS",
                 "BLS_SCHED_REAL_SETS", "BLS_SCHED_QUEUE_DEPTH",
                 "TPU_COMPILE_CACHE_HITS", "TPU_COMPILE_CACHE_MISSES",
                 "TPU_WARM_COMPILE_SECONDS", "TPU_TRANSFER_BYTES",
                 "TPU_MARSHAL_BATCH_BYTES", "TPU_PUBKEY_TABLE_BYTES",
                 "TPU_PUBKEY_GATHER_BYTES", "TPU_PUBKEY_GATHER_BATCHES",
                 "SPECULATE_TABLE_BYTES"):
        assert getattr(TM, attr).name == getattr(JM, attr).name, attr
    assert {k: v.name for k, v in TM.SCHEDULER_VERDICT_DELAY.items()} == {
        k: v.name for k, v in JM.SCHEDULER_VERDICT_DELAY.items()}

    class Clock:
        genesis_time, seconds_per_slot = 100, 12

        def now(self):
            return 137.5

    assert TM.slot_delay_seconds(Clock(), 2) == JM.slot_delay_seconds(Clock(), 2)


SEAM = ("TPU_TRANSFER_BYTES", "BLS_GATHER_MISSES", "BLS_GATHER_HITS")


@pytest.mark.parametrize("spec", [
    [((0,), 0, None), ((1,), 1, None), ((2,), 0, None)],
    [((0,), 0, None), ((1,), 1, None), ((2,), 0, None), ((3,), 1, None),
     ((0, 1), 0, None)],
])
def test_marshal_feeds_the_transfer_and_gather_counters_like_jax(spec):
    """The same host arrays cross: the same transfer bytes, the same
    last-batch gauge, one host-packed batch each."""
    jsets, tsets = both(make_signed(4, 2), spec)
    deltas = []
    for M, marshal in ((JM, lambda: jax_tpu._marshal_batch(jsets, seed=2)),
                       (TM, lambda: TB._marshal_batch(tsets, "cpu", seed=2))):
        before = [getattr(M, n).value for n in SEAM]
        marshal()
        deltas.append([getattr(M, n).value - b for n, b in zip(SEAM, before)]
                      + [M.TPU_MARSHAL_BATCH_BYTES.value])
    assert deltas[0] == deltas[1]
    assert deltas[1][1:3] == [1, 0]


def test_warm_pass_feeds_the_ledger_and_the_shape_registry():
    """warm_compile: one "warm" record per bucket with its capture
    seconds, its gauge, and a shape-registry miss then hits; the dispatch
    route's pair count follows the message switch."""
    TL.configure()
    calls = []
    buckets = [(8, 4, 8), (32, 4, 4)]
    for key in ((8, 4, 8, 0), (32, 4, 4, 32)):
        TB._seen_shape_buckets.discard(key)
    hits, misses = TM.TPU_COMPILE_CACHE_HITS.value, TM.TPU_COMPILE_CACHE_MISSES.value
    for _ in range(2):
        report = TB.warm_compile(buckets, runner=lambda k, a: calls.append(k),
                                 device="cpu")
    assert calls == ["staged", "aggregated"] * 2
    assert [r["compiled"] for r in report] == [False, False]
    assert TM.TPU_COMPILE_CACHE_MISSES.value - misses == 2
    assert TM.TPU_COMPILE_CACHE_HITS.value - hits == 2
    warm = [r.to_dict() for r in TL.default_ledger().records()]
    assert [(r["kind"], r["bucket"], r["padded_sets"], r["cache_hit"])
            for r in warm] == [("warm", "8x4x8x0", 8, False),
                               ("warm", "32x4x4x32", 32, False),
                               ("warm", "8x4x8x0", 8, True),
                               ("warm", "32x4x4x32", 32, True)]
    assert TM.TPU_WARM_COMPILE_SECONDS.get("32x4x4x32") == report[1]["seconds"]

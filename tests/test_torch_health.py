"""The monitoring health block (`utils/monitoring.py`) across the packages:
`trace_health_fields(tracer=)` and `ledger_health_fields(ledger=)` over a
fresh tracer and a fresh ledger in each package, fed the same
`work/<lane>` spans on a StepClock and the same launch records, compare
key for key and value for value. The four histograms that
`trace_health_fields` reads from the process registry are replaced, in
both packages' `metrics` modules and for this test only, by fresh ones fed
the same observations, so they are compared too. The scenario harness's
SLO report reads these fields. No test here compiles an XLA program."""

import random

from lighthouse_tpu.obs import ledger as JL
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu.utils import monitoring as JMON
from lighthouse_tpu.utils import tracing as JT
from lighthouse_tpu_torch.obs import ledger as TL
from lighthouse_tpu_torch.utils import metrics as TM
from lighthouse_tpu_torch.utils import monitoring as TMON
from lighthouse_tpu_torch.utils import tracing as TT
from torch_port_util import no_xla_compile

# the observations fed to each histogram of TMON.HEALTH_HISTOGRAMS, in order
HISTOGRAMS = dict(zip((name for _, name in TMON.HEALTH_HISTOGRAMS), (
    (0.001, 0.004, 0.02, 0.02, 0.3),
    (0.5, 1.25, 2.0, 3.9),
    (1.0, 1.5, 4.0),
    (1.1, 7.5),
), strict=True))
# (lane, spans of that lane, inner span count of each): the StepClock
# gives each work span a duration of its inner spans' clock reads
WORK = (
    ("gossip_attestation", (0, 3, 1, 7, 2)),
    ("gossip_block", (5,)),
    ("gossip_aggregate", (1, 1, 4)),
)


def _feed(M, T, L):
    tracer = T.Tracer(clock=T.StepClock(start=3.0, step=0.25),
                      rng=random.Random(21), capacity=64)
    for lane, spans in WORK:
        for inner in spans:
            with tracer.span(f"work/{lane}", items=inner):
                for i in range(inner):
                    with tracer.span("bls_marshal", sets=i):
                        pass
    with tracer.span("pipeline_submit", batch=0):
        pass
    led = L.Ledger(clock=T.StepClock(start=1.0, step=0.5), capacity=16)
    led.record("warm", bucket="4x4x4x0", real_sets=0, padded_sets=4,
               compile_seconds=1.5, cache_hit=False)
    for i in range(5):
        led.record("sched", bucket=16, real_sets=5 + i, padded_sets=16,
                   entries=2, lanes=("block", "speculative"),
                   lane_sets={"block": 4 + i, "speculative": 1}, slot=i,
                   speculative_withheld=i % 2, real_queued_before=i % 3)
        led.record("pipeline", real_sets=5 + i, padded_sets=16, bucket=16,
                   entries=1)
        led.record("dispatch", bucket=16, real_sets=5 + i, padded_sets=16,
                   n_messages=3, miller_pairs=17, cache_hit=i > 1)
    return tracer, led


def test_trace_and_ledger_health_fields_equal_across_packages(monkeypatch):
    got = []
    with no_xla_compile():
        for M, T, L, MON in ((JM, JT, JL, JMON), (TM, TT, TL, TMON)):
            for name, values in HISTOGRAMS.items():
                old = getattr(M, name)
                fresh = M.Histogram(old.name, old.help, buckets=old.buckets)
                for v in values:
                    fresh.observe(v)
                monkeypatch.setattr(M, name, fresh)
            tracer, led = _feed(M, T, L)
            got.append((MON.trace_health_fields(tracer=tracer),
                        MON.ledger_health_fields(ledger=led)))
    (jtrace, jled), (ttrace, tled) = got
    assert ttrace == jtrace
    assert tled == jled
    # every field is there: three lanes, four histograms, the ledger's
    # occupancy block
    assert len(jtrace) == len(WORK) + len(HISTOGRAMS)
    assert {"launch_occupancy", "pad_waste_ratio"} <= set(jled)
    assert jled["cold_dispatches"] == 2 and jled["speculative_withheld_total"] == 2

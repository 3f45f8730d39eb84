"""The environment switches that both packages read, set with
`monkeypatch.setenv` and read through each package's own functions, as
each reads them on each call: the scheduler's launch threshold
(`LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS`), whether the launch ledger records
(`LIGHTHOUSE_TPU_LEDGER`) and the capacity of a fresh default ledger
(`LIGHTHOUSE_TPU_LEDGER_CAPACITY`), and the default tracer's sample rate
(`LIGHTHOUSE_TPU_TRACE_SAMPLE`), including the defaults an unparsable value
falls back to. No test here compiles an XLA program."""

import pytest

from lighthouse_tpu.crypto.bls import scheduler as JS
from lighthouse_tpu.obs import ledger as JL
from lighthouse_tpu.utils import tracing as JT
from lighthouse_tpu_torch.crypto.bls import scheduler as TS
from lighthouse_tpu_torch.obs import ledger as TL
from lighthouse_tpu_torch.utils import tracing as TT
from torch_port_util import no_xla_compile


@pytest.fixture(autouse=True)
def _fresh():
    saved = JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT, JS._DEFAULT, TS._DEFAULT
    with no_xla_compile():
        yield
    JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT, JS._DEFAULT, TS._DEFAULT = saved


@pytest.mark.parametrize("value", [None, "1", "3", "64"])
def test_scheduler_launch_threshold(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS", raising=False)
    else:
        monkeypatch.setenv("LIGHTHOUSE_TPU_CONT_BATCH_MAX_SETS", value)
    assert TS._max_sets() == JS._max_sets() == int(value or 64)
    # the threshold a fresh scheduler launches at: the submit that brings
    # the queued real sets to it flushes, the one before does not
    threshold = JS._max_sets()
    for S in (JS, TS):
        sched = S.ContinuousBatchScheduler()
        launched = []
        for k in range(threshold):
            sched.flush = lambda k=k: launched.append(k)
            sched.submit([object()], lane="block", slot=1)
        assert launched[:1] == [threshold - 1], S.__name__


@pytest.mark.parametrize("value", [None, "0", "1", "no"])
def test_ledger_records_or_not(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("LIGHTHOUSE_TPU_LEDGER", raising=False)
    else:
        monkeypatch.setenv("LIGHTHOUSE_TPU_LEDGER", value)
    got = []
    for L in (JL, TL):
        L.configure(capacity=8, clock=JT.StepClock())
        L.record("pipeline", real_sets=1, padded_sets=4, bucket=4, entries=1)
        got.append((L.enabled(), len(L.default_ledger().records())))
    assert got[0] == got[1] == ((value != "0"), int(value != "0"))


@pytest.mark.parametrize("value", [None, "7", "100000", "lots"])
def test_fresh_default_ledger_capacity(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("LIGHTHOUSE_TPU_LEDGER_CAPACITY", raising=False)
    else:
        monkeypatch.setenv("LIGHTHOUSE_TPU_LEDGER_CAPACITY", value)
    caps = []
    for L in (JL, TL):
        L._DEFAULT = None
        caps.append((L.default_ledger().capacity, L.configure().capacity,
                     L._default_capacity()))
    want = int(value) if value and value.isdigit() else 4096
    assert caps[0] == caps[1] == (want,) * 3


@pytest.mark.parametrize("value", [None, "1", "0.25", "0", "half"])
def test_default_tracer_sample_rate(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("LIGHTHOUSE_TPU_TRACE_SAMPLE", raising=False)
    else:
        monkeypatch.setenv("LIGHTHOUSE_TPU_TRACE_SAMPLE", value)
    rates = []
    for T in (JT, TT):
        T._DEFAULT = None
        rates.append(T.default_tracer().sample_rate)
    want = 1.0 if value in (None, "half") else float(value)
    assert rates[0] == rates[1] == want

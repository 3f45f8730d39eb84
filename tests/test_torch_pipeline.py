"""The port's verification pipeline (lighthouse_tpu_torch/crypto/bls/
pipeline.py) against the JAX package's (lighthouse_tpu/crypto/bls/
pipeline.py): one submission script over stub backends in both packages,
at depths 1, 2 and 3, gives the same EventLog sequence, the same verdicts,
the same errors at result(), the same done() answers and the same
occupancy gauges; the same spans on a seeded tracer; the keywords the
port passes to a dispatch hook that takes them; and one 4-set batch
through verify_signature_sets_async on torch_cuda with device="cpu" gives
the sync verdict, with its spans and launch-ledger records.

No test here compiles an XLA program (`no_xla_compile`): the stubs stand
in for device work, and the end-to-end batch runs the port's plain
versions on the CPU."""

import random

import pytest
import torch

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import pipeline as JP
from lighthouse_tpu.obs import ledger as JL
from lighthouse_tpu.resilience.primitives import EventLog as JEventLog
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu.utils import tracing as JT
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls import pipeline as TP
from lighthouse_tpu_torch.obs import ledger as TL
from lighthouse_tpu_torch.resilience.primitives import EventLog as TEventLog
from lighthouse_tpu_torch.utils import metrics as TM
from lighthouse_tpu_torch.utils import tracing as TT
from torch_port_util import both, make_signed, no_xla_compile

PKG = {
    "jax": (japi, JP, JM, JT, JL, JEventLog),
    "torch": (tapi, TP, TM, TT, TL, TEventLog),
}


@pytest.fixture(autouse=True)
def _fresh():
    """Each test's backends, pipelines, tracers and ledgers are put back
    as they were; no XLA compile inside."""
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE,
             JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT)
    with no_xla_compile():
        yield
    JP.configure()
    TP.configure()
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE,
     JT._DEFAULT, TT._DEFAULT, JL._DEFAULT, TL._DEFAULT) = saved


class _Set:
    """A signature set's shape as the pipeline sees it: grouping reads
    only the message."""

    def __init__(self, i, n_msgs=2):
        self.message = b"m%d" % (i % n_msgs)
        self.pubkeys = [i]


class _LazyVerdict:
    """A zero-dim device bool in miniature: `bool()` is observable, and
    can fail the way a device fault surfaces at materialisation."""

    def __init__(self, value, log, batch):
        self.value, self.log, self.batch = value, log, batch

    def __bool__(self):
        self.log.append(("materialize", self.batch))
        if isinstance(self.value, Exception):
            raise self.value
        return self.value


# per batch: the verdict, an exception raised at dispatch ("dispatch"), or
# one raised when the verdict is materialised ("materialize"); [] is an
# empty batch
SCRIPT = [True, False, "dispatch", True, [], "materialize", True, False]


class _JaxStub:
    """The JAX pipeline's async stub: dispatch takes the precomputed
    message groups."""

    def __init__(self):
        self.log = []
        self.n = 0

    def dispatch_verify_signature_sets(self, sets, seed=None, groups=None):
        n = self.n
        self.n += 1
        self.log.append(("dispatch", n, seed, groups.n_messages))
        v = SCRIPT[[i for i, s in enumerate(SCRIPT) if s != []][n]]
        if v == "dispatch":
            raise ConnectionError(f"batch {n} fell over at dispatch")
        if v == "materialize":
            v = RuntimeError(f"batch {n} fell over at materialise")
        return _LazyVerdict(v, self.log, n)


class _TorchStub(_JaxStub):
    """The same stub for the port, whose dispatch hook also takes the
    device."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def dispatch_verify_signature_sets(self, sets, seed=None, groups=None,
                                       device=None):
        self.devices.append(device)
        return super().dispatch_verify_signature_sets(sets, seed=seed,
                                                      groups=groups)


def _drive(pkg, depth, resolve_order):
    """Submit SCRIPT, then resolve the futures in `resolve_order`; the
    observable trace of both packages' pipelines."""
    _, P, M, T, _, EventLog = PKG[pkg]
    M.BLS_PIPELINE_OCCUPANCY_PEAK.set(0)
    T.configure(rng=random.Random(7))
    events = EventLog()
    stub = _JaxStub() if pkg == "jax" else _TorchStub()
    pipe = P.VerifyPipeline(backend=stub, depth=depth, events=events)
    futs, occ = [], []
    for i, item in enumerate(SCRIPT):
        sets = [] if item == [] else [_Set(i), _Set(i + 1)]
        futs.append(pipe.submit(sets, seed=100 + i))
        occ.append((pipe.occupancy(), M.BLS_PIPELINE_OCCUPANCY.value,
                    M.BLS_PIPELINE_OCCUPANCY_PEAK.value))
    done_before = [f.done() for f in futs]
    outcome = {}
    for k in resolve_order:
        try:
            outcome[k] = futs[k].result()
        except Exception as e:  # noqa: BLE001 -- the script's faults
            outcome[k] = (type(e).__name__, str(e))
    pipe.drain()
    spans = [(s.name, dict(s.attrs)) for s in T.default_tracer().finished_spans()]
    return dict(events=events.events, log=stub.log, occupancy=occ,
                done=done_before, outcome=outcome,
                after=[f.done() for f in futs], spans=spans,
                gauge=M.BLS_PIPELINE_OCCUPANCY.value,
                depth=M.BLS_PIPELINE_DEPTH.value)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_same_script_same_events_verdicts_errors_and_gauges(depth):
    order = [5, 0, 7, 2, 4, 1, 3, 6]
    want = _drive("jax", depth, order)
    got = _drive("torch", depth, order)
    for key in want:
        assert got[key] == want[key], key
    assert want["outcome"][1] is False and want["outcome"][6] is True
    assert want["outcome"][2][0] == "ConnectionError"
    assert want["outcome"][5][0] == "RuntimeError"
    # the double buffer: batch 1 marshalled before batch 0 resolved
    kinds = [(e[0], dict(e[1:])["batch"]) for e in want["events"]]
    if depth > 1:
        assert kinds.index(("pipeline_marshal", 1)) < kinds.index(
            ("pipeline_resolve", 0))
    assert max(o[0] for o in want["occupancy"]) == depth


def test_resolution_runs_in_submit_order_in_both():
    """Asking for the last future first resolves every earlier one first,
    in both packages (the empty batch resolves at its submit), and the
    pipeline's spans open."""
    for pkg in PKG:
        run = _drive(pkg, 3, [7])
        resolves = [dict(e[1:])["batch"] for e in run["events"]
                    if e[0] == "pipeline_resolve"]
        empty = SCRIPT.index([])
        assert resolves.index(empty) < resolves.index(empty - 1)
        assert [b for b in resolves if b != empty] == [
            b for b in range(len(SCRIPT)) if b != empty]
        names = {n for n, _ in run["spans"]}
        assert {"pipeline_submit", "pipeline_resolve", "bls_aggregate"} <= names


def test_dispatch_hook_gets_the_keywords_it_takes():
    """groups always; index_pack with a prepack hook; pad_to when asked;
    the submit's device, else the api's."""
    seen = []

    class Backend:
        def prepack_indices(self, sets):
            return ("pack", len(sets))

        def dispatch_verify_signature_sets(self, sets, seed=None, groups=None,
                                           index_pack=None, pad_to=None,
                                           device=None):
            seen.append((groups.n_messages, index_pack, pad_to, device))
            return True

    pipe = TP.VerifyPipeline(backend=Backend(), depth=2)
    tapi.set_backend("fake", device=None)
    pipe.submit([_Set(0), _Set(1)], pad_to=16).result()
    pipe.submit([_Set(0)], device="cpu").result()
    tapi.set_backend("fake", device="cpu")
    pipe.submit([_Set(0)]).result()
    assert seen == [(2, ("pack", 2), 16, None), (1, ("pack", 1), None, "cpu"),
                    (1, ("pack", 1), None, "cpu")]


def test_eager_backend_gets_the_device_when_it_takes_one():
    seen = []

    class Eager:
        def verify_signature_sets(self, sets, seed=None, device=None):
            seen.append(device)
            return len(sets) == 1

    class OldEager:
        def verify_signature_sets(self, sets, seed=None):
            return True

    f = TP.VerifyPipeline(backend=Eager()).submit([_Set(0)], device="cpu")
    assert f.done() and f.result() is True and seen == ["cpu"]
    assert TP.VerifyPipeline(backend=OldEager()).submit([_Set(0)]).result()


def test_done_never_blocks_and_cpu_verdicts_record_no_event():
    """A CPU tensor verdict gets no host copy and no CUDA event; done() is
    True once dispatched (nothing to wait for) and the verdict is its
    bool."""
    t = torch.tensor(True)
    assert TP._stage_verdict(t)[0] is t and TP._stage_verdict(t)[1] is None
    assert TP._stage_verdict(True) == (True, None)

    class Backend:
        def dispatch_verify_signature_sets(self, sets, seed=None, device=None):
            return torch.tensor(len(sets) == 2)

    pipe = TP.VerifyPipeline(backend=Backend(), depth=2)
    futs = [pipe.submit([_Set(0)] * n) for n in (2, 1)]
    assert all(f.done() for f in futs)
    assert [f.result() for f in futs] == [True, False]


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_empty_batch_and_fake_backend_through_the_api(pkg):
    api, P = PKG[pkg][:2]
    P.configure()
    api.set_backend("fake")
    fut = api.verify_signature_sets_async([])
    assert fut.done() and fut.result() is False
    s = [_Set(0)]
    assert api.verify_signature_sets_async(s).result() is True


def test_async_verdict_equals_sync_on_torch_cuda_cpu():
    """One 4-set batch (2 messages: the per-set route) through the
    pipeline on torch_cuda with device="cpu" gives the sync verdict of
    this honest batch, True (test_torch_bls.py holds the sync verify's
    verdicts on honest and forged per-set batches against the JAX oracle;
    it is not run again here, so that the test makes one CPU verify);
    the pipeline, aggregation, marshal and dispatch spans
    open and the pipeline and dispatch seams each record one launch."""
    _, tsets = both(make_signed(4, 2),
                    [((0,), 0, None), ((1,), 1, None), ((2,), 0, None),
                     ((3,), 1, None)])
    tapi.set_backend("torch_cuda", device="cpu")
    TT.configure(rng=random.Random(1))
    TL.configure()
    TP.configure(depth=2)
    fut = tapi.verify_signature_sets_async(tsets, seed=3)
    assert isinstance(fut, TP.VerifyFuture)
    assert fut.result() is True
    names = [s.name for s in TT.default_tracer().finished_spans()]
    for name in ("pipeline_submit", "bls_aggregate", "bls_marshal",
                 "bls_dispatch", "pipeline_resolve"):
        assert name in names, name
    records = [r.to_dict() for r in TL.default_ledger().records()]
    kinds = [r["kind"] for r in records]
    assert kinds.count("pipeline") == 1 and kinds.count("dispatch") == 1
    dispatch = records[kinds.index("dispatch")]
    assert (dispatch["bucket"], dispatch["real_sets"], dispatch["miller_pairs"],
            dispatch["n_messages"]) == (4, 4, 5, 2)

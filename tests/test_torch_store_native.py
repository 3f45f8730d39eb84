"""The port's native store, consistency checker and injectors
(lighthouse_tpu_torch/store/{native_kv,fsck}.py, resilience/{faults,
crash,primitives}.py) against the JAX package's on the CPU:

- a NativeStore (the port's copy of kvstore.cc, built with g++ into
  build/native/) and the JAX one after the same puts, deletes, batches
  and a compaction: the same file bytes, and each package opens the
  other's file with the same keys, values and recovery counts, also after
  a torn tail; a source that does not compile and a missing g++ raise
  `NativeBuildError` (nothing falls back to another store);
- `run_fsck` over one finalized harness chain's store (16 validators,
  the port's harness on `fake`), copied key by key into both packages:
  clean on both, then the same issues for a planted hole in the frozen
  block roots, an orphaned journal row and a head without its state;
- a CrashPlan at every op index of one journaled batch, for each action:
  the same op indices and events, and the same store bytes after journal
  recovery; a seeded random plan the same schedule;
- a FaultPlan's schedule over a wrapped target (random rates and
  scripts); RetryPolicy, Timeout and HealthTracker under a VirtualClock:
  the same results, events, clocks and metric values.

No XLA compile."""

import random
import struct

import pytest

from lighthouse_tpu import resilience as JR
from lighthouse_tpu import types as J
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.resilience import crash as JC
from lighthouse_tpu.store import fsck as JF
from lighthouse_tpu.store import hot_cold as JHC
from lighthouse_tpu.store import kv as JKV
from lighthouse_tpu.store import native_kv as JN
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu_torch import resilience as TR
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import BeaconChainHarness
from lighthouse_tpu_torch.resilience import crash as TC
from lighthouse_tpu_torch.store import fsck as TF
from lighthouse_tpu_torch.store import hot_cold as THC
from lighthouse_tpu_torch.store import kv as TKV
from lighthouse_tpu_torch.store import native_kv as TN
from lighthouse_tpu_torch.utils import metrics as TM
from torch_port_util import no_xla_compile

PKG = {"jax": (JN, JKV, JF, JHC, JR, JC, JM, J), "torch": (TN, TKV, TF, THC, TR, TC, TM, T)}


@pytest.fixture(autouse=True)
def _guard():
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _dump(kv, KV):
    """{column: {key: value}} over every column of the package's store."""
    out = {}
    for name in vars(KV.Column):
        if not name.startswith("_"):
            col = getattr(KV.Column, name)
            entries = {k: kv.get(col, k) for k in kv.keys(col)}
            if entries:
                out[col] = entries
    return out


def _ops(store):
    store.put(b"blk", b"\x00" * 31 + b"\x01", b"block one")
    store.put(b"blk", b"\x00" * 32, b"block zero" * 20)
    store.put(b"ste", b"root", bytes(range(256)))
    store.delete(b"blk", b"\x00" * 32)
    store.do_atomically([("put", b"met", b"head", b"\x07" * 32),
                         ("delete", b"ste", b"root", None),
                         ("put", b"ste", b"root2", b"state")])
    store.put(b"blk", b"\x00" * 31 + b"\x01", b"block one, again")


def test_native_store_bytes_and_files_cross_open(tmp_path):
    paths = {}
    for name, (N, *_) in PKG.items():
        store = N.NativeStore(str(tmp_path / f"{name}.db"))
        _ops(store)
        assert len(store) == 3
        store.close()
        paths[name] = tmp_path / f"{name}.db"
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    assert str(TN._lib_path()).startswith(str(TN.BUILD_ROOT))
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        N, KV = PKG[reader][0], PKG[reader][1]
        other = N.NativeStore(str(paths[writer]))
        own = N.NativeStore(str(paths[reader]))
        assert _dump(other, KV) == _dump(own, KV) and other.recovery_stats == \
            own.recovery_stats
        other.close(), own.close()
    # a compaction rewrites the log the same way
    for name, (N, *_) in PKG.items():
        store = N.NativeStore(str(paths[name]))
        store.compact()
        store.close()
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()


def test_native_store_recovers_a_torn_tail_as_jax(tmp_path):
    src = tmp_path / "src.db"
    store = TN.NativeStore(str(src))
    _ops(store)
    store.do_atomically([("put", b"blk", b"late", b"x" * 100)])
    store.close()
    raw = src.read_bytes()
    seen = {}
    for name, (N, KV, *_, M, _) in PKG.items():
        path = tmp_path / f"{name}-torn.db"
        path.write_bytes(raw[:-37])  # the last batch torn mid-record
        counts0 = (M.STORE_NATIVE_REPLAYED.value, M.STORE_NATIVE_ROLLED_BACK.value,
                   M.STORE_NATIVE_TRUNCATED.value)
        store = N.NativeStore(str(path))
        counts = tuple(getattr(M, f).value - c for f, c in zip(
            ("STORE_NATIVE_REPLAYED", "STORE_NATIVE_ROLLED_BACK",
             "STORE_NATIVE_TRUNCATED"), counts0))
        seen[name] = (_dump(store, KV), store.recovery_stats, counts)
        store.close()
        seen[name] += (path.read_bytes(),)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1]["truncated_bytes"] > 0


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "kvstore.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "_LIB", None)
    monkeypatch.setattr(TN, "_SRC", bad)
    monkeypatch.setattr(TN, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(TN.NativeBuildError, match="g\\+\\+ failed"):
        TN.NativeStore(str(tmp_path / "x.db"))
    monkeypatch.setattr(TN, "_SRC", TN._PKG / "native" / "kvstore.cc")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(TN.NativeBuildError, match="could not run"):
        TN.NativeStore(str(tmp_path / "y.db"))
    assert not (tmp_path / "x.db").exists() and not (tmp_path / "y.db").exists()


@pytest.fixture(scope="module")
def finalized_store():
    """A harness chain past finality on the port (16 validators, `fake`):
    its store's raw (column, key, value) rows and its spec."""
    saved = (tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    tapi.set_backend("fake")
    try:
        h = BeaconChainHarness(16, T.MINIMAL, T.ChainSpec.minimal(), device="cpu")
        while h.finalized_epoch() < 2:
            h.extend_chain(1)
        assert h.store.split_slot > 0
        rows = [(col, k, h.store.kv.get(col, k))
                for col in _dump(h.store.kv, TKV) for k in h.store.kv.keys(col)]
    finally:
        tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE = saved
    return rows


def _fsck(name, rows, plant=None):
    N, KV, F, HC, *_, M, P = PKG[name]
    kv = KV.MemoryStore()
    for col, k, v in rows:
        kv.put(col, k, v)
    db = HC.HotColdDB(kv, P.MINIMAL, P.ChainSpec.minimal())
    if plant is not None:
        plant(db, KV)
    runs, fails = M.STORE_FSCK_RUNS.value, M.STORE_FSCK_FAILURES.value
    issues = [(i.check, i.detail, str(i)) for i in F.run_fsck(db)]
    return issues, (M.STORE_FSCK_RUNS.value - runs, M.STORE_FSCK_FAILURES.value - fails)


def _hole(db, KV):
    row = bytearray(db.kv.get(KV.Column.FREEZER_BLOCK_ROOTS, struct.pack(">Q", 0)))
    row[3 * 32:4 * 32] = bytes(32)
    db.kv.put(KV.Column.FREEZER_BLOCK_ROOTS, struct.pack(">Q", 0), bytes(row))


def _journal_and_head(db, KV):
    db.kv.put(KV.Column.JOURNAL, KV.JOURNAL_KEY, b"\x01torn")
    mapped = db.get_chain_item(b"block_post_state:" + db.get_chain_item(b"head_block_root"))
    db.kv.delete(KV.Column.STATE, mapped)
    db.kv.delete(KV.Column.STATE_SUMMARY, mapped)


@pytest.mark.parametrize("plant", [None, _hole, _journal_and_head],
                         ids=["clean", "hole", "journal-and-head"])
def test_fsck_reports_equal_jax(finalized_store, plant):
    got, want = _fsck("torch", finalized_store, plant), _fsck("jax", finalized_store, plant)
    assert got == want
    assert (got[0] == []) is (plant is None)
    assert got[1] == (1, len(got[0]))


BATCH = [("put", b"blk", b"a" * 32, b"A" * 40), ("put", b"ste", b"s" * 32, b"S" * 64),
         ("delete", b"blk", b"old" * 8, None), ("put", b"met", b"head", b"H" * 32)]


@pytest.mark.parametrize("action", ["crash", "torn", "after"])
def test_crash_at_every_op_of_a_batch_recovers_as_jax(action):
    outcomes = {}
    for name in PKG:
        KV, C = PKG[name][1], PKG[name][5]
        runs = []
        for index in range(8):
            inner = KV.MemoryStore()
            inner.put(b"blk", b"old" * 8, b"O" * 16)
            plan = C.CrashPlan(crash_at=index, action=action)
            died = None
            try:
                C.CrashingStore(inner, plan).do_atomically(BATCH)
            except C.InjectedCrash as e:
                died = str(e)
            recovered = KV.recover_journal(inner)
            runs.append((died, plan.ops, plan.events.events, recovered,
                         sorted((col, k, v) for col, d in _dump(inner, KV).items()
                                for k, v in d.items())))
        outcomes[name] = runs
    assert outcomes["torch"] == outcomes["jax"]
    assert outcomes["torch"][-1][0] is None  # past the batch's last op
    assert isinstance(TC.InjectedCrash("x"), BaseException)
    assert not isinstance(TC.InjectedCrash("x"), Exception)


def test_random_crash_plan_schedule_equals_jax():
    def schedule(C):
        plan = C.CrashPlan(seed=5, crash_rate=0.1, action=C.AFTER)
        out = [plan.decide("put") for _ in range(40)]
        plan.arm(3, action=C.TORN)
        out += [plan.decide("delete") for _ in range(5)]
        return out, plan.events.events

    assert schedule(TC) == schedule(JC)


class _Target:
    def __init__(self):
        self.calls = 0

    def fetch(self, n):
        self.calls += 1
        return n * 2

    def head(self):
        return "head"


def _faults(R):
    clock = R.VirtualClock()
    plan = R.FaultPlan(seed=11, error_rate=0.2, delay_rate=0.2, hang_rate=0.1,
                       delay_s=0.5, hang_s=30.0, clock=clock)
    plan.script("node.head", [R.faults.OK, R.faults.ERROR, ("delay", 2.5)])
    plan.fail_next("node", 1)
    proxy = plan.wrap(_Target(), "node", methods=["fetch", "head"])
    out = []
    for i in range(40):
        if i == 20:
            plan.set_rates(error_rate=0.5)
        try:
            out.append(("ok", proxy.fetch(i) if i % 3 else proxy.head()))
        except (ConnectionError, TimeoutError) as e:
            out.append((type(e).__name__, str(e)))
        out.append(clock.now())
    plan.clear_scripts()
    return out, plan.events.events, plan.calls, plan.injected


def test_fault_plan_schedule_equals_jax():
    assert _faults(TR) == _faults(JR)


def _primitives(R, M):
    clock, events = R.VirtualClock(), R.EventLog()
    out = []
    retries0 = M.RETRY_ATTEMPTS.value
    policy = R.RetryPolicy(max_attempts=4, rng=random.Random(3), clock=clock, events=events)
    left = [2]

    def flaky():
        if left[0]:
            left[0] -= 1
            raise ConnectionError("down")
        return "up"

    out.append(policy.call(flaky))
    try:
        policy.call(lambda: (_ for _ in ()).throw(OSError("gone")))
    except R.RetryExhausted as e:
        out.append(str(e))
    out.append([round(policy.delay_for(a), 12) for a in range(5)])
    out.append(policy.pause(2))
    timeout = R.Timeout(clock, 1.0)
    out.append(timeout.call(lambda: clock.advance(0.5) or "fast"))
    try:
        timeout.call(clock.advance, 3.0)
    except R.TimeoutExceeded as e:
        out.append(str(e))
    health = R.HealthTracker(clock=clock, window=4, threshold=0.5, reprobe_after_s=10.0,
                             events=events, name="eth1")
    for ok in (True, False, False, False):
        health.record(0, ok)
    health.record(1, True)
    out.append((health.score(0), health.is_healthy(0), health.ranked([0, 1, 2])))
    clock.advance(11.0)
    out.append(health.ranked([0, 1, 2]))
    fail = {0}
    out.append(health.failover(["a", "b", "c"], lambda t: t.upper() if t != "a" else
                               (_ for _ in ()).throw(ConnectionError("a down"))))
    try:
        health.failover(["x"], lambda t: (_ for _ in ()).throw(OSError("x")),
                        on_error=lambda i, e: fail.add(i))
    except R.AllEndpointsFailed as e:
        out.append((str(e), str(e.last)))
    out.append((M.RETRY_ATTEMPTS.value - retries0, M.ENDPOINT_HEALTH.get("eth1/0"),
                M.ENDPOINT_HEALTH.get("eth1/1")))
    return out, events.events, clock.now(), sorted(fail)


def test_retry_timeout_and_health_equal_jax():
    assert _primitives(TR, TM) == _primitives(JR, JM)

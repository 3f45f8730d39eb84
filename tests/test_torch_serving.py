"""The port's serving tier (lighthouse_tpu_torch/serving/), task executor and
monitoring (utils/{executor,monitoring}.py) against the JAX package's on
the CPU:

- lanes and anchor kinds of the same routes, and ETags of the same bodies;
- the response cache's LRU bound, anchor invalidation and counters;
  single-flight coalescing of concurrent misses (one computation, the
  followers counted, a leader's failure degrading them to their own
  computation);
- the SSE ring's and broadcaster's drops, the subscriber cap, topic
  filters;
- admission: the same sheds for the same health readings and processor
  depths;
- over HTTP, on both packages' harness chains (`fake` backend): a cold
  GET, a cache hit, a 304, a read-only GET shed with 503 and Retry-After
  under pressure while a duty POST passes, the SERVING_* counters moved
  alike and shown on /metrics, and a live SSE stream's frames;
- TaskExecutor spawns, a panicking task's failure shutdown and its
  counters; the monitoring push's records over a MonitoringRig and the
  beacon-node source's fields.

Every server is stopped in `finally`; every stream has a `limit=` and a
timeout. No XLA compile."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from lighthouse_tpu import http_api as JH
from lighthouse_tpu import serving as JS
from lighthouse_tpu import types as J
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.harness import BeaconChainHarness as JHarness
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu.utils import executor as JE
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu.utils import monitoring as JMon
from lighthouse_tpu.validator_client import InProcessBeaconNode as JNode
from lighthouse_tpu_torch import http_api as TH
from lighthouse_tpu_torch import serving as TS
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import BeaconChainHarness
from lighthouse_tpu_torch.utils import executor as TE
from lighthouse_tpu_torch.utils import metrics as TM
from lighthouse_tpu_torch.utils import monitoring as TMon
from lighthouse_tpu_torch.validator_client import InProcessBeaconNode
from torch_port_util import jax_keys_from_port, no_xla_compile

TIMEOUT_S = 10.0
BOTH = ((TS, TM), (JS, JM))
ROUTES = (
    ("GET", "/eth/v1/beacon/genesis"), ("GET", "/eth/v1/beacon/states/head/validators"),
    ("GET", "/eth/v1/beacon/states/finalized/root"), ("GET", "/eth/v1/beacon/states/0xab/root"),
    ("GET", "/eth/v2/beacon/blocks/head"), ("GET", "/eth/v1/config/spec"),
    ("GET", "/eth/v1/node/health"), ("GET", "/eth/v1/node/syncing"), ("GET", "/metrics"),
    ("GET", "/eth/v1/validator/duties/proposer/1"), ("POST", "/eth/v1/beacon/blocks"),
    ("POST", "/eth/v1/beacon/pool/attestations"), ("GET", "/eth/v1/beacon/pool/attestations"),
    ("GET", "/lighthouse/health"), ("GET", "/eth/v2/debug/beacon/states/head"),
    ("GET", "/eth/v1/events"), ("GET", "/eth/v1/beacon/light_client/finality_update"),
    ("POST", "/eth/v1/validator/duties/attester/0"), ("GET", "/eth/v1/node/version"),
)


@pytest.fixture(autouse=True)
def _backends(monkeypatch):
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


def test_lanes_anchors_and_etags_alike():
    for method, path in ROUTES:
        assert TS.classify_lane(method, path) == JS.classify_lane(method, path), path
        assert TS.classify_anchor(method, path) == JS.classify_anchor(method, path), path
    assert {TS.classify_lane(m, p) for m, p in ROUTES} == {TS.VALIDATOR, TS.READ_ONLY,
                                                           TS.DEBUG}
    for body in (b"", b"{}", bytes(range(256)) * 9):
        assert TS.make_etag(body) == JS.make_etag(body)


def _cache_run(S):
    c = S.ResponseCache(max_entries=3)
    keys = [S.ResponseCache.key(f"/r{i}", {"a": str(i)}, S.HEAD if i % 2 else S.FINALIZED,
                                "0xaa" if i % 2 else i) for i in range(5)]
    for i, k in enumerate(keys):
        c.store(k, b"body%d" % i, "application/json", S.make_etag(b"body%d" % i))
    seen = [None if c.lookup(k) is None else c.lookup(k).body for k in keys]
    c.invalidate(S.HEAD, "0xbb")  # the head moved: entries under 0xaa go
    after = [c.lookup(k) is not None for k in keys]
    return seen, after, c.stats()


def test_response_cache_lru_and_invalidation_alike():
    port, jax = _cache_run(TS), _cache_run(JS)
    assert port == jax
    seen, after, _ = port
    assert seen[:2] == [None, None] and seen[2:] == [b"body2", b"body3", b"body4"]
    assert after == [False, False, True, False, True]


def _single_flight(S, fail_leader):
    """Four concurrent misses of one key while the leader's computation
    waits: (outcomes sorted, computations, coalesced)."""
    c = S.ResponseCache()
    key = S.ResponseCache.key("/x", {}, S.HEAD, "0x01")
    release, entered = threading.Event(), threading.Event()
    computed, outcomes = [], []

    def compute():
        computed.append(1)
        if len(computed) == 1:
            entered.set()
            assert release.wait(TIMEOUT_S)
            if fail_leader:
                raise RuntimeError("leader failed")
        return b"v", "application/json", S.make_etag(b"v")

    def call():
        try:
            entry, outcome = c.get_or_compute(key, compute, timeout=TIMEOUT_S)
            outcomes.append((outcome, entry.body))
        except RuntimeError as e:
            outcomes.append(("error", str(e)))

    leader = threading.Thread(target=call)
    leader.start()
    assert entered.wait(TIMEOUT_S)
    followers = [threading.Thread(target=call) for _ in range(3)]
    for t in followers:
        t.start()
    deadline = time.monotonic() + TIMEOUT_S
    while c.coalesced < 3 and time.monotonic() < deadline:
        time.sleep(0.001)
    release.set()
    for t in [leader] + followers:
        t.join(TIMEOUT_S)
    return sorted(outcomes), len(computed), c.coalesced


@pytest.mark.parametrize("fail_leader", [False, True], ids=["coalesced", "leader-fails"])
def test_single_flight_coalescing_alike(fail_leader):
    c0 = (TM.SERVING_COALESCED.value, JM.SERVING_COALESCED.value)
    port, jax = _single_flight(TS, fail_leader), _single_flight(JS, fail_leader)
    assert port == jax
    assert (TM.SERVING_COALESCED.value - c0[0], JM.SERVING_COALESCED.value - c0[1]) == (3, 3)
    if fail_leader:
        assert port == ([("coalesced", b"v")] * 3 + [("error", "leader failed")], 4, 3)
    else:
        assert port == ([("coalesced", b"v")] * 3 + [("miss", b"v")], 1, 3)


def _sse_run(S):
    ring = S.EventRing(capacity=3)
    for i in range(5):
        ring.append(("head", {"n": i}))
    b = S.EventBroadcaster(max_subscribers=2, buffer=2)
    heads, every = b.subscribe(["head"]), b.subscribe(None)
    refused = b.subscribe(["block"])
    for i in range(4):
        b.publish("head" if i % 2 else "block", {"n": i})
    stats = b.stats()
    popped = [every.pop(0.0), every.pop(0.0), every.pop(0.0), heads.pop(0.0), heads.pop(0.0)]
    b.unsubscribe(heads)
    b.close()
    return (ring.snapshot(), ring.dropped, refused, stats, popped, every.closed,
            b.stats())


def test_sse_ring_and_broadcaster_drops_alike():
    port, jax = _sse_run(TS), _sse_run(JS)
    assert port == jax
    snapshot, dropped, refused, stats, popped, closed, final = port
    assert [e[1]["n"] for e in snapshot] == [2, 3, 4] and dropped == 2 and refused is None
    assert stats == {"subscribers": 2, "rejected": 1, "published": 4, "dropped": 2}
    assert popped == [("block", {"n": 2}), ("head", {"n": 3}), None,
                      ("head", {"n": 1}), ("head", {"n": 3})]
    assert closed and final["subscribers"] == 0


class _Processor:
    def __init__(self, pending):
        self.pending = pending

    def health_snapshot(self):
        return {"pending": self.pending}


def _admission_run(S):
    cfg = S.ServingConfig(queue_wait_p95_threshold_s=0.5, slot_delay_p95_threshold_s=4.0,
                          pending_limit=100, read_only_factor=2.0, retry_after_s=3)
    health = {}
    proc = _Processor(0)
    ac = S.AdmissionController(cfg, health_source=lambda: dict(health), processor=proc)
    out = []
    for qw, sd, pending in ((None, None, 0), (0.5, None, 0), (1.0, None, 0),
                            (None, 8.0, 0), (None, None, 150), (None, None, 250)):
        health.clear()
        if qw is not None:
            health["queue_wait_p95_seconds"] = qw
        if sd is not None:
            health["slot_delay_p95_seconds"] = sd
        proc.pending = pending
        out.append((ac.pressure(), [ac.admit(lane) for lane in
                                    (S.VALIDATOR, S.READ_ONLY, S.DEBUG)]))
    return out, ac.stats()


def test_admission_sheds_alike():
    port, jax = _admission_run(TS), _admission_run(JS)
    assert port == jax
    runs, stats = port
    assert runs[0] == (0.0, [(True, 0)] * 3)
    assert runs[1] == (1.0, [(True, 0), (True, 0), (False, 3)])
    assert runs[2][1] == [(True, 0), (False, 3), (False, 3)]
    assert stats["shed_read_only"] == 3 and stats["shed_debug"] == 5


def _request(url, method="GET", body=None, headers=None):
    """(status, the headers that matter, body bytes)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            status, got, payload = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, got, payload = e.code, e.headers, e.read()
    return status, {k: got.get(k) for k in ("X-Cache", "ETag", "Retry-After",
                                            "Content-Type")}, payload


def _sse_frames(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
        return r.read().decode()


def _serving_session(harness, node, H, S, M, kwargs):
    """Over HTTP on a 16-validator harness chain: GETs cold, cached and
    revalidated, a shed under pressure, a duty POST, /metrics, and a live
    SSE stream across two blocks. Returns what the client saw and how the
    serving counters moved."""
    h = harness(16, T.MINIMAL if H is TH else J.MINIMAL,
                (T if H is TH else J).ChainSpec.interop(), **kwargs)
    h.extend_chain(2)
    pressure = {}
    tier = S.ServingTier(h.chain, S.ServingConfig(), health_source=lambda: dict(pressure))
    server = H.BeaconApiServer(H.BeaconApi(node(h.chain)), serving=tier)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    names = ("SERVING_CACHE_HITS", "SERVING_CACHE_MISSES", "SERVING_NOT_MODIFIED",
             "SERVING_SHED_READ_ONLY", "SERVING_CACHE_INVALIDATIONS")
    before = [getattr(M, n).value for n in names]
    out = []
    try:
        for path in ("/eth/v1/beacon/headers/head", "/eth/v1/beacon/genesis"):
            cold = _request(base + path)
            hot = _request(base + path)
            out += [cold, hot, _request(base + path,
                                        headers={"If-None-Match": hot[1]["ETag"]})]
        pressure["queue_wait_p95_seconds"] = 10.0
        out.append(_request(base + "/eth/v1/beacon/states/head/fork"))
        out.append(_request(base + "/eth/v1/validator/duties/attester/0", "POST", ["0", "5"]))
        pressure.clear()
        metrics = _request(base + "/metrics")[2].decode()
        frames = []
        reader = threading.Thread(target=lambda: frames.append(_sse_frames(
            base + "/eth/v1/events?topics=block,head&limit=4")))
        reader.start()
        deadline = time.monotonic() + TIMEOUT_S
        while tier.broadcaster.subscriber_count == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        h.extend_chain(2)
        reader.join(TIMEOUT_S)
        out.append(_request(base + "/eth/v1/beacon/headers/head"))  # invalidated by the head
    finally:
        server.stop()
    moved = [getattr(M, n).value - b for n, b in zip(names, before)]
    return out, moved, frames, metrics


def test_cache_304_shedding_and_sse_over_http_alike():
    port = _serving_session(BeaconChainHarness, InProcessBeaconNode, TH, TS, TM,
                            dict(device="cpu"))
    jax = _serving_session(JHarness, JNode, JH, JS, JM, {})
    assert port[:3] == jax[:3]
    out, moved, frames, metrics = port
    assert [(s, h["X-Cache"]) for s, h, _ in out[:6]] == [
        (200, "miss"), (200, "hit"), (304, None)] * 2
    assert out[0][2] == out[1][2] and out[2][2] == b""
    shed, duty = out[6], out[7]
    assert shed[0] == 503 and shed[1]["Retry-After"] == "1" and duty[0] == 200
    assert out[8][1]["X-Cache"] == "miss" and out[8][2] != out[0][2]
    # hits: the two warm GETs and the two conditional ones
    assert moved == [4, 3, 2, 1, moved[4]] and moved[4] >= 1
    kinds = [line.split(": ", 1)[1] for line in frames[0].splitlines()
             if line.startswith("event: ")]
    assert sorted(kinds) == ["block", "block", "head", "head"]
    for name in ("SERVING_CACHE_HITS", "SERVING_SHED_READ_ONLY", "SERVING_COALESCED"):
        assert f"# TYPE {getattr(TM, name).name} " in metrics


def _executor_run(E, M):
    spawned0, panics0 = M.EXECUTOR_TASKS_SPAWNED.value, M.EXECUTOR_TASK_PANICS.value
    ex = E.TaskExecutor("t")
    done = []
    ex.spawn(lambda x: done.append(x), "ok", 7).join(TIMEOUT_S)
    ticks = threading.Event()
    ex.spawn_loop(ticks.set, "tick", 0.001)
    assert ticks.wait(TIMEOUT_S)
    assert not ex.is_shutdown

    def boom():
        raise ValueError("boom")

    ex.spawn(boom, "bad")
    assert ex.wait_shutdown(TIMEOUT_S)
    ex.join_all(TIMEOUT_S)
    with pytest.raises(RuntimeError):
        ex.spawn(lambda: None, "late")
    reason = ex.shutdown_reason()
    return (done, reason.message, reason.failure,
            M.EXECUTOR_TASKS_SPAWNED.value - spawned0, M.EXECUTOR_TASK_PANICS.value - panics0)


def test_task_executor_alike(capsys):
    port, jax = _executor_run(TE, TM), _executor_run(JE, JM)
    assert port == jax == ([7], "task 'bad' failed: boom", True, 3, 1)


def _monitoring_run(Mon, harness, S, kwargs):
    h = harness(16, T.MINIMAL if Mon is TMon else J.MINIMAL,
                (T if Mon is TMon else J).ChainSpec.interop(), **kwargs)
    h.extend_chain(3)
    tier = S.ServingTier(h.chain)
    source = Mon.beacon_node_source(h.chain, serving=tier)
    rig = Mon.MonitoringRig().start()
    try:
        svc = Mon.MonitoringService(rig.url, {"beacon_node": lambda: Mon.beacon_node_source(
            h.chain)}, retries=3, backoff_s=0.001, timeout_s=TIMEOUT_S, clock=lambda: 1234)
        rig.fail_next = 1  # one transient 503, then accepted
        svc.send_once()
        rig.reject_all = True
        with pytest.raises(Mon.MonitoringError, match="HTTP 401"):
            svc.send_once()
    finally:
        rig.stop()
    (record, system), = rig.received
    data = dict(record["data"])
    for k in ("cpu_process_seconds_total", "memory_process_bytes", "process_open_fds"):
        assert isinstance(data.pop(k), (int, float))
    # the health block reads the process's tracer, ledger and histograms,
    # which the tests before this one in the same process fed
    for fields in (source, data):
        assert "ledger" in fields.pop("health")
    return (source, svc.stats, record["sub_type"], record["process"], record["timestamp_s"],
            data, sorted(system["data"]), Mon.VERSION)


def test_monitoring_push_and_beacon_node_source_alike():
    port = _monitoring_run(TMon, BeaconChainHarness, TS, dict(device="cpu"))
    jax = _monitoring_run(JMon, JHarness, JS, {})
    assert port == jax
    source, stats = port[:2]
    assert source["head_slot"] == 3 and source["validator_count"] == 16
    assert "serving" in source and stats == {"sent": 1, "failed": 1}

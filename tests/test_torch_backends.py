"""The port's degradation backends and switches against the JAX package's:
`cpu` gives the JAX cpu oracle's verdicts (honest, forged, shared-message,
infinity cases, at 4 sets or fewer) and weights; `fake` gives JAX fake's
verdicts; `fallback` gives the same breaker transitions, EventLog,
active_backend_name() and metric deltas for the same failure script,
passes `device=` through, and lets a kernel build error reach the caller; `set_backend` knows cpu/fake/fallback/
torch_cuda and refuses jax_tpu; and `_marshal_batch` under
LIGHTHOUSE_TPU_MSG_AGG=0 and LIGHTHOUSE_TPU_KEY_VALIDATE=0 gives the JAX
`_marshal_batch`'s host arrays and grid/None choice.

No test here compiles an XLA program (`no_xla_compile`): the cpu
backends are pure Python, and the JAX marshalling only places arrays."""

import shutil

import numpy as np
import pytest

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import curve_ref as JC
from lighthouse_tpu.crypto.bls.backends import cpu as JCPU
from lighthouse_tpu.crypto.bls.backends import fake as JFAKE
from lighthouse_tpu.crypto.bls.backends import fallback as JFB
from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu.crypto.bls.fields_ref import Fp as JFp
from lighthouse_tpu.resilience import primitives as JR
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls import curve_ref as TC
from lighthouse_tpu_torch.crypto.bls.backends import cpu as TCPU
from lighthouse_tpu_torch.crypto.bls.backends import fake as TFAKE
from lighthouse_tpu_torch.crypto.bls.backends import fallback as TFB
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.crypto.bls.gpu import kernels as TK
from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp as TFp
from lighthouse_tpu_torch.resilience import primitives as TR
from lighthouse_tpu_torch.utils import metrics as TM
from torch_port_util import both, make_signed, no_xla_compile


@pytest.fixture(autouse=True)
def _fresh():
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE,
             JFB._DEFAULT, TFB._DEFAULT)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE,
     JFB._DEFAULT, TFB._DEFAULT) = saved


@pytest.fixture(scope="module")
def signed():
    return make_signed(4, 2)


def _off_subgroup(Fp, Point, C):
    """The first point of E1 (x = 1, 2, ...) outside the r-torsion
    subgroup: on the curve, pairing like its r-torsion part."""
    x = 1
    while True:
        y = (Fp(x) * Fp(x) * Fp(x) + Fp(4)).sqrt()
        if y is not None:
            p = Point(Fp(x), y)
            if C.is_on_g1(p) and not C.g1_subgroup_check(p):
                return p
        x += 1


def _poisoned(jsets, tsets, i):
    """Both packages' sets with set i's key replaced by the same point
    outside the subgroup (constructed directly, not decoded)."""
    jp = _off_subgroup(JFp, JC.Point, JC)
    tp = _off_subgroup(TFp, TC.Point, TC)
    jsets, tsets = list(jsets), list(tsets)
    jsets[i] = japi.SignatureSet.single_pubkey(
        jsets[i].signature, japi.PublicKey(jp), jsets[i].message)
    tsets[i] = tapi.SignatureSet.single_pubkey(
        tsets[i].signature, tapi.PublicKey(tp), tsets[i].message)
    return jsets, tsets


CPU_CASES = {
    "honest": [((0,), 0, None), ((1,), 1, None)],
    "forged": [((0,), 0, None), ((1,), 1, 0)],
    "shared_message": [((0,), 0, None), ((1, 2), 0, None), ((3,), 0, None)],
    "shared_message_forged": [((0,), 0, None), ((1, 2), 0, 1), ((3,), 0, None)],
}


@pytest.mark.parametrize("case", sorted(CPU_CASES) + ["infinity_signature",
                                                       "infinity_pubkey"])
def test_cpu_verdicts_equal_the_jax_oracle(signed, case):
    if case.startswith("infinity"):
        jsets, tsets = both(signed, CPU_CASES["honest"])
        if case == "infinity_signature":
            jsets[1] = japi.SignatureSet(japi.Signature.infinity(),
                                         jsets[1].pubkeys, jsets[1].message)
            tsets[1] = tapi.SignatureSet(tapi.Signature.infinity(),
                                         tsets[1].pubkeys, tsets[1].message)
        else:
            jinf = japi.PublicKey(JC.Point(JFp(0), JFp(0), True))
            tinf = tapi.PublicKey(TC.Point(TFp(0), TFp(0), True))
            jsets[1] = japi.SignatureSet(jsets[1].signature, [jinf], jsets[1].message)
            tsets[1] = tapi.SignatureSet(tsets[1].signature, [tinf], tsets[1].message)
    else:
        jsets, tsets = both(signed, CPU_CASES[case])
    want = JCPU.verify_signature_sets(jsets, seed=5)
    assert TCPU.verify_signature_sets(tsets, seed=5, device="cuda") is want
    assert want is (case in ("honest", "shared_message"))


def test_cpu_weights_and_aggregate_verify_equal_the_jax_oracle(signed):
    assert TCPU._draw_weights(3, 16) == JCPU._draw_weights(3, 16)
    sks, msgs, sig = signed
    jsig = japi.AggregateSignature.aggregate([sig(0, 0), sig(1, 1)]).to_signature()
    jpks = [sks[0].public_key(), sks[1].public_key()]
    tsig = tapi.Signature.from_bytes(jsig.to_bytes())
    tpks = [tapi.PublicKey.from_bytes(pk.to_bytes()) for pk in jpks]
    want = JCPU.aggregate_verify(jsig, jpks, msgs)
    assert want is True
    assert TCPU.aggregate_verify(tsig, tpks, msgs, device="cpu") is want


@pytest.mark.parametrize("spec", [[((0,), 0, None)], [((0,), 0, None), ((), 1, None)]])
def test_fake_verdicts_equal_jax_fake(signed, spec):
    jsets, tsets = both(signed, spec)
    want = JFAKE.verify_signature_sets(jsets)
    assert TFAKE.verify_signature_sets(tsets, seed=1, device="cpu") is want
    assert TFAKE.aggregate_verify(None, [], [], device="cpu") is JFAKE.aggregate_verify(
        None, [], [])


class _Scripted:
    """A backend that fails on the scripted call numbers, else answers."""

    def __init__(self, name, fail_on, log):
        self.name, self.fail_on, self.log, self.n = name, set(fail_on), log, 0

    def verify_signature_sets(self, sets, seed=None, **kw):
        n, self.n = self.n, self.n + 1
        self.log.append((self.name, n, seed, kw.get("device")))
        if n in self.fail_on:
            raise ConnectionError(f"{self.name} call {n} failed")
        return len(sets) % 2 == 1


def _fallback_run(FB, R, M, denied_budget, fail_on, calls=10):
    log = []
    events = R.EventLog()
    breaker = R.CircuitBreaker(failure_threshold=1, denied_budget=denied_budget,
                               half_open_probes=1, name="bls_primary",
                               events=events)
    fb = FB.FallbackBackend(primary=_Scripted("primary", fail_on, log),
                            fallback=_Scripted("fallback", (), log),
                            breaker=breaker, events=events)
    before = M.BLS_FALLBACK_EVENTS.value, M.BREAKER_TRANSITIONS.value
    out, names = [], []
    for i in range(calls):
        out.append(fb.verify_signature_sets([None] * (1 + i % 2), seed=i))
        names.append(fb.active_backend_name())
    return dict(out=out, names=names, events=events.events,
                transitions=breaker.transitions,
                log=[entry[:3] for entry in log],
                fallback_total=M.BLS_FALLBACK_EVENTS.value - before[0],
                breaker_total=M.BREAKER_TRANSITIONS.value - before[1],
                using=M.BLS_USING_FALLBACK.value)


@pytest.mark.parametrize("denied_budget, fail_on", [
    (2, (0,)), (1, (0, 1, 2)), (3, (0, 2, 5))])
def test_fallback_same_breaker_events_and_switches(denied_budget, fail_on):
    want = _fallback_run(JFB, JR, JM, denied_budget, fail_on)
    got = _fallback_run(TFB, TR, TM, denied_budget, fail_on)
    names = {"jax_tpu": "torch_cuda"}  # the primaries' names
    assert got["names"] == [names.get(n, n) for n in want.pop("names")]
    got.pop("names")
    assert got == want
    assert want["fallback_total"] == len(fail_on)


def test_fallback_defaults_and_device_passthrough():
    fb = TFB.FallbackBackend()
    assert fb.primary_name == "torch_cuda" and fb.fallback_name == "cpu"
    assert fb.primary_backend() is TB and fb.fallback_backend() is TCPU
    assert fb.active_backend_name() == "torch_cuda"
    log = []
    TFB.configure(primary=_Scripted("primary", (0,), log),
                  fallback=_Scripted("fallback", (), log))
    tapi.set_backend("fallback", device="cpu")
    assert tapi.verify_signature_sets([None], seed=4) is True
    assert log == [("primary", 0, 4, "cpu"), ("fallback", 0, 4, "cpu")]
    assert TFB.get_default().active_backend_name() == "cpu"


@pytest.mark.parametrize("fault", ["nvcc_fails", "library_unloadable"])
def test_fallback_lets_a_kernel_build_error_through(monkeypatch, tmp_path, fault):
    """A primary whose kernels fail to build (nvcc exits non-zero) or to
    load (a library the loader refuses): the KernelBuildError reaches the
    caller, the oracle never runs, and the breaker, the fallback counter
    and the EventLog stay as they were."""
    monkeypatch.setattr(TK, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(TK, "_libs", {})
    monkeypatch.setattr(TK, "_nvcc", lambda: shutil.which("false"))
    if fault == "library_unloadable":
        out_dir = tmp_path / TK._source_hash()
        out_dir.mkdir()
        for name in TK.LIBS:
            (out_dir / f"lib{name}.so").write_bytes(b"not a library")

    class Building:
        def verify_signature_sets(self, sets, seed=None, device=None):
            TK.build()
            return True

    log, events = [], TR.EventLog()
    fb = TFB.FallbackBackend(primary=Building(),
                             fallback=_Scripted("fallback", (), log),
                             events=events)
    before = TM.BLS_FALLBACK_EVENTS.value
    with pytest.raises(TK.KernelBuildError):
        fb.verify_signature_sets([None], seed=1)
    assert log == [] and events.events == []
    assert TM.BLS_FALLBACK_EVENTS.value == before
    assert fb.breaker.state == TR.CircuitBreaker.CLOSED
    assert fb.active_backend_name() == "torch_cuda"
    assert TK._libs == {}


def test_set_backend_names_and_the_environment_default(monkeypatch):
    for name, mod in (("cpu", TCPU), ("fake", TFAKE), ("fallback", TFB),
                      ("torch_cuda", TB)):
        tapi.set_backend(name)
        assert tapi._BACKEND is mod and tapi.get_backend_name() == name
    for name in ("jax_tpu", "blst"):
        with pytest.raises(tapi.BlsError, match="unknown BLS backend"):
            tapi.set_backend(name)
    tapi._BACKEND = None
    monkeypatch.setenv("LIGHTHOUSE_TPU_BLS_BACKEND", "fake")
    assert tapi.get_backend_name() == "fake"
    tapi._BACKEND = None
    monkeypatch.delenv("LIGHTHOUSE_TPU_BLS_BACKEND")
    assert tapi.get_backend_name() == "torch_cuda"


def test_breaker_same_transitions_on_a_clock():
    """A clocked breaker (reset timeout, no denied budget): the same
    allow/transition sequence in both packages."""
    runs = []
    for R in (JR, TR):
        clock, events = R.VirtualClock(), R.EventLog()
        b = R.CircuitBreaker(clock=clock, failure_threshold=2, reset_timeout_s=5,
                             denied_budget=None, events=events, name="b")
        seen = []
        for step, ok in enumerate([False, False, None, None, True, False, None, True]):
            clock.advance(2)
            allowed = b.allow()
            seen.append((allowed, b.state))
            if allowed and ok is not None:
                b.record_success() if ok else b.record_failure()
        with pytest.raises(R.BreakerOpen):
            b._reopen(), b.call(lambda: 1)
        runs.append((seen, events.events, b.transitions))
    assert runs[0] == runs[1]


# --- the switches: host arrays of _marshal_batch ----------------------------

SWITCH_SPEC = [((0,), 0, None), ((1,), 1, None), ((2,), 0, None),
               ((3,), 1, None), ((0, 1), 0, None)]  # 5 sets, 2 messages


def _host(mb, names=("u", "h_idx", "pk", "sig", "scalars", "real",
                     "grid_idx", "grid_real")):
    return {k: None if getattr(mb, k) is None else np.asarray(getattr(mb, k))
            for k in names}


@pytest.mark.parametrize("msg_agg", ["1", "0"])
def test_msg_agg_switch_marshals_like_jax(signed, monkeypatch, msg_agg):
    """5 sets over 2 messages: n_b 8 > m_b 4, so the grid is built with
    message aggregation on and not with it off; the numpy limbs are equal
    either way."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_MSG_AGG", msg_agg)
    jsets, tsets = both(signed, SWITCH_SPEC)
    jm = jax_tpu._marshal_batch(jsets, seed=8)
    tm = TB._marshal_batch(tsets, "cpu", seed=8)
    want, got = _host(jm), _host(tm)
    assert (want["grid_idx"] is None) == (msg_agg == "0")
    for k in want:
        assert (got[k] is None) == (want[k] is None), k
        if want[k] is not None:
            np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype))


@pytest.mark.parametrize("key_validate", ["1", "0"])
def test_key_validate_switch_marshals_like_jax(signed, monkeypatch, key_validate):
    """A key outside the subgroup: marshalling refuses the batch with
    key_validate on and packs it with the switch off, in both packages;
    the pubkey table import follows the same switch."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_KEY_VALIDATE", key_validate)
    jsets, tsets = _poisoned(*both(signed, SWITCH_SPEC[:3]), 1)
    jm = jax_tpu._marshal_batch(jsets, seed=9)
    tm = TB._marshal_batch(tsets, "cpu", seed=9)
    assert (jm is None) == (tm is None) == (key_validate == "1")
    if tm is not None:
        want, got = _host(jm), _host(tm)
        for k in want:
            if want[k] is not None:
                np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype))
    table = TB.PubkeyTable("cpu")
    if key_validate == "1":
        with pytest.raises(tapi.BlsError, match="key_validate"):
            table.import_new_pubkeys(tsets[1].pubkeys)
    else:
        table.import_new_pubkeys(tsets[1].pubkeys)
        assert len(table) == 1
    assert tapi.key_validate_enabled() is japi.key_validate_enabled()

"""The port's speculation subsystem (lighthouse_tpu_torch/speculate/) and
the adversary's speculation-poisoning audit against the JAX package's on
the CPU, with exact equality:

- `attach_speculation` over both packages' BeaconChain (MINIMAL altair
  genesis, 64 validators) precomputes the same committee entries (members
  and full-aggregate key bytes) under the same shuffling keys;
- `process_indexed_set` over the same gossip aggregates (partial bits:
  incremental corrections) swaps in the same aggregate keys; the idle
  pass pre-verifies the same next-slot claims into the same memo; arriving
  full aggregates are confirmed by lookup or counted as mismatches alike;
  a stale shuffling key invalidates alike; the stats and the SPECULATE_*
  families move by the same amounts;
- the aggregates batch gives the same verdicts with speculation on and
  off, on the cpu oracle and on a fake backend that fails the forged
  item's batches (the same bisection calls);
- the port's device correction (`torch_cuda.correct_aggregate_device`,
  run on CPU tensors) gives the same corrected points (affine ints) as
  the JAX package's host arithmetic;
- on the torch_cuda backend a device correction that raises, or a
  committee table that cannot be filled, raises: no host fallback;
- `adversary.audit(["speculation-poisoning"])` reports nothing on both,
  and the same violations against a planted weak confirm.

On the card (`gpu`): the corrections on torch_cuda, the committee table
there, equal the JAX host arithmetic. No XLA compile."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.chain import BeaconChain as JBeaconChain
from lighthouse_tpu.chain import attestation_verification as JAV
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import adversary as JA
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import fake as JFAKE
from lighthouse_tpu.pool import observed as JO
from lighthouse_tpu.speculate import attach_speculation as jattach
from lighthouse_tpu.speculate import precompute as JPRE
from lighthouse_tpu.speculate import scheduler as JSCHED
from lighthouse_tpu.state_transition import signature_sets as JSS
from lighthouse_tpu.store.hot_cold import HotColdDB as JHotColdDB
from lighthouse_tpu.store.kv import MemoryStore as JMemoryStore
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain import BeaconChain
from lighthouse_tpu_torch.chain import attestation_verification as TAV
from lighthouse_tpu_torch.crypto.bls import adversary as TA
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import fake as TFAKE
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.pool import observed as TO
from lighthouse_tpu_torch.speculate import attach_speculation as tattach
from lighthouse_tpu_torch.speculate import precompute as TPRE
from lighthouse_tpu_torch.speculate import scheduler as TSCHED
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from lighthouse_tpu_torch.store.hot_cold import HotColdDB
from lighthouse_tpu_torch.store.kv import MemoryStore
from lighthouse_tpu_torch.utils import metrics as TM
from torch_port_util import jax_keys_from_port, need_card, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

JSPEC = J.ChainSpec.interop(altair_fork_epoch=0)
TSPEC = T.ChainSpec.interop(altair_fork_epoch=0)
PKG = {"jax": (JAV, JO, JM, japi, JFAKE, jattach), "torch": (TAV, TO, TM, tapi, TFAKE, tattach)}
FAMILIES = ("SPECULATE_PRECOMPUTE_ENTRIES", "SPECULATE_PRECOMPUTE_HITS",
            "SPECULATE_PRECOMPUTE_CORRECTIONS", "SPECULATE_PRECOMPUTE_MISSES",
            "SPECULATE_PRECOMPUTE_INVALIDATIONS", "SPECULATE_PREVERIFIED",
            "SPECULATE_CONFIRMS", "SPECULATE_CONFIRM_MISSES", "SPECULATE_MISMATCHES",
            "SPECULATE_IDLE_RUNS")


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


@pytest.fixture(scope="module")
def world():
    """MINIMAL altair genesis (64 validators, committees of 4); a copy at
    slot 3; 4 gossip aggregates of slots 1-2 (each committee's k-th
    aggregate drops member k), the second with its aggregate-and-proof
    forged; a signature source that signs with the interop keys (shared
    by both packages: the same bytes)."""
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        jax_keys_from_port(mp)
        C = CS.consensus_modules()
        host = CS.HostCrypto()
        genesis = T.interop_genesis_state(64, T.MINIMAL, TSPEC)
        state = TPS.process_slots(TPS.clone_state(genesis), 3, T.MINIMAL, TSPEC)

        def secret_of(i):
            return T.interop_secret_key(i).scalar

        aggs = CS.gossip_aggregates(C, state, T.MINIMAL, TSPEC, secret_of, 4, host)
        aggs = CS.forge_gossip(C, state, T.MINIMAL, TSPEC, secret_of, aggs, (1,), host)
        signed = []

        def source(data, members, root):
            signed.append(bytes(root))
            return host.sign([([secret_of(v) for v in members], root)])[0]

        return SimpleNamespace(C=C, genesis=genesis, state=state, aggs=aggs, host=host,
                               secret_of=secret_of, source=source, signed=signed)


def _chain(pkg, world):
    if pkg == "torch":
        return BeaconChain(HotColdDB(MemoryStore(), T.MINIMAL, TSPEC), world.genesis,
                           T.MINIMAL, TSPEC, device="cpu")
    return JBeaconChain(JHotColdDB(JMemoryStore(), J.MINIMAL, JSPEC),
                        J.decode_state_any_fork(world.genesis.as_ssz_bytes(), J.MINIMAL),
                        J.MINIMAL, JSPEC)


def _items(pkg, world, items):
    if pkg == "torch":
        return items
    t = J.types_for(J.MINIMAL)
    return [getattr(t, type(x).__name__).from_ssz_bytes(x.as_ssz_bytes()) for x in items]


def _state(pkg, world):
    if pkg == "torch":
        return world.state
    return J.decode_state_any_fork(world.state.as_ssz_bytes(), J.MINIMAL)


def _entries(sub):
    return sorted((e, slot, index, entry.members, entry.full_pk.to_bytes(), entry.shuffling_key)
                  for e, es in sub.precompute._epochs.items()
                  for (slot, index), entry in es.items())


def _swap_view(out, ind):
    if out is None:
        return "confirmed"
    if out is ind:
        return "unchanged"
    return ("swapped", [k.to_bytes() for k in out.pubkeys], bytes(out.message),
            out.signature.to_bytes())


def _lifecycle(pkg, world):
    AV, O, M, api, _, attach = PKG[pkg]
    before = [getattr(M, n).value for n in FAMILIES]
    chain = _chain(pkg, world)
    chain.slot_clock.set_slot(1)
    sub = attach(chain, signature_source=world.source)
    entries = _entries(sub)
    state = _state(pkg, world)
    ctxt = (AV.ConsensusContext(J.MINIMAL, JSPEC) if pkg == "jax"
            else AV.ConsensusContext(T.MINIMAL, TSPEC))
    swaps = []
    for agg in _items(pkg, world, world.aggs):
        att = agg.message.aggregate
        indexed = ctxt.get_indexed_attestation(state, att)
        ind = AV.indexed_attestation_signature_set(
            state, chain.pubkey_cache.getter(state), indexed, chain.preset, chain.spec)
        swaps.append(_swap_view(sub.process_indexed_set(state, att, indexed, ind), ind))
    # the idle pass for slot 2, then arrivals: the expected full aggregate,
    # and the same claim under another signature
    written = sub.verifier.speculate_slot(2)
    memo = sorted(sub.verifier._memo.items())
    arrivals = []
    t = J.types_for(J.MINIMAL) if pkg == "jax" else T.types_for(T.MINIMAL)
    head_state = chain.head_state
    for index, sig in ((0, None), (1, b"other")):
        data = chain.produce_attestation_data(2, index)
        committee = ctxt.committee_cache(head_state, 0).get_beacon_committee(2, index)
        root = CS.attester_root(world.C, world.state, _port(data), T.MINIMAL)
        good = world.source(data, committee, root)
        signature = good if sig is None else bytes(
            tapi.AggregateSignature.aggregate(
                [tapi.Signature.from_bytes(good), tapi.Signature.from_bytes(good)]
            ).to_bytes())
        att = t.Attestation(aggregation_bits=tuple(True for _ in committee), data=data,
                            signature=signature)
        indexed = ctxt.get_indexed_attestation(head_state, att)
        ind = AV.indexed_attestation_signature_set(
            head_state, chain.pubkey_cache.getter(head_state), indexed, chain.preset,
            chain.spec)
        arrivals.append(_swap_view(
            sub.process_indexed_set(head_state, att, indexed, ind), ind))
    # a stale shuffling key: the head event drops the epoch and refreshes it
    sub.precompute._keys[0] = b"stale"
    sub.on_event("head", {})
    stale = sub.precompute.stats["invalidations"]
    sub.detach()
    after = [getattr(M, n).value for n in FAMILIES]
    return dict(entries=entries, swaps=swaps, written=written, memo=memo,
                arrivals=arrivals, confirmed=len(sub.confirmed_roots), stale=stale,
                precompute=dict(sub.precompute.stats), verifier=dict(sub.verifier.stats),
                # the entries gauge as it stands, the counters as they moved
                metrics=[after[0]] + [a - b for a, b in zip(after[1:], before[1:])],
                detached=chain.speculation is None)


def _port(data):
    """A JAX AttestationData as the port's (the chip_smoke helpers take the
    port's)."""
    if type(data).__module__.startswith("lighthouse_tpu_torch"):
        return data
    return T.AttestationData.from_ssz_bytes(data.as_ssz_bytes())


def test_speculation_lifecycle_equals_jax(world):
    got = _lifecycle("torch", world)
    assert got == _lifecycle("jax", world)
    assert len(got["entries"]) == 2 * 8 * 2  # two epochs, 2 committees a slot
    assert all(s[0] == "swapped" and len(s[1]) == 1 for s in got["swaps"])
    assert got["written"] == 2 and got["arrivals"][0] == "confirmed"
    assert got["arrivals"][1] != "confirmed" and got["verifier"]["mismatches"] == 1
    assert got["stale"] > 0 and got["detached"]


def _verdicts(pkg, world, backend, speculation, monkeypatch):
    AV, O, M, api, FAKE, attach = PKG[pkg]
    if backend == "marked":
        forged = bytes(world.aggs[1].signature)
        monkeypatch.setattr(FAKE, "verify_signature_sets", lambda sets, *a, **kw: not any(
            s.signature.to_bytes() == forged for s in sets))
        api.set_backend("fake")
    else:
        api.set_backend(backend)
    chain = _chain(pkg, world)
    state = _state(pkg, world)
    view = SimpleNamespace(current_slot=3, preset=chain.preset, spec=chain.spec,
                           head_state=state, _states=chain._states,
                           pubkey_cache=chain.pubkey_cache, speculation=None)
    for r in state.block_roots:
        view._states[bytes(r)] = state
    if speculation:
        chain.slot_clock.set_slot(1)
        view.speculation = attach(chain)
    items = _items(pkg, world, world.aggs[:1] if backend == "cpu" else world.aggs)
    calls0 = M.BLS_BISECTION_CALLS.value
    verified, rejected = AV.batch_verify_aggregates(
        view, items, O.ObservedAggregates(), O.ObservedAggregators())
    return ([v.signed_aggregate.tree_hash_root() for v in verified],
            [(a.tree_hash_root(), why) for a, why in rejected],
            M.BLS_BISECTION_CALLS.value - calls0)


@pytest.mark.parametrize("backend", ["marked", "cpu"])
def test_aggregates_same_verdicts_with_speculation_on_and_off(world, backend, monkeypatch):
    """The swapped committee keys change no verdict, on both packages,
    with speculation on and off: on the marked fake backend the forged
    item alone is rejected (the same bisection calls); on the cpu oracle
    the honest aggregate verifies with its corrected committee key."""
    got = {(pkg, on): _verdicts(pkg, world, backend, on, monkeypatch)
           for pkg in ("torch", "jax") for on in (False, True)}
    assert len(set(map(repr, got.values()))) == 1
    verified, rejected, calls = got["torch", True]
    if backend == "cpu":
        assert len(verified) == 1 and not rejected and calls == 0
    else:
        assert rejected == [(world.aggs[1].tree_hash_root(), "invalid signature")]
        assert len(verified) == 3 and calls > 0


def test_device_correction_equals_the_jax_host_arithmetic(world):
    """Corrections for 1, 2 and 3 absent members of a committee of 4: the
    port's on torch_cuda (CPU tensors) and the JAX package's host sums
    give the same affine points, and the host path of the port too."""
    jstate = _state("jax", world)
    jpre = JPRE.CommitteePrecompute(J.MINIMAL, JSPEC, device_correction=False)
    jpre.refresh_epoch(jstate, 0, JAV.ConsensusContext(J.MINIMAL, JSPEC),
                       JSS.state_pubkey_getter(jstate))
    cache = world.C.pubkey_cache.ValidatorPubkeyCache(world.state, device="cpu")
    points = {}
    for name, backend, correction in (("device", "torch_cuda", True),
                                      ("host", "fake", False)):
        tapi.set_backend(backend, device="cpu")
        pre = TPRE.CommitteePrecompute(T.MINIMAL, TSPEC, device_correction=correction)
        pre.refresh_epoch(world.state, 0, TAV.ConsensusContext(T.MINIMAL, TSPEC),
                          cache.getter(world.state))
        entry = pre._epochs[0][(2, 1)]
        points[name] = [CS.affine(pre.aggregate_pubkey(entry, bits).point)
                        for bits in ((False, True, True, True), (True, False, False, True),
                                     (False, False, True, False))]
    jentry = jpre._epochs[0][(2, 1)]
    want = [(p.point.x.n, p.point.y.n) for p in (
        jpre.aggregate_pubkey(jentry, bits) for bits in (
            (False, True, True, True), (True, False, False, True),
            (False, False, True, False)))]
    assert points["device"] == points["host"] == want


def test_device_failures_raise_on_torch_cuda(world, monkeypatch):
    """No hidden host fallback: with torch_cuda selected a failing device
    correction, or a failing committee-table upload, reaches the caller;
    on the cpu backend, or with the correction off, the host sums run."""
    cache = world.C.pubkey_cache.ValidatorPubkeyCache(world.state, device="cpu")
    ctxt = TAV.ConsensusContext(T.MINIMAL, TSPEC)

    def boom(*a, **kw):
        raise RuntimeError("device correction failed")

    monkeypatch.setattr(TB, "correct_aggregate_device", boom)
    tapi.set_backend("torch_cuda", device="cpu")
    pre = TPRE.CommitteePrecompute(T.MINIMAL, TSPEC, device_correction=True)
    pre.refresh_epoch(world.state, 0, ctxt, cache.getter(world.state))
    entry = pre._epochs[0][(2, 0)]
    with pytest.raises(RuntimeError, match="device correction failed"):
        pre._corrected_point(entry, entry.member_pks[:1])
    with monkeypatch.context() as mp:  # the switch off: the host sums, no call
        mp.setenv("LIGHTHOUSE_TPU_SPECULATE_DEVICE", "0")
        off = TPRE.CommitteePrecompute(T.MINIMAL, TSPEC)
        assert off._corrected_point(entry, entry.member_pks[:1]) is not None
    tapi.set_backend("cpu")
    assert pre._corrected_point(entry, entry.member_pks[:1]) is not None
    tapi.set_backend("fallback", device="cpu")
    with pytest.raises(RuntimeError, match="device correction failed"):
        pre._corrected_point(entry, entry.member_pks[:1])
    monkeypatch.setattr(TB, "set_committee_aggregates", boom)
    fresh = TPRE.CommitteePrecompute(T.MINIMAL, TSPEC)
    with pytest.raises(RuntimeError, match="device correction failed"):
        fresh.refresh_epoch(world.state, 0, ctxt, cache.getter(world.state))


def test_committee_table_filled_on_torch_cuda(world):
    """On torch_cuda the refresh parks every full aggregate in the
    committee table on the backend's device."""
    tapi.set_backend("torch_cuda", device="cpu")
    cache = world.C.pubkey_cache.ValidatorPubkeyCache(world.state, device="cpu")
    pre = TPRE.CommitteePrecompute(T.MINIMAL, TSPEC)
    assert pre.refresh_epoch(world.state, 0, TAV.ConsensusContext(T.MINIMAL, TSPEC),
                             cache.getter(world.state)) == 16
    table = TB.committee_table()
    assert len(table) == 16 and table.device_table().device.type == "cpu"


def _audit(A, SCHED, weak, monkeypatch):
    if weak:
        monkeypatch.setattr(SCHED.SpeculativeVerifier, "confirm",
                            lambda self, *a, **kw: True)
    return A.audit(["speculation-poisoning"], seed=1)


@pytest.mark.parametrize("weak", [False, True])
def test_speculation_poisoning_audit_equals_jax(weak, monkeypatch):
    got = _audit(TA, TSCHED, weak, monkeypatch)
    assert got == _audit(JA, JSCHED, weak, monkeypatch)
    assert (len(got) == 3) if weak else (got == [])


def test_idle_gate_refuses_a_busy_processor():
    for SCHED in (TSCHED, JSCHED):
        v = SCHED.SpeculativeVerifier(chain=None, precompute=None)
        for busy, want in (({"pending": 3, "deferred": 0, "busy_workers": 0}, False),
                           ({"pending": 0, "deferred": 1, "busy_workers": 0}, False),
                           ({"pending": 0, "deferred": 0, "busy_workers": 0}, True)):
            proc = SimpleNamespace(health_snapshot=lambda busy=busy: busy)
            assert v.should_run(proc) is want


@pytest.mark.gpu
def test_device_correction_on_the_card_equals_the_jax_host_arithmetic(world):
    need_card()
    jstate = _state("jax", world)
    jpre = JPRE.CommitteePrecompute(J.MINIMAL, JSPEC, device_correction=False)
    jpre.refresh_epoch(jstate, 0, JAV.ConsensusContext(J.MINIMAL, JSPEC),
                       JSS.state_pubkey_getter(jstate))
    tapi.set_backend("torch_cuda")
    cache = world.C.pubkey_cache.ValidatorPubkeyCache(world.state, device="cpu")
    pre = TPRE.CommitteePrecompute(T.MINIMAL, TSPEC, device_correction=True)
    pre.refresh_epoch(world.state, 0, TAV.ConsensusContext(T.MINIMAL, TSPEC),
                      cache.getter(world.state))
    assert TB.committee_table().device_table().device.type == "cuda"
    for slot, index in ((0, 0), (1, 1), (2, 1)):
        for bits in ((False, True, True, True), (True, False, False, True)):
            got = pre.aggregate_pubkey(pre._epochs[0][(slot, index)], bits).point
            want = jpre.aggregate_pubkey(jpre._epochs[0][(slot, index)], bits).point
            assert (got.x.n, got.y.n) == (want.x.n, want.y.n)

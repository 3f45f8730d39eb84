"""The port's gossip attestation verification, bisection and beacon
processor (lighthouse_tpu_torch/chain/attestation_verification.py,
processor/beacon_processor.py, pool/observed.py) against the JAX
package's on the CPU:

- `bisect_batch_failures` over the planted-forgery cases of
  tests/test_bls_pipeline.py: the same sub-batches checked in the same
  order, the same good and bad items, within k (ceil(log2 n) + 1) calls;
- the BeaconProcessor's deferred-work cases of the same file, and its
  priority, LIFO/FIFO and load-shedding order, give the same logs;
- `batch_verify_unaggregated` / `batch_verify_aggregates` over a duck
  chain (a MINIMAL interop state at slot 3, 64 validators) give the same
  (verified, rejected) lists on both packages' `fake` and `cpu`
  backends, with the same bisection call counts; the items are built by
  chip_smoke.py's gossip builders on the port and reach the JAX side as
  SSZ bytes.

No XLA compile."""

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.chain import attestation_verification as JAV
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.pool import observed as JO
from lighthouse_tpu.processor import beacon_processor as JBP
from lighthouse_tpu.state_transition import signature_sets as JSS
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain import attestation_verification as TAV
from lighthouse_tpu_torch.chain.pubkey_cache import ValidatorPubkeyCache
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.pool import observed as TO
from lighthouse_tpu_torch.processor import beacon_processor as TBP
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from lighthouse_tpu_torch.utils import metrics as TM
from torch_port_util import jax_keys_from_port, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

PKG = {"jax": (JAV, JBP, JM, JO), "torch": (TAV, TBP, TM, TO)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    jax_keys_from_port(monkeypatch)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


# --- bisection ---------------------------------------------------------------


def _bisect(pkg, n, bad_idx):
    AV, _, M, _ = PKG[pkg]
    items = [SimpleNamespace(i=i, bad=(i in bad_idx)) for i in range(n)]
    checked = []

    def verify(sets):
        checked.append([s.i for s in sets])
        return not any(s.bad for s in sets)

    calls0, bad0 = M.BLS_BISECTION_CALLS.value, M.BLS_BISECTION_BAD_ITEMS.value
    ok, bad = AV.bisect_batch_failures(items, lambda it: [it], verify)
    assert M.BLS_BISECTION_CALLS.value - calls0 == len(checked)
    assert M.BLS_BISECTION_BAD_ITEMS.value - bad0 == len(bad)
    return [x.i for x in ok], [x.i for x in bad], checked


@pytest.mark.parametrize("n, bad_idx", [
    (1024, [0]), (1024, [17]), (1024, [511]), (1024, [512]), (1024, [1023]),
    (1024, [3, 700]), (1024, [1, 2, 3, 4]), (256, [250, 251]), (7, [2]),
    (2, [0, 1]), (16, list(range(16))), (1, [0]),
])
def test_bisection_equals_jax(n, bad_idx):
    ok, bad, checked = _bisect("torch", n, bad_idx)
    assert (ok, bad, checked) == _bisect("jax", n, bad_idx)
    assert sorted(bad) == sorted(bad_idx)
    assert sorted(ok) == sorted(set(range(n)) - set(bad_idx))
    assert len(checked) <= CS.bisection_bound(len(bad_idx), n)
    if n > 1:
        assert CS.bisection_bound(len(bad_idx), n) == len(bad_idx) * (
            math.ceil(math.log2(n)) + 1)


# --- beacon processor ---------------------------------------------------------


def _deferred_handler(BP, log, ready):
    def handler(items):
        n = len(items)
        batch = len([e for e in log if e[0] == "submit"])
        log.append(("submit", batch, n))
        return BP.DeferredWork(done=lambda: ready(),
                               complete=lambda: log.append(("complete", batch, n)))
    return handler


def _ordered(pkg, max_batch, items):
    """Never-done deferred batches: completions forced in submit order."""
    BP = PKG[pkg][1]
    log = []
    bp = BP.BeaconProcessor(
        handlers={"gossip_attestation": _deferred_handler(BP, log, lambda: False)},
        max_batch=max_batch, max_inflight=2)
    for i in range(items):
        bp.submit("gossip_attestation", i)
    bp.run_until_idle()
    return log, bp.processed["gossip_attestation"]


@pytest.mark.parametrize("max_batch, items", [(4, 12), (2, 10)])
def test_processor_deferred_completions_equal_jax(max_batch, items):
    """test_completions_resolve_in_submit_order and
    test_max_inflight_bounds_overlap: FIFO completions, none lost, at most
    max_inflight (2) batches in flight."""
    log, processed = _ordered("torch", max_batch, items)
    assert (log, processed) == _ordered("jax", max_batch, items)
    submits = [e[1] for e in log if e[0] == "submit"]
    assert [e[1] for e in log if e[0] == "complete"] == submits == sorted(submits)
    inflight = peak = 0
    for e in log:
        inflight += 1 if e[0] == "submit" else -1
        peak = max(peak, inflight)
    assert peak == 2 and processed == items


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_processor_worker_pool_drains_deferred(pkg):
    BP = PKG[pkg][1]
    log = []
    bp = BP.BeaconProcessor(
        handlers={"gossip_attestation": _deferred_handler(BP, log, lambda: True)},
        max_batch=4, max_workers=2)
    bp.start()
    try:
        for i in range(8):
            bp.submit("gossip_attestation", i)
        assert bp.wait_idle(5.0)
    finally:
        bp.stop()
    assert bp.processed["gossip_attestation"] == 8
    assert [e[1] for e in log if e[0] == "complete"] == [0, 1]


def _poisoned(pkg):
    BP = PKG[pkg][1]

    def handler(items):
        return BP.DeferredWork(done=lambda: True, complete=lambda: (_ for _ in ()).throw(
            ValueError("poisoned completion")))

    bp = BP.BeaconProcessor(handlers={"gossip_attestation": handler})
    bp.submit("gossip_attestation", "a")
    bp.run_until_idle()
    return bp.handler_errors, bp.last_error, bp.processed["gossip_attestation"]


def test_processor_failing_completion_counted_not_fatal():
    errors, last, processed = _poisoned("torch")
    assert (errors, last, processed) == _poisoned("jax")
    assert errors["gossip_attestation"] == 1 and "poisoned completion" in last
    assert processed == 1


def _journal(pkg):
    """Mixed queues in reverse priority, small caps: the claim order, the
    LIFO attestation batch, the FIFO aggregate batch and the shedding."""
    BP = PKG[pkg][1]
    seen = []
    names = ("api_request", "gossip_attestation", "gossip_aggregate", "gossip_block")
    handlers = {n: (lambda n: lambda x: seen.append((n, x)))(n) for n in names}
    bp = BP.BeaconProcessor(handlers=handlers, max_batch=3, journal=True)
    bp.queues["gossip_attestation"].max_len = 4
    bp.queues["gossip_aggregate"].max_len = 2
    accepted = []
    for i in range(6):
        for n in names:
            accepted.append(bp.submit(n, (n, i)))
    bp.run_until_idle()
    dropped = {n: q.dropped for n, q in bp.queues.items()}
    return seen, bp.journal, accepted, dropped, dict(bp.processed)


def test_processor_priority_and_queue_order_equal_jax():
    seen, journal, accepted, dropped, processed = _journal("torch")
    assert (seen, journal, accepted, dropped, processed) == _journal("jax")
    assert journal[0][0] == "gossip_block"
    assert dropped["gossip_attestation"] == 2 and dropped["gossip_aggregate"] == 4


# --- gossip batches over a duck chain ---------------------------------------------


@pytest.fixture(scope="module")
def gossip():
    """The port's MINIMAL interop state at slot 3 (64 validators) and the
    JAX one decoded from its bytes; 4 unaggregated attestations of slot 2
    (the third signed over a wrong root), a duplicate of the first and a
    two-bit one; 2 aggregates (the second's aggregate-and-proof signature
    over a wrong root) and a duplicate of the first. Each list as
    (port items, JAX items)."""
    C = CS.consensus_modules()
    host = CS.HostCrypto()
    preset, spec = T.MINIMAL, T.ChainSpec.interop()
    state = T.interop_genesis_state(64, preset, spec)
    state = TPS.process_slots(state, 3, preset, spec)

    def secret_of(i):
        return T.interop_secret_key(i).scalar

    un = CS.gossip_unaggregated(C, state, preset, spec, secret_of, 2, 4, host)
    un = CS.forge_gossip(C, state, preset, spec, secret_of, un, (2,), host)
    un.append(un[0])
    two = type(un[1]).from_ssz_bytes(un[1].as_ssz_bytes())
    two.aggregation_bits = tuple(True for _ in two.aggregation_bits[:2]) + tuple(
        two.aggregation_bits[2:])
    un.append(two)
    ag = CS.gossip_aggregates(C, state, preset, spec, secret_of, 2, host)
    ag = CS.forge_gossip(C, state, preset, spec, secret_of, ag, (1,), host)
    ag.append(ag[0])
    jt = J.types_for(J.MINIMAL)
    return dict(
        state=(state, J.decode_state_any_fork(state.as_ssz_bytes(), J.MINIMAL)),
        unaggregated=(un, [jt.Attestation.from_ssz_bytes(a.as_ssz_bytes()) for a in un]),
        aggregates=(ag, [jt.SignedAggregateAndProof.from_ssz_bytes(a.as_ssz_bytes())
                         for a in ag]),
    )


def _chain(pkg, state):
    if pkg == "torch":
        cache = ValidatorPubkeyCache(state, device="cpu")
        preset, spec = T.MINIMAL, T.ChainSpec.interop()
    else:
        cache = SimpleNamespace(getter=JSS.state_pubkey_getter)
        preset, spec = J.MINIMAL, J.ChainSpec.interop()
    return SimpleNamespace(
        current_slot=3, preset=preset, spec=spec, head_state=state,
        _states={bytes(r): state for r in state.block_roots},
        pubkey_cache=cache, validator_monitor=None)


def _run(pkg, gossip, backend):
    AV, _, M, O = PKG[pkg]
    (japi if pkg == "jax" else tapi).set_backend(backend)
    i = 0 if pkg == "torch" else 1
    state = gossip["state"][i]
    chain = _chain(pkg, state)
    out = {}
    for name, items in (("unaggregated", gossip["unaggregated"][i]),
                        ("aggregates", gossip["aggregates"][i])):
        calls0 = M.BLS_BISECTION_CALLS.value
        if name == "unaggregated":
            verified, rejected = AV.batch_verify_unaggregated(
                chain, items, O.ObservedAttesters())
            got = [(v.attestation.tree_hash_root(), v.attester_index,
                    list(v.indexed_indices)) for v in verified]
        else:
            verified, rejected = AV.batch_verify_aggregates(
                chain, items, O.ObservedAggregates(), O.ObservedAggregators())
            got = [(v.signed_aggregate.tree_hash_root(), list(v.indexed_indices))
                   for v in verified]
        out[name] = (got, [(a.tree_hash_root(), why) for a, why in rejected],
                     M.BLS_BISECTION_CALLS.value - calls0)
    return out


@pytest.mark.parametrize("backend", ["fake", "cpu"])
def test_gossip_batches_equal_jax(gossip, backend):
    got = _run("torch", gossip, backend)
    assert got == _run("jax", gossip, backend)
    un, ag = got["unaggregated"], got["aggregates"]
    reasons = [why for _, why in un[1]]
    assert "attester already seen this epoch" in reasons
    assert "not exactly one aggregation bit" in reasons
    assert "aggregate already seen" in [why for _, why in ag[1]]
    if backend == "cpu":
        items = gossip["unaggregated"][0]
        assert (items[2].tree_hash_root(), "invalid signature") in un[1]
        assert len(un[0]) == 3 and 0 < un[2] <= CS.bisection_bound(1, 4)
        items = gossip["aggregates"][0]
        assert (items[1].tree_hash_root(), "invalid signature") in ag[1]
        assert len(ag[0]) == 1 and 0 < ag[2] <= CS.bisection_bound(1, 2)
    else:
        assert len(un[0]) == 4 and len(ag[0]) == 2 and un[2] == ag[2] == 0


def test_is_aggregator_equals_jax():
    for committee in (1, 4, 16, 128, 2048):
        for seed in range(20):
            proof = bytes([seed]) * 96
            assert (TAV.is_aggregator(committee, proof, T.ChainSpec.mainnet())
                    == JAV.is_aggregator(committee, proof, J.ChainSpec.mainnet()))

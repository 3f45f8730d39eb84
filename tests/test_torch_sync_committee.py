"""The port's sync-committee gossip verification and pools
(lighthouse_tpu_torch/chain/sync_committee_verification.py) against the
JAX package's on the CPU, with exact equality:

- the committee helpers (`sync_committee_positions`,
  `subnets_for_sync_validator`, `is_sync_committee_aggregator`) give the
  same answers;
- `batch_verify_sync_messages` and `batch_verify_contributions` over a
  duck chain (a MINIMAL altair interop state at slot 3, 64 validators)
  give the same (verified, rejected) lists on both packages' `fake` and
  `cpu` backends and on a `fake` backend that fails the batches holding
  a forged item, with the same bisection call counts; the items are
  made on the port by chip_smoke.py's sync helpers and reach the JAX
  side as SSZ bytes;
- the same batches through a BeaconProcessor whose `gossip_sync_message`
  and `gossip_sync_contribution` handlers submit them (one call each on
  the `sync` lane) fill the SyncMessagePool and SyncContributionPool
  with the same contributions and the same SyncAggregate bytes.

On the card (`gpu`): the same honest and forged batches on torch_cuda
give the JAX cpu oracle's lists. No XLA compile."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.chain import sync_committee_verification as JSV
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import fake as JFAKE
from lighthouse_tpu.pool import observed as JO
from lighthouse_tpu.processor import beacon_processor as JBP
from lighthouse_tpu.state_transition import signature_sets as JSS
from lighthouse_tpu.types import containers as JC
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain import sync_committee_verification as TSV
from lighthouse_tpu_torch.chain.pubkey_cache import ValidatorPubkeyCache
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import fake as TFAKE
from lighthouse_tpu_torch.pool import observed as TO
from lighthouse_tpu_torch.processor import beacon_processor as TBP
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from lighthouse_tpu_torch.utils import metrics as TM
from torch_port_util import jax_keys_from_port, need_card, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

PKG = {"jax": (JSV, JBP, JM, JO, japi, JFAKE), "torch": (TSV, TBP, TM, TO, tapi, TFAKE)}
SLOT = 3


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    jax_keys_from_port(monkeypatch)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


@pytest.fixture(scope="module")
def sync():
    """The port's MINIMAL altair state at slot 3 (64 validators, a 32-member
    sync committee in 4 subnets of 8); the messages of slot 3 over block
    root R (one a position, the third forged), then a duplicate, one on a
    wrong subnet and one of a stale slot; the 16 contributions (4 a
    subnet) wrapping the honest messages' pool, the sixth forged, and a
    duplicate aggregator. Each list as (port items, JAX items)."""
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        jax_keys_from_port(mp)
        C = CS.consensus_modules()
        host = CS.HostCrypto()
        preset, spec = T.MINIMAL, T.ChainSpec.interop(altair_fork_epoch=0)
        state = TPS.process_slots(T.interop_genesis_state(64, preset, spec), SLOT,
                                  preset, spec)
        root = bytes(state.block_roots[SLOT - 1])

        def secret_of(i):
            return T.interop_secret_key(i).scalar

        honest = CS.sync_messages(C, state, preset, spec, secret_of, SLOT, root, host)
        msgs = CS.sync_messages(C, state, preset, spec, secret_of, SLOT, root, host,
                                forge=(2,))
        msgs.append(msgs[0])
        wrong = T.SyncCommitteeMessage.from_ssz_bytes(msgs[1][0].as_ssz_bytes())
        msgs.append((wrong, (msgs[1][1] + 1) % 4))
        stale = T.SyncCommitteeMessage.from_ssz_bytes(msgs[4][0].as_ssz_bytes())
        stale.slot = 0
        msgs.append((stale, msgs[4][1]))
        pool = TSV.SyncMessagePool(preset)
        members = CS.sync_committee_members(C, state, preset)
        size = preset.sync_subcommittee_size
        for p, (m, subnet) in enumerate(honest):
            pos = [i % size for i, v in enumerate(members)
                   if bytes(state.validators[v].pubkey)
                   == bytes(state.validators[m.validator_index].pubkey)
                   and i // size == subnet]
            pool.insert(TSV.VerifiedSyncMessage(m, subnet, pos))
        contribs = CS.sync_contributions(C, state, preset, spec, secret_of, SLOT, root,
                                         pool, host)
        contribs = CS.forge_contributions(C, state, preset, secret_of, contribs, (5,), host)
        contribs.append(contribs[0])
        jt = J.types_for(J.MINIMAL)
        return dict(
            state=(state, J.decode_state_any_fork(state.as_ssz_bytes(), J.MINIMAL)),
            root=root, members=members,
            messages=(msgs, [(JC.SyncCommitteeMessage.from_ssz_bytes(m.as_ssz_bytes()), s)
                             for m, s in msgs]),
            contributions=(contribs, [jt.SignedContributionAndProof.from_ssz_bytes(
                c.as_ssz_bytes()) for c in contribs]),
        )


def _chain(pkg, state):
    if pkg == "torch":
        cache = ValidatorPubkeyCache(state, device="cpu")
        preset, spec = T.MINIMAL, T.ChainSpec.interop(altair_fork_epoch=0)
    else:
        cache = SimpleNamespace(getter=JSS.state_pubkey_getter,
                                resolve=lambda b: JSS._decompress(b))
        preset, spec = J.MINIMAL, J.ChainSpec.interop(altair_fork_epoch=0)
    return SimpleNamespace(current_slot=SLOT, preset=preset, spec=spec,
                           head_state=state, pubkey_cache=cache)


def _side(pkg, sync, name):
    return sync[name][0 if pkg == "torch" else 1]


def _message_view(verified, rejected):
    return ([(v.message.tree_hash_root(), v.subnet_id, list(v.positions)) for v in verified],
            [(m.tree_hash_root(), why) for m, why in rejected])


def _contribution_view(verified, rejected):
    return ([(v.signed_contribution.tree_hash_root(), v.participant_count)
             for v in verified], [(c.tree_hash_root(), why) for c, why in rejected])


def _marked(pkg, sync, monkeypatch):
    """The package's fake backend, failing every batch that holds a
    forged item's signature: the bisection runs as on real crypto, at no
    pairing's cost."""
    _, _, _, _, api, FAKE = PKG[pkg]
    forged = {bytes(sync["messages"][0][2][0].signature),
              bytes(sync["contributions"][0][5].signature)}
    monkeypatch.setattr(FAKE, "verify_signature_sets", lambda sets, *a, **kw: not any(
        s.signature.to_bytes() in forged for s in sets))
    api.set_backend("fake")


def _batches(pkg, sync, backend, subset):
    SV, _, M, O, api, _ = PKG[pkg]
    if backend != "marked":
        api.set_backend(backend)
    state = _side(pkg, sync, "state")
    chain = _chain(pkg, state)
    msgs = _side(pkg, sync, "messages")
    contribs = _side(pkg, sync, "contributions")
    if subset:  # on the cpu oracle: an honest and the forged message, the
        msgs = msgs[2:4]  # forged contribution alone
        contribs = contribs[5:6]
    out = {}
    calls0 = M.BLS_BISECTION_CALLS.value
    out["messages"] = _message_view(*SV.batch_verify_sync_messages(
        chain, msgs, SV.ObservedSyncContributors())) + (
        M.BLS_BISECTION_CALLS.value - calls0,)
    calls0 = M.BLS_BISECTION_CALLS.value
    out["contributions"] = _contribution_view(*SV.batch_verify_contributions(
        chain, contribs, SV.ObservedSyncAggregators(), O.ObservedAggregates())) + (
        M.BLS_BISECTION_CALLS.value - calls0,)
    return out


@pytest.mark.parametrize("backend, subset", [
    ("fake", False), ("marked", False), ("cpu", True)])
def test_sync_batches_equal_jax(sync, backend, subset, monkeypatch):
    if backend == "marked":
        for pkg in PKG:
            _marked(pkg, sync, monkeypatch)
    got = _batches("torch", sync, backend, subset)
    assert got == _batches("jax", sync, backend, subset)
    (mv, mr, mcalls), (cv, cr, ccalls) = got["messages"], got["contributions"]
    msgs, contribs = sync["messages"][0], sync["contributions"][0]
    reasons = [why for _, why in mr]
    if not subset:
        assert "validator already contributed for this slot/subnet" in reasons
        assert "validator not in this sync subnet" in reasons
        assert "message not for the current slot" in reasons
        assert "duplicate aggregator in batch" in [why for _, why in cr]
    if backend == "fake":
        assert len(cv) == 16 and mcalls == ccalls == 0  # fake: forgeries pass
    else:
        assert (msgs[2][0].tree_hash_root(), "invalid signature") in mr
        assert (contribs[5].tree_hash_root(), "invalid signature") in cr
    if backend == "marked":
        assert len(mv) == 31 and len(cv) == 15
        assert 0 < mcalls <= CS.bisection_bound(1, 33)
        assert 0 < ccalls <= CS.bisection_bound(1, 16)
    if backend == "cpu":
        assert len(mv) == 1 and not cv and mcalls == 2 and ccalls == 0


def test_committee_helpers_equal_jax(sync):
    tstate, jstate = sync["state"]
    tpos = TSV.sync_committee_positions(tstate, T.MINIMAL)
    assert tpos == JSV.sync_committee_positions(jstate, J.MINIMAL)
    for v in range(0, 64, 5):
        assert (TSV.subnets_for_sync_validator(tstate, T.MINIMAL, v, tpos)
                == JSV.subnets_for_sync_validator(jstate, J.MINIMAL, v))
    for k in range(24):
        proof = bytes([k]) * 96
        for tp, jp in ((T.MINIMAL, J.MINIMAL), (T.MAINNET, J.MAINNET)):
            assert (TSV.is_sync_committee_aggregator(proof, tp, T.ChainSpec.mainnet())
                    == JSV.is_sync_committee_aggregator(proof, jp, J.ChainSpec.mainnet()))
    assert len(set(sync["members"])) > 8


def _through_processor(pkg, sync, backend):
    """The node's sync lanes: a BeaconProcessor whose handlers submit each
    batch and, on completion, fill the two pools; each backend call's set
    count spied on the package's backend."""
    SV, BP, _, O, api, FAKE = PKG[pkg]
    api.set_backend(backend)
    state = _side(pkg, sync, "state")
    chain = _chain(pkg, state)
    preset = T.MINIMAL if pkg == "torch" else J.MINIMAL
    t = T.types_for(T.MINIMAL) if pkg == "torch" else J.types_for(J.MINIMAL)
    pools = SimpleNamespace(messages=SV.SyncMessagePool(preset),
                            contributions=SV.SyncContributionPool(preset))
    calls, real = [], FAKE.verify_signature_sets

    def spy(sets, *a, **kw):
        calls.append(len(sets))
        return real(sets, *a, **kw)

    FAKE.verify_signature_sets = spy
    lanes = []
    submit = SV.verify_signature_sets_async

    def lane_spy(sets, *a, **kw):
        lanes.append(kw.get("lane"))
        return submit(sets, *a, **kw)

    SV.verify_signature_sets_async = lane_spy
    try:
        contributors, aggregators = SV.ObservedSyncContributors(), SV.ObservedSyncAggregators()
        seen = O.ObservedAggregates()

        def deferred(pending, insert):
            def complete():
                verified, _ = pending.complete()
                for v in verified:
                    insert(v)
            return BP.DeferredWork(done=pending.done, complete=complete)

        bp = BP.BeaconProcessor(handlers={
            "gossip_sync_message": lambda items: deferred(
                SV.submit_sync_message_batch(chain, items, contributors),
                pools.messages.insert),
            "gossip_sync_contribution": lambda items: deferred(
                SV.submit_contribution_batch(chain, items, aggregators, seen),
                pools.contributions.insert),
        })
        honest = [m for i, m in enumerate(_side(pkg, sync, "messages")[:32]) if i != 2]
        for m in honest:
            assert bp.submit("gossip_sync_message", m)
        contribs = [c for i, c in enumerate(_side(pkg, sync, "contributions")[:16])
                    if i != 5]
        for c in contribs:
            assert bp.submit("gossip_sync_contribution", c)
        bp.run_until_idle()
        assert not bp.handler_errors
    finally:
        FAKE.verify_signature_sets = real
        SV.verify_signature_sets_async = submit
    root = sync["root"]
    got = [pools.messages.get_contribution(t, SLOT, root, s) for s in range(4)]
    agg = pools.contributions.get_sync_aggregate(t, SLOT, root)
    empty = pools.contributions.get_sync_aggregate(t, SLOT, b"\x01" * 32)
    return (calls, lanes, [c.as_ssz_bytes() if c is not None else None for c in got],
            agg.as_ssz_bytes(), empty.as_ssz_bytes(),
            dict(bp.processed))


def test_sync_lanes_through_the_processor_fill_the_pools_like_jax(sync):
    got = _through_processor("torch", sync, "fake")
    assert got == _through_processor("jax", sync, "fake")
    calls, lanes, contributions, agg, empty, processed = got
    # the processor claims the contribution queue first (its priority)
    assert calls == [45, 31] and lanes == ["sync", "sync"]
    assert processed["gossip_sync_message"] == 31
    assert processed["gossip_sync_contribution"] == 15
    assert all(c is not None for c in contributions)
    a = T.types_for(T.MINIMAL).SyncAggregate.from_ssz_bytes(agg)
    assert sum(a.sync_committee_bits) >= 28
    e = T.types_for(T.MINIMAL).SyncAggregate.from_ssz_bytes(empty)
    assert not any(e.sync_committee_bits)
    assert bytes(e.sync_committee_signature) == tapi.INFINITY_SIGNATURE


@pytest.mark.gpu
def test_sync_batches_on_the_card_equal_jax_cpu(sync):
    """Every message and contribution on torch_cuda (the chain's pubkey
    table on the card): the JAX cpu oracle's lists and bisection calls."""
    need_card()
    state = _side("torch", sync, "state")
    chain = _chain("torch", state)
    chain.pubkey_cache = ValidatorPubkeyCache(state)  # its table on the card
    tapi.set_backend("torch_cuda")
    got = {}
    calls0 = TM.BLS_BISECTION_CALLS.value
    got["messages"] = _message_view(*TSV.batch_verify_sync_messages(
        chain, _side("torch", sync, "messages"), TSV.ObservedSyncContributors())) + (
        TM.BLS_BISECTION_CALLS.value - calls0,)
    calls0 = TM.BLS_BISECTION_CALLS.value
    got["contributions"] = _contribution_view(*TSV.batch_verify_contributions(
        chain, _side("torch", sync, "contributions"), TSV.ObservedSyncAggregators(),
        TO.ObservedAggregates())) + (TM.BLS_BISECTION_CALLS.value - calls0,)
    want = _batches("jax", sync, "cpu", False)
    assert got == want
    assert len(got["messages"][0]) == 31 and len(got["contributions"][0]) == 15

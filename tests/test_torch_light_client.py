"""The port's merkle proofs and light client
(lighthouse_tpu_torch/ssz/merkle_proof.py, chain/light_client.py)
against the JAX package's on the CPU, with exact equality:

- generalized-index helpers, MerkleTree roots, single proofs and
  multiproofs over seeded chunks (with and without a limit), their
  verification, and the errors they raise;
- over a MINIMAL altair state of 64 validators: the sync-committee and
  finality branches (the cached field roots), and the bootstrap, update,
  finality-update and optimistic-update containers, as SSZ bytes;
- a LightClientStore bootstrapped at the genesis block follows an
  optimistic update whose sync aggregate (the 32-key committee, signed
  on the port) is verified on the cpu oracle, rejects the same update
  with one forged signature and one with too few participants, and
  rejects and ranks spec updates (fake backend) alike: the same store
  state after each step and the same error texts.

On the card (`gpu`): with the store's signature checks on torch_cuda, the
same store states and errors. No XLA compile."""

import random

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.chain import light_client as JL
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import curve_ref as JCURVE
from lighthouse_tpu.ssz import merkle_proof as JMP
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain import light_client as TL
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.ssz import merkle_proof as TMP
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from torch_port_util import jax_keys_from_port, need_card, no_xla_compile

JSPEC = J.ChainSpec.interop(altair_fork_epoch=0)
TSPEC = T.ChainSpec.interop(altair_fork_epoch=0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    jax_keys_from_port(monkeypatch)
    # the JAX store parses its committee's keys: without the subgroup check
    # (~0.18 s a key there), as jax_keys_from_port decompresses the rest
    monkeypatch.setattr(japi.PublicKey, "from_bytes", classmethod(
        lambda cls, data: cls(JCURVE.g1_from_bytes(bytes(data)), bytes(data),
                              subgroup_checked=True)))
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


# --- merkle proofs -------------------------------------------------------------------


def _chunks(n, seed):
    rng = random.Random(seed)
    return [rng.randbytes(32) for _ in range(n)]


def _errors(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- the error text is compared
        return (type(e).__name__, str(e))


def _merkle(MP, n, limit, seed):
    cs = _chunks(n, seed)
    tree = MP.MerkleTree(cs, limit=limit)
    width = 1 << tree.depth
    picks = sorted({0, n // 2, max(n - 1, 0), min(n, width - 1)})
    out = [tree.root, tree.depth]
    for i in picks:
        gi = tree.generalized_index_of_chunk(i)
        branch = tree.proof(i)
        leaf = cs[i] if i < n else bytes(32)
        out += [gi, branch, MP.branch_indices(gi), MP.verify_merkle_proof(leaf, branch, gi, tree.root),
                MP.verify_merkle_proof(b"\xff" * 32, branch, gi, tree.root),
                MP.calculate_merkle_root(leaf, branch, gi)]
    indices = [tree.generalized_index_of_chunk(i) for i in picks]
    proof = tree.multiproof(picks)
    leaves = [cs[i] if i < n else bytes(32) for i in picks]
    out += [MP.multiproof_helper_indices(indices), proof,
            MP.verify_merkle_multiproof(leaves, proof, indices, tree.root),
            MP.verify_merkle_multiproof(leaves[::-1], proof, indices, tree.root)]
    out += [_errors(lambda: tree.proof(width)),
            _errors(lambda: MP.calculate_merkle_root(cs[0] if cs else bytes(32), [], 5)),
            _errors(lambda: MP.verify_merkle_multiproof(leaves, proof[1:], indices, tree.root)),
            _errors(lambda: MP.generalized_index_depth(0)),
            _errors(lambda: MP.MerkleTree(_chunks(5, 0), limit=4))]
    return out


@pytest.mark.parametrize("n, limit", [(1, None), (2, None), (7, None), (33, None),
                                      (3, 16), (5, 1024), (0, 64), (24, 32)])
def test_merkle_proofs_equal_jax(n, limit):
    got = _merkle(TMP, n, limit, seed=n)
    assert got == _merkle(JMP, n, limit, seed=n)
    assert got[0] == (JMP.MerkleTree(_chunks(n, n), limit=limit).root)
    assert got[5] is True and got[6] is False  # the first leaf proves, a tampered one not


# --- the light client ------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """MINIMAL altair genesis (64 validators) and the post-state of a block
    at slot 1 (the attested state); the sync aggregate of the 32-member
    committee over that block's root (signed on the port), the same with
    one member's signature over a wrong root, and one of 3 members."""
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        jax_keys_from_port(mp)
        import importlib.util
        from pathlib import Path

        root_dir = Path(__file__).resolve().parents[1]
        spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                       root_dir / "chip_smoke.py")
        CS = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(CS)
        C = CS.consensus_modules()
        genesis = T.interop_genesis_state(64, T.MINIMAL, TSPEC)
        pre = TPS.process_slots(TPS.clone_state(genesis), 1, T.MINIMAL, TSPEC)

        def secret(i):
            return T.interop_secret_key(i).scalar

        host = CS.HostCrypto()
        _, state = CS.produce_block(C, pre, T.MINIMAL, TSPEC, secret, host)
        members = CS.sync_committee_members(C, state, T.MINIMAL)
        header_root = TL._header_for(state).tree_hash_root()
        domain = T.get_domain(state, T.DOMAIN_SYNC_COMMITTEE, 0, T.MINIMAL)
        signing = T.SigningData(object_root=header_root, domain=domain).tree_hash_root()
        honest, rest, bad = host.sign([
            ([secret(v) for v in members], signing),
            ([secret(v) for v in members[1:]], signing),
            ([secret(members[0])], CS.wrong_root(signing))])
        t = T.types_for(T.MINIMAL)
        n = len(members)
        agg = t.SyncAggregate(sync_committee_bits=(True,) * n, sync_committee_signature=honest)
        forged = t.SyncAggregate(
            sync_committee_bits=(True,) * n,
            sync_committee_signature=tapi.AggregateSignature.aggregate(
                [tapi.Signature.from_bytes(rest), tapi.Signature.from_bytes(bad)]).to_bytes())
        thin = t.SyncAggregate(sync_committee_bits=(True,) * 3 + (False,) * (n - 3),
                               sync_committee_signature=honest)
        return dict(genesis=genesis, state=state, aggs=dict(honest=agg, forged=forged,
                                                            thin=thin))


def _pkg(pkg, world):
    """(light client module, types, preset, spec, genesis, state, aggs)."""
    if pkg == "torch":
        return TL, T.types_for(T.MINIMAL), T.MINIMAL, TSPEC, world["genesis"], \
            world["state"], world["aggs"]
    t = J.types_for(J.MINIMAL)
    return (JL, t, J.MINIMAL, JSPEC,
            J.decode_state_any_fork(world["genesis"].as_ssz_bytes(), J.MINIMAL),
            J.decode_state_any_fork(world["state"].as_ssz_bytes(), J.MINIMAL),
            {k: t.SyncAggregate.from_ssz_bytes(v.as_ssz_bytes())
             for k, v in world["aggs"].items()})


def _containers(pkg, world):
    L, t, preset, spec, genesis, state, aggs = _pkg(pkg, world)
    header = L._header_for(genesis)
    return [L.sync_committee_branch(state, "current"), L.sync_committee_branch(state, "next"),
            L.finality_branch(state),
            L.light_client_bootstrap(genesis, preset).as_ssz_bytes(),
            L.light_client_update(state, header, aggs["honest"], 6, preset).as_ssz_bytes(),
            L.light_client_finality_update(state, header, aggs["honest"], 6,
                                           preset).as_ssz_bytes(),
            L.light_client_optimistic_update(state, aggs["honest"], 6, preset).as_ssz_bytes(),
            L.period_slots(preset),
            [L.CURRENT_SYNC_COMMITTEE_INDEX, L.NEXT_SYNC_COMMITTEE_INDEX,
             L.FINALIZED_ROOT_INDEX]]


def test_branches_and_containers_equal_jax(world):
    got = _containers("torch", world)
    assert got == _containers("jax", world)
    assert [len(b) for b in got[:3]] == [5, 5, 6]
    TL.verify_next_committee_branch(TL.light_client_types(T.MINIMAL).LightClientUpdate
                                    .from_ssz_bytes(got[4]))


def _store_view(store):
    return (store.finalized_header.tree_hash_root(), store.optimistic_header.tree_hash_root(),
            store.previous_max_active_participants, store.current_max_active_participants,
            store.next_sync_committee is None, store.best_valid_update is None)


def _follow(pkg, world, backend="cpu"):
    """The store's steps; on the cpu oracle for the signatures."""
    L, t, preset, spec, genesis, state, aggs = _pkg(pkg, world)
    (japi if pkg == "jax" else tapi).set_backend(backend)
    boot = L.light_client_bootstrap(genesis, preset)
    trusted = L._header_for(genesis).tree_hash_root()
    out = [_errors(lambda: L.LightClientStore(b"\x01" * 32, boot, preset, spec,
                                              bytes(state.genesis_validators_root)))]
    store = L.LightClientStore(trusted, boot, preset, spec,
                               bytes(state.genesis_validators_root))
    out.append(_store_view(store))
    thin = L.light_client_update(state, L._header_for(genesis), aggs["thin"], 6, preset)
    out.append(_errors(lambda: store.process_update(thin)))  # supermajority first
    out.append(_store_view(store))
    for name in ("forged", "honest"):
        update = L.light_client_optimistic_update(state, aggs[name], 6, preset)
        out.append(_errors(lambda: store.process_optimistic_update(update)))
        out.append(_store_view(store))
    # a finality update whose finalized header is not the state's
    # finalized root, and a full update before any committee rotation
    header = L._header_for(genesis)
    fin = L.light_client_finality_update(state, header, aggs["honest"], 6, preset)
    out.append(_errors(lambda: store.process_finality_update(fin)))
    upd = L.light_client_update(state, header, aggs["honest"], 6, preset)
    out.append(_errors(lambda: store.process_update(upd)))
    out.append(_store_view(store))
    return out


def test_store_follows_the_same_updates_as_jax(world):
    got = _follow("torch", world)
    assert got == _follow("jax", world)
    assert got[0][0] == "LightClientError"
    assert got[2] == ("LightClientError", "insufficient sync participation 3/32")
    assert got[4] == ("LightClientError", "sync aggregate signature invalid")
    assert got[6] == ("ok", None) and got[7][3] == 32
    assert got[7][1] != got[1][1]  # the optimistic header moved to the attested one
    assert got[8] == ("LightClientError", "finality branch does not verify")


def _spec_updates(pkg, world):
    """The spec-shaped update machinery on the fake backend: validation
    errors, best_valid_update, ranking and the forced update."""
    L, t, preset, spec, genesis, state, aggs = _pkg(pkg, world)
    (japi if pkg == "jax" else tapi).set_backend("fake")
    boot = L.light_client_bootstrap(genesis, preset)
    trusted = L._header_for(genesis).tree_hash_root()
    store = L.LightClientStore(trusted, boot, preset, spec,
                               bytes(state.genesis_validators_root))
    lt = L.light_client_types(preset)
    empty_header = type(L._header_for(genesis)).default()
    base = L.light_client_update(state, empty_header, aggs["honest"], 6, preset)
    no_fin = lt.LightClientUpdate.from_ssz_bytes(base.as_ssz_bytes())
    no_fin.finality_branch = [bytes(32)] * L.FINALIZED_ROOT_PROOF_LEN
    thin = lt.LightClientUpdate.from_ssz_bytes(no_fin.as_ssz_bytes())
    thin.sync_aggregate = aggs["thin"]
    out = []
    for u, now in ((no_fin, 5), (base, 9), (no_fin, 9), (thin, 9)):
        out.append(_errors(lambda: store.process_spec_update(u, now)))
        out.append(_store_view(store))
    out.append([L.is_better_update(a, b, preset) for a in (no_fin, thin, base)
                for b in (no_fin, thin, base)])
    store.force_update(10 ** 6)
    out.append(_store_view(store))
    return out


def test_spec_updates_equal_jax(world):
    got = _spec_updates("torch", world)
    assert got == _spec_updates("jax", world)
    assert got[0] == ("LightClientError", "update signed in the future")
    assert got[2] == ("LightClientError", "finality branch does not verify")
    assert got[4] == ("ok", None) and got[5][1] != got[1][1]  # the optimistic header moved
    assert got[-1][0] == got[5][1]  # forced: the best update's attested header is final


@pytest.mark.gpu
def test_store_on_the_card_follows_like_jax(world):
    need_card()
    assert _follow("torch", world, "torch_cuda") == _follow("jax", world)

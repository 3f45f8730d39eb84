"""The port as a whole: lighthouse_tpu_torch's
verify_signature_sets(device="cpu") against lighthouse_tpu's
verify_signature_sets on the pure-Python CPU oracle, on small batches over
both device routes (per-set and message-aggregated); the weights drawn
equal for one seed; the JAX backend's marshalled batch carried across;
the pipeline's keyword duck type and the pubkey-table tags; and no port
file imports jax or lighthouse_tpu.

The five device stages bit-identical to jax_tpu's jitted stages is the
`slow` test at the end: the staged-verifier compile takes minutes on a
CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import aggregation as JAG
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu.crypto.bls.curve_ref import Point as JPoint
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.crypto.bls.curve_ref import Point as TPoint
from torch_port_util import both, make_signed

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def signed():
    """Six keys, three messages; per (key, message) JAX-side signatures,
    and the same keys/signatures decoded on the port side from bytes."""
    return make_signed()


_both = both


def _oracle(jsets, seed):
    saved = japi._BACKEND, japi._BACKEND_NAME
    japi.set_backend("cpu")
    try:
        return japi.verify_signature_sets(jsets, seed=seed)
    finally:
        japi._BACKEND, japi._BACKEND_NAME = saved


CASES = {
    # 5 sets over 2 messages: n_b = 8, m_b = 4 -> the aggregated route
    "aggregated_honest": ([((0,), 0, None), ((1, 2), 1, None), ((3,), 0, None),
                           ((4,), 1, None), ((5,), 0, None)], True, True),
    "aggregated_forged": ([((0,), 0, None), ((1, 2), 1, None), ((3,), 0, 2),
                           ((4,), 1, None), ((5,), 0, None)], True, False),
    # 3 sets, mixed and repeated messages: n_b = m_b = 4 -> per-set route
    "per_set_honest": ([((0,), 0, None), ((1,), 1, None), ((2, 3), 0, None)],
                       False, True),
    "per_set_forged": ([((0,), 0, None), ((1,), 2, 1), ((2, 3), 0, None)],
                       False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdict_matches_jax_cpu_oracle(signed, case):
    spec, aggregated, want = CASES[case]
    jsets, tsets = _both(signed, spec)
    mb = TB._marshal_batch(tsets, "cpu", seed=7)
    assert (mb.grid_idx is not None) == aggregated
    got = tapi.verify_signature_sets(tsets, seed=7, device="cpu")
    assert got is want
    assert _oracle(jsets, seed=7) is want


def test_structural_rejections_match(signed):
    """Empty pubkeys and an infinity pubkey are rejected on the host by
    both packages, with no device work."""
    jsets, tsets = _both(signed, [((0,), 0, None), ((1,), 1, None)])
    jempty = [jsets[0], japi.SignatureSet(jsets[1].signature, [], jsets[1].message)]
    tempty = [tsets[0], tapi.SignatureSet(tsets[1].signature, [], tsets[1].message)]
    assert tapi.verify_signature_sets(tempty, device="cpu") is False
    assert _oracle(jempty, seed=1) is False
    jinf = japi.PublicKey(JPoint(jsets[0].pubkeys[0].point.x, jsets[0].pubkeys[0].point.y, True))
    tinf = tapi.PublicKey(TPoint(tsets[0].pubkeys[0].point.x, tsets[0].pubkeys[0].point.y, True))
    jbad = [jsets[0], japi.SignatureSet(jsets[1].signature, [jinf], jsets[1].message)]
    tbad = [tsets[0], tapi.SignatureSet(tsets[1].signature, [tinf], tsets[1].message)]
    assert TB._marshal_batch(tbad, "cpu", seed=1) is None
    assert tapi.verify_signature_sets(tbad, device="cpu") is False
    assert _oracle(jbad, seed=1) is False
    assert tapi.verify_signature_sets([], device="cpu") is False


def test_neg_g1_generator_equal_jax():
    np.testing.assert_array_equal(
        TB._NEG_G1_GEN_AFF, np.asarray(jax_tpu._NEG_G1_GEN_AFF)
    )


@pytest.mark.parametrize("seed,n,n_b", [(0, 3, 4), (9, 64, 64), (None, 0, 4)])
def test_draw_weight_scalars_equal_for_one_seed(seed, n, n_b):
    if seed is None:
        a, b = TB._draw_weight_scalars(1, 0, 4), jax_tpu._draw_weight_scalars(1, 0, 4)
    else:
        a = TB._draw_weight_scalars(seed, n, n_b)
        b = jax_tpu._draw_weight_scalars(seed, n, n_b)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype == np.uint32


def test_draw_weight_scalars_redraws_collisions_like_jax():
    class Colliding:
        """First draws collide; later ones come from a seeded generator."""

        def __init__(self):
            self.calls = 0
            self.rng = np.random.default_rng(3)

        def integers(self, lo, hi, size, dtype):
            self.calls += 1
            if self.calls <= 2:
                return np.full(size, 5, dtype=dtype)
            return self.rng.integers(lo, hi, size=size, dtype=dtype)

    a = TB._draw_weight_scalars(None, 4, 4, rng=Colliding())
    b = jax_tpu._draw_weight_scalars(None, 4, 4, rng=Colliding())
    np.testing.assert_array_equal(a, b)
    w = a[:, 0].astype(np.uint64) | (a[:, 1].astype(np.uint64) << np.uint64(32))
    assert len(set(w.tolist())) == 4


@pytest.mark.parametrize("case", ["aggregated_honest", "per_set_honest"])
def test_marshalled_from_numpy_round_trip(signed, case):
    """The JAX backend's marshalled batch, carried across, equals the
    port's own marshalling of the same sets, tensor for tensor, on both
    routes (the per-set route carries no grid)."""
    spec, aggregated, _ = CASES[case]
    jsets, tsets = _both(signed, spec)
    jm = jax_tpu._marshal_batch(jsets, seed=4)
    arrays = {k: (None if getattr(jm, k) is None else np.asarray(getattr(jm, k)))
              for k in ("u", "h_idx", "pk", "sig", "scalars", "real",
                        "grid_idx", "grid_real")}
    carried = TB.marshalled_from_numpy(
        dict(arrays, n_sets=jm.n_sets, n_messages=jm.n_messages), "cpu")
    own = TB._marshal_batch(tsets, "cpu", seed=4)
    assert (own.grid_idx is None) == (not aggregated)
    for k in arrays:
        a, b = getattr(carried, k), getattr(own, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), k
    assert (carried.n_sets, carried.n_messages) == (own.n_sets, own.n_messages)


def test_entry_points_refuse_a_missing_card():
    """No silent CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.resolve_device(None)
    assert TB.resolve_device("cpu").type == "cpu"


def test_dispatch_keywords_are_the_jax_backends():
    """The pipeline and scheduler call dispatch_verify_signature_sets with
    keywords; the port takes the same ones, in the same order, plus its
    device."""
    import inspect

    jparams = list(inspect.signature(jax_tpu.dispatch_verify_signature_sets).parameters)
    tparams = list(inspect.signature(TB.dispatch_verify_signature_sets).parameters)
    assert tparams == jparams + ["device"]
    jm = list(inspect.signature(jax_tpu._marshal_batch).parameters)
    tm = list(inspect.signature(TB._marshal_batch).parameters)
    assert tm == jm[:1] + ["device"] + jm[1:]


def test_public_key_carries_the_table_tags_like_jax():
    assert set(tapi.PublicKey.__slots__) == set(japi.PublicKey.__slots__)
    pk = tapi.SecretKey(99).public_key()
    pk.validator_index, pk.table = 7, object()
    assert pk.validator_index == 7


def test_prepack_indices_leaves_structural_rejects_to_marshalling(signed):
    """Empty pubkeys or an infinity signature: no index pack in either
    package (marshalling rejects the batch)."""
    jsets, tsets = _both(signed, [((0,), 0, None)])
    jempty = [japi.SignatureSet(jsets[0].signature, [], jsets[0].message)]
    tempty = [tapi.SignatureSet(tsets[0].signature, [], tsets[0].message)]
    assert jax_tpu.prepack_indices(jempty) is None
    assert TB.prepack_indices(tempty) is None
    tinf = [tapi.SignatureSet(tapi.Signature.infinity(), tsets[0].pubkeys,
                              tsets[0].message)]
    assert TB.prepack_indices(tinf) is None
    assert TB._marshal_batch(tinf, "cpu", seed=1) is None


def _port_files():
    files = sorted((ROOT / "lighthouse_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """AST scan (conftest imports jax, so sys.modules cannot tell)."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "lighthouse_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    walked = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("crypto/bls/pipeline.py", "crypto/bls/scheduler.py",
                "crypto/bls/pairing_ref.py", "crypto/bls/backends/cpu.py",
                "crypto/bls/backends/fake.py", "crypto/bls/backends/fallback.py",
                "obs/ledger.py", "resilience/primitives.py", "utils/metrics.py",
                "utils/tracing.py", "crypto/bls/adversary.py", "utils/jsonrpc.py",
                "eth1/service.py", "eth1/jsonrpc.py", "execution_layer/keccak.py",
                "execution_layer/rlp.py", "execution_layer/block_hash.py",
                "execution_layer/engine_api.py", "execution_layer/auth.py",
                "execution_layer/execution_layer.py", "execution_layer/mock_engine.py",
                "execution_layer/http_engine.py", "execution_layer/builder.py",
                "validator_client/beacon_node.py", "validator_client/__init__.py",
                "network/message_bus.py", "network/peer_score.py",
                "network/subnet_service.py", "network/sync.py", "network/node.py",
                "network/simulator.py", "network/secure.py", "network/discovery.py",
                "network/wire.py", "network/wire_fabric.py", "network/__init__.py",
                "slasher/slasher.py", "slasher/service.py", "slasher/__init__.py",
                "crypto/aes.py", "validator_client/slashing_protection.py",
                "validator_client/validator_store.py", "validator_client/byzantine.py",
                "utils/executor.py", "utils/monitoring.py", "serving/__init__.py",
                "serving/admission.py", "serving/cache.py", "serving/sse.py",
                "serving/tier.py", "http_api/__init__.py", "http_api/api.py",
                "http_api/server.py", "http_api/client.py", "crypto/keystore.py",
                "validator_client/signing_method.py", "validator_client/keymanager.py",
                "validator_client/services.py"):
        assert "lighthouse_tpu_torch/" + mod in walked, mod
    assert len(_port_files()) > 10
    assert not bad, bad


@pytest.mark.slow
def test_five_stages_bitexact_with_jax_staged_verifier(signed):
    """Every stage output of the port equals jax_tpu's jitted stage at
    n_b = 4 (the group stage on a hand-laid 4 x 4 grid)."""
    jsets, tsets = _both(signed, CASES["per_set_honest"][0])
    jm = jax_tpu._marshal_batch(jsets, seed=6)
    tm = TB._marshal_batch(tsets, "cpu", seed=6)

    def same(j, t):
        j = j if isinstance(j, tuple) else (j,)
        t = t if isinstance(t, tuple) else (t,)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        return t

    h_aff, h_inf = same(jax_tpu._stage_hash(jm.u), TB._stage_hash(tm.u))
    prep = same(
        jax_tpu._stage_prep(jm.pk, jm.sig, jm.scalars, jm.real),
        TB._stage_prep(tm.pk, tm.sig, tm.scalars, tm.real),
    )
    groups = JAG.group_sets(jsets)
    gi, gr = JAG.group_grid(groups.members, 4, 4)
    same(
        jax_tpu._stage_group(prep[0].numpy(), prep[1].numpy(), gi, gr),
        TB._stage_group(prep[0], prep[1], torch.as_tensor(gi).long(), torch.as_tensor(gr)),
    )
    hs = (h_aff[tm.h_idx], h_inf[tm.h_idx])
    fprod = same(
        jax_tpu._stage_miller(prep[0].numpy(), prep[1].numpy(), hs[0].numpy(),
                              hs[1].numpy(), prep[2].numpy(), prep[3].numpy()),
        TB._stage_miller(prep[0], prep[1], hs[0], hs[1], prep[2], prep[3]),
    )[0]
    out = same(
        jax_tpu._stage_final(fprod.numpy(), prep[4].numpy()),
        TB._stage_final(fprod, prep[4]),
    )[0]
    assert bool(out)

"""The stage graphs and the warm pass of the port's backend: the port of
`@jax.jit` on each stage (one executable per shape) and of
jax_tpu.warm_compile.

On the CPU: `torch_cuda.warm_compile` drives the same kinds of route with
the same arguments as `jax_tpu.warm_compile` for every default bucket
(each runner is a spy, so nothing compiles or captures); the bucket
registry; a graphed stage on CPU tensors is its plain stage; `limbs.canon`
with its cached device constants is bit-identical to the JAX canon. On
the card (`gpu`-marked): a replayed verify equals the eager one stage for
stage, reads its new inputs, and counts the kernel launches the eager
verify makes."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu.crypto.bls.tpu import limbs as JL
from lighthouse_tpu.utils import compile_cache as CC
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K
from lighthouse_tpu_torch.crypto.bls.gpu import limbs as L
from lighthouse_tpu_torch.utils import cuda_graphs as CG

from torch_port_util import assert_same, lazy, need_card

W = 35


@pytest.fixture
def fresh_registries(monkeypatch):
    """Both backends' bucket registries empty for the test and restored
    after it; no persistent compile cache armed; the JAX dispatcher's mesh
    route off (the conftest gives JAX 8 CPU devices)."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_SHARD_MIN_SETS", "0")
    monkeypatch.setattr(CC, "_ARMED_DIR", None)
    saved = {m: set(m._seen_shape_buckets) for m in (jax_tpu, TB)}
    for m in saved:
        m._seen_shape_buckets.clear()
    yield
    for m, seen in saved.items():
        m._seen_shape_buckets.clear()
        m._seen_shape_buckets.update(seen)


def _spy(calls):
    return lambda kind, args: calls.append(
        (kind, [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                for a in args]))


def test_warm_buckets_are_the_jax_backends():
    assert TB.DEFAULT_WARM_BUCKETS == jax_tpu.DEFAULT_WARM_BUCKETS


def test_warm_compile_drives_the_routes_of_jax_warm_compile(fresh_registries):
    """Every default bucket: the same kind of route ("staged" when
    m_b == n_b, else "aggregated"), argument for argument the same shapes
    and values (all-padding batches: zero draws, infinity pubkeys and
    signatures, zero weights, no real set, zero grid), and the same report
    rows."""
    jcalls, tcalls = [], []
    jrep = jax_tpu.warm_compile(runner=_spy(jcalls))
    trep = TB.warm_compile(runner=_spy(tcalls), device="cpu")
    assert len(tcalls) == len(jcalls) == len(TB.DEFAULT_WARM_BUCKETS)
    for (tk, targs), (jk, jargs) in zip(tcalls, jcalls):
        assert tk == jk
        assert [a.shape for a in targs] == [a.shape for a in jargs]
        for t, j in zip(targs, jargs):
            np.testing.assert_array_equal(t, j)
    assert [{**r, "seconds": 0} for r in trep] == [
        {**r, "bucket": tuple(r["bucket"]), "seconds": 0} for r in jrep]
    assert {k for k, _ in tcalls} == {"staged", "aggregated"}


def test_second_warm_pass_captures_nothing_new(fresh_registries):
    """The registry remembers every warmed bucket: a second pass reports
    `compiled` False for each, and a marshalled batch at a warmed bucket
    registers nothing new."""
    first = TB.warm_compile(runner=lambda kind, args: None, device="cpu")
    assert all(r["compiled"] for r in first)
    second = TB.warm_compile(runner=lambda kind, args: None, device="cpu")
    assert [r["bucket"] for r in second] == [r["bucket"] for r in first]
    assert not any(r["compiled"] for r in second)
    assert TB._count_shape_bucket(64, 4, 64, 0) is None
    assert TB._count_shape_bucket(64, 4, 32, 64) == (64, 4, 32, 64)


def test_graphed_stage_on_cpu_is_the_plain_stage():
    """On CPU tensors a graphed stage calls its plain function: the same
    tensors out, and no graph kept. Operands on two kinds of device
    raise (no silent route)."""
    rng = np.random.default_rng(61)
    m_b = g_b = 4
    rpk_aff = torch.as_tensor(lazy(rng, (m_b, 2)))
    rpk_inf = torch.as_tensor(rng.integers(0, 2, size=(m_b,)).astype(bool))
    grid_idx = torch.as_tensor(rng.integers(0, m_b, size=(m_b, g_b)))
    grid_real = torch.as_tensor(rng.integers(0, 2, size=(m_b, g_b)).astype(bool))
    args = (rpk_aff, rpk_inf, grid_idx, grid_real)
    graphs = CG.graphed(TB._stage_group)
    got, want = graphs(*args), TB._stage_group(*args)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert graphs.graphs == {} and graphs.fn is TB._stage_group
    with pytest.raises(ValueError):
        graphs(rpk_aff.to("meta"), rpk_inf, grid_idx, grid_real)


def test_graph_key_is_shapes_dtypes_devices():
    a = torch.zeros((4, 2, W), dtype=torch.int32)
    b = torch.zeros((4,), dtype=torch.bool)
    assert CG.shape_key((a, b)) == (
        ((4, 2, W), torch.int32, torch.device("cpu")),
        ((4,), torch.bool, torch.device("cpu")),
    )
    assert CG.shape_key((a + 1, b)) == CG.shape_key((a, b))
    assert CG.shape_key((a[:2], b)) != CG.shape_key((a, b))


@pytest.mark.parametrize("maximal_rows", [0, 3])
def test_canon_with_cached_constants_bitexact_with_jax(maximal_rows):
    """canon's two float32 Barrett constants come from limbs.on's device
    cache (a capture allows no host-to-device copy): the same int32 limbs
    as the JAX canon, on seeded lazy limbs and all-maximal rows."""
    rng = np.random.default_rng(62 + maximal_rows)
    assert_same(JL.canon, L.canon, lazy(rng, (5,), maximal_rows=maximal_rows))
    for c in (L._BASE_F32, L._BARRETT_INV):
        t = L.on(c, "cpu")
        assert t.dtype == torch.float32 and t.dim() == 0 and float(t) == float(c)


def test_canon_and_cyclotomic_plain_build_no_host_tensors(monkeypatch):
    """After their first call, canon and fp12_cyclotomic_sq_plain make no
    tensor from host values (each would be a host-to-device copy inside a
    stage capture on the card)."""
    rng = np.random.default_rng(63)
    x = torch.as_tensor(lazy(rng, (2,)))
    f = torch.as_tensor(lazy(rng, (1, 2, 3, 2)))
    want = L.canon(x), K.fp12_cyclotomic_sq_plain(f)

    def refuse(*a, **k):
        raise AssertionError("tensor built from host values")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    assert torch.equal(L.canon(x), want[0])
    assert torch.equal(K.fp12_cyclotomic_sq_plain(f), want[1])


# --- on the card ----------------------------------------------------------------


def _parity_batches():
    """4 single-pubkey sets over 3 messages (bucket (4, 4, 4), the
    per-set path) and a forged copy of the same bucket."""
    sks = [tapi.SecretKey(7101 + i) for i in range(4)]
    msgs = [b"graphs-%d" % (i % 3) for i in range(4)]
    sets = [tapi.SignatureSet.single_pubkey(sk.sign(m), sk.public_key(), m)
            for sk, m in zip(sks, msgs)]
    forged = list(sets)
    forged[2] = tapi.SignatureSet.single_pubkey(
        sets[0].signature, sets[2].pubkeys[0], sets[2].message)
    return sets, forged


def _eager(name, fn, *args):
    return fn.fn(*args)


@pytest.mark.gpu
def test_replayed_verify_equals_eager_and_reads_new_inputs():
    """Bucket (4, 4, 4) on the card: after the capture, every stage's
    replayed outputs equal its plain stage's; a forged batch of the same
    bucket is rejected through the replays and the honest one accepted
    again; a replayed verify counts the kernel launches the eager one
    makes."""
    dev = need_card()
    sets, forged = _parity_batches()
    mb = TB._marshal_batch(sets, dev, seed=3)
    mb_bad = TB._marshal_batch(forged, dev, seed=3)
    assert TB._shape_bucket(mb) == TB._shape_bucket(mb_bad) == (4, 4, 4, 0)
    assert bool(TB.run_marshalled(mb))  # captures at a new shape
    want, got = {}, {}
    K.reset_launches()
    TB.run_marshalled(mb, timer=lambda n, fn, *a: want.setdefault(n, _eager(n, fn, *a)))
    eager_counts = dict(K.LAUNCHES)
    K.reset_launches()
    TB.run_marshalled(mb, timer=lambda n, fn, *a: got.setdefault(n, fn(*a)))
    torch.cuda.synchronize()
    assert dict(K.LAUNCHES) == eager_counts and all(eager_counts.values())
    assert set(got) == set(want) == {"hash", "prep", "miller", "final"}
    for name in want:
        w = want[name] if isinstance(want[name], tuple) else (want[name],)
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        for a, b in zip(g, w):
            assert torch.equal(a, b), name
    assert not bool(TB.run_marshalled(mb_bad))
    assert bool(TB.run_marshalled(mb))

"""The monolithic program of the port's backend: `torch_cuda.verify_body`,
the single-device body of jax_tpu's `verify_jit` (one function for the
whole per-set chain; one CUDA graph on the card), and the
LIGHTHOUSE_TPU_MONOLITH=1 route of `dispatch_verify_signature_sets`.

On the CPU: verify_body's verdicts on a 4-set batch, honest and forged,
equal the port's staged route and the JAX cpu oracle; under the switch an
aggregated batch takes the per-set monolith with n_b + 1 Miller pairs
recorded, as in the JAX package; the mesh axis is refused; warm_compile
does not warm the monolith. JAX's `verify_jit` compiles for minutes on a
CPU, so the verdict against it is `slow`, with a card twin."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K
from lighthouse_tpu_torch.obs import ledger as LG
from lighthouse_tpu_torch.utils import metrics as M

from torch_port_util import both, make_signed, need_card

# 4 single-pubkey sets over 3 messages (n_b = m_b = 4: the per-set route);
# forged: set 1 carries its key's signature over message 2
PARITY = [((0,), 0, None), ((1,), 1, None), ((2,), 2, None), ((3,), 0, None)]
PARITY_FORGED = [((0,), 0, None), ((1,), 1, 2), ((2,), 2, None), ((3,), 0, None)]
# 5 sets over 2 messages: n_b = 8, m_b = 4, so the marshal builds a grid
AGGREGATED = [((0,), 0, None), ((1, 2), 1, None), ((3,), 0, None),
              ((4,), 1, None), ((5,), 0, None)]


@pytest.fixture(scope="module")
def signed():
    return make_signed()


def _oracle(jsets, seed):
    saved = japi._BACKEND, japi._BACKEND_NAME
    japi.set_backend("cpu")
    try:
        return japi.verify_signature_sets(jsets, seed=seed)
    finally:
        japi._BACKEND, japi._BACKEND_NAME = saved


def _body(mb):
    return TB.verify_body(mb.u[mb.h_idx], mb.pk, mb.sig, mb.scalars, mb.real)


@pytest.mark.parametrize("spec,want", [(PARITY, True), (PARITY_FORGED, False)],
                         ids=["honest", "forged"])
def test_verify_body_verdict_equals_staged_and_oracle(signed, spec, want):
    jsets, tsets = both(signed, spec)
    mb = TB._marshal_batch(tsets, "cpu", seed=7)
    got = _body(mb)
    assert got.shape == () and got.dtype == torch.bool
    assert bool(got) is want
    assert bool(TB.run_marshalled(mb)) is want
    assert _oracle(jsets, seed=7) is want


def test_monolith_switch_takes_the_per_set_route_for_an_aggregated_batch(
        signed, monkeypatch):
    """LIGHTHOUSE_TPU_MONOLITH=1, read per call: the marshal still builds
    the grid, but the batch runs the monolith on per-set draws (u expanded
    by h_idx to n_b rows), with n_b + 1 Miller pairs counted and recorded
    on the launch ledger, and no aggregated batch counted -- as the JAX
    dispatcher does with the same batch (its `verify_jit` a spy, so
    nothing compiles)."""
    from lighthouse_tpu.obs import ledger as JLG
    from lighthouse_tpu.utils import compile_cache as CC
    from lighthouse_tpu.utils import metrics as JM

    jsets, tsets = both(signed, AGGREGATED)
    assert TB._marshal_batch(tsets, "cpu", seed=8).grid_idx is not None
    seen = []
    real = TB._monolith_graphs

    def spy(*args):
        seen.append([tuple(a.shape) for a in args])
        return real(*args)

    monkeypatch.setattr(TB, "_monolith_graphs", spy)
    monkeypatch.setenv("LIGHTHOUSE_TPU_MONOLITH", "1")
    ledger = LG.configure()
    agg_before = M.BLS_AGGREGATED_BATCHES.value
    out = TB.dispatch_verify_signature_sets(tsets, seed=8, device="cpu")
    assert bool(out) is True
    n_b = 8
    assert seen == [[(n_b, 2, 2, 35), (n_b, 4, 3, 35), (n_b, 3, 2, 35), (n_b, 2), (n_b,)]]
    assert M.BLS_MILLER_PAIRS_LAST.value == n_b + 1
    assert M.BLS_AGGREGATED_BATCHES.value == agg_before
    rec = [r for r in ledger.records() if r.kind == "dispatch"][-1]
    assert rec.miller_pairs == n_b + 1 and rec.real_sets == 5
    # the JAX dispatcher on the same batch (mesh route off, no disk cache)
    monkeypatch.setenv("LIGHTHOUSE_TPU_SHARD_MIN_SETS", "0")
    monkeypatch.setattr(CC, "_ARMED_DIR", None)
    jseen = []
    monkeypatch.setattr(jax_tpu, "verify_jit",
                        lambda *a: jseen.append([tuple(x.shape) for x in a]) or True)
    jledger = JLG.configure()
    jagg_before = JM.BLS_AGGREGATED_BATCHES.value
    assert jax_tpu.dispatch_verify_signature_sets(jsets, seed=8) is True
    assert jseen == seen
    assert JM.BLS_MILLER_PAIRS_LAST.value == M.BLS_MILLER_PAIRS_LAST.value
    assert JM.BLS_AGGREGATED_BATCHES.value == jagg_before
    jrec = [r for r in jledger.records() if r.kind == "dispatch"][-1]
    assert (jrec.miller_pairs, jrec.real_sets) == (rec.miller_pairs, rec.real_sets)


def test_stages_and_the_switch_as_the_jax_backend_has_them(monkeypatch):
    """STAGES names the per-set stages in the JAX backend's order; the
    monolith switch is on for "1" only, read per call."""
    assert [f.__name__ for f in TB.STAGES] == [f.__name__ for f in jax_tpu.STAGES]
    for value, on in (("1", True), ("0", False), ("true", False)):
        monkeypatch.setenv("LIGHTHOUSE_TPU_MONOLITH", value)
        assert TB._monolith_enabled() is on
    monkeypatch.delenv("LIGHTHOUSE_TPU_MONOLITH")
    assert not TB._monolith_enabled()


def test_verify_body_refuses_a_mesh_axis():
    z = torch.zeros(1)
    with pytest.raises(NotImplementedError, match="item 12"):
        TB.verify_body(z, z, z, z, z, axis_name="sets")


def test_warm_compile_does_not_warm_the_monolith(monkeypatch):
    """As jax_tpu.warm_compile: the staged routes only, switch or no."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_MONOLITH", "1")
    kinds = []
    saved = set(TB._seen_shape_buckets)
    try:
        TB.warm_compile(buckets=((4, 4, 4), (16, 4, 4)),
                        runner=lambda kind, args: kinds.append(kind), device="cpu")
    finally:
        TB._seen_shape_buckets.clear()
        TB._seen_shape_buckets.update(saved)
    assert kinds == ["staged", "aggregated"]


@pytest.mark.slow
@pytest.mark.parametrize("spec,want", [(PARITY, True), (PARITY_FORGED, False)],
                         ids=["honest", "forged"])
def test_verify_body_verdict_equals_jax_verify_jit(signed, spec, want):
    """jax_tpu.verify_jit on the JAX backend's marshalled batch (per-set
    draws) against the port's verify_body on its own: the same verdict."""
    jsets, tsets = both(signed, spec)
    jm = jax_tpu._marshal_batch(jsets, seed=9)
    import jax.numpy as jnp

    jv = bool(jax_tpu.verify_jit(jnp.take(jm.u, jm.h_idx, axis=0), jm.pk, jm.sig,
                                 jm.scalars, jm.real))
    assert jv is want
    assert bool(_body(TB._marshal_batch(tsets, "cpu", seed=9))) is want


@pytest.mark.gpu
@pytest.mark.parametrize("spec,want", [(PARITY, True), (PARITY_FORGED, False)],
                         ids=["honest", "forged"])
def test_monolith_graph_on_card_equals_cpu_and_staged(signed, spec, want):
    """The slow test's twin: the monolith as one graph on the card
    (captured, then replayed), its verdict equal to the CPU's and the
    staged route's, and a replay launching every kernel."""
    dev = need_card()
    _, tsets = both(signed, spec)
    mb = TB._marshal_batch(tsets, dev, seed=9)
    assert bool(TB.run_marshalled(mb, monolith=True)) is want  # captures
    K.reset_launches()
    assert bool(TB.run_marshalled(mb, monolith=True)) is want  # replays
    assert all(K.LAUNCHES.values())
    assert bool(TB.run_marshalled(mb)) is want
    assert bool(_body(TB._marshal_batch(tsets, "cpu", seed=9))) is want

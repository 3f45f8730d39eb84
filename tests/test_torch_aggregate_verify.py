"""The port's aggregate_verify (the spec's AggregateVerify) against
lighthouse_tpu's: verdicts against the JAX package's pure-Python cpu
oracle on honest, wrong-message and structural cases; _stage_agg_prep bit
for bit against jax_tpu's jitted stage; AggregatePublicKey's sum."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import adversary
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.crypto.bls.curve_ref import Point as TPoint
from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp as TFp

from torch_port_util import assert_same

MSGS = [b"aggregate-verify-%d" % i for i in range(3)]


@pytest.fixture(scope="module")
def signed():
    """Three keys, each signing its own message; the aggregate signature
    and the keys in both packages."""
    sks = [japi.SecretKey(515151 + 313 * i) for i in range(3)]
    jpks = [sk.public_key() for sk in sks]
    jsig = japi.AggregateSignature.aggregate(
        [sk.sign(m) for sk, m in zip(sks, MSGS)]).to_signature()
    tpks = [tapi.PublicKey.from_bytes(k.to_bytes()) for k in jpks]
    tsig = tapi.Signature.from_bytes(jsig.to_bytes())
    return jpks, jsig, tpks, tsig


@pytest.fixture
def cpu_backend(monkeypatch):
    """The port's api on the torch_cuda backend with the CPU as its device,
    restored after the test."""
    for name in ("_BACKEND", "_BACKEND_NAME", "_DEVICE"):
        monkeypatch.setattr(tapi, name, getattr(tapi, name))
    tapi.set_backend("torch_cuda", device="cpu")


def _oracle(sig, pks, msgs):
    saved = japi._BACKEND, japi._BACKEND_NAME
    japi.set_backend("cpu")
    try:
        return japi.aggregate_verify(sig, pks, msgs)
    finally:
        japi._BACKEND, japi._BACKEND_NAME = saved


@pytest.mark.parametrize("case", ["honest", "wrong_message"])
def test_verdict_matches_jax_cpu_oracle(signed, case):
    jpks, jsig, tpks, tsig = signed
    msgs = list(MSGS) if case == "honest" else [MSGS[0], b"not signed", MSGS[2]]
    want = _oracle(jsig, jpks, msgs)
    assert want is (case == "honest")
    assert tapi.aggregate_verify(tsig, tpks, msgs, device="cpu") is want


STRUCTURAL = {
    "length_mismatch": lambda api, pks, sig: (sig, pks, MSGS[:2]),
    "empty": lambda api, pks, sig: (sig, [], []),
    "infinity_signature": lambda api, pks, sig: (
        api.Signature.infinity(), pks, MSGS),
}


@pytest.mark.parametrize("case", sorted(STRUCTURAL))
def test_structural_verdicts_match_jax(signed, case, monkeypatch, cpu_backend):
    """Length mismatch, no pubkeys and an infinity signature are False in
    the api layer of both packages, before any device work."""
    jpks, jsig, tpks, tsig = signed
    jargs = STRUCTURAL[case](japi, jpks, jsig)
    targs = STRUCTURAL[case](tapi, tpks, tsig)

    def no_device(*a, **k):
        raise AssertionError("structural case reached the backend")

    monkeypatch.setattr(TB, "aggregate_verify", no_device)
    assert _oracle(*jargs) is False
    assert tapi.aggregate_verify(*targs) is False


def test_non_subgroup_pubkey_is_refused_before_the_device(signed):
    """key_validate runs first: a pubkey outside the r-torsion makes the
    verdict False with no device work, as in the JAX backend."""
    _, _, tpks, tsig = signed
    p = adversary.non_subgroup_g1_point()
    bad = tapi.PublicKey(TPoint(TFp(p.x.n), TFp(p.y.n)))
    assert TB.aggregate_verify(tsig, [tpks[0], bad], MSGS[:2], device="cpu") is False


def test_stage_agg_prep_bitexact_with_jax(signed):
    """_stage_agg_prep's five outputs equal jax_tpu's jitted stage at k_b = 4
    (three keys and one padding row)."""
    jpks, jsig, _, _ = signed
    pk = np.broadcast_to(TB._INF_G1, (4, 3, 35)).copy()
    for i, key in enumerate(jpks):
        pk[i] = jax_tpu._pk_limbs(key)
    sig = jax_tpu._sig_limbs(jsig)
    real = np.array([True, True, True, False])
    assert_same(jax_tpu._stage_agg_prep, TB._stage_agg_prep,
                pk, sig, real)


def test_aggregate_public_key_equals_jax(signed):
    jpks, _, tpks, _ = signed
    j = japi.AggregatePublicKey.aggregate(jpks).point
    t = tapi.AggregatePublicKey.aggregate(tpks).point
    assert (t.x.n, t.y.n, t.inf) == (j.x.n, j.y.n, j.inf)
    with pytest.raises(tapi.BlsError):
        tapi.AggregatePublicKey.aggregate([])


def test_entry_point_runs_on_the_backend_device(signed, monkeypatch, cpu_backend):
    """api.aggregate_verify hands the backend its device: the one set by
    set_backend unless the call names another."""
    _, _, tpks, tsig = signed
    seen = []
    monkeypatch.setattr(TB, "aggregate_verify",
                        lambda sig, pks, msgs, device=None: seen.append(device) or True)
    assert tapi.aggregate_verify(tsig, tpks, MSGS) is True
    assert tapi.aggregate_verify(tsig, tpks, MSGS, device=torch.device("cpu"))
    assert seen == ["cpu", torch.device("cpu")]

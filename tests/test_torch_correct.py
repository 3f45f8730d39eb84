"""The speculation correction of the port's backend, the device half of
speculate/precompute.py: `committee_table`, `set_committee_aggregates`,
`_speculate_device_enabled` and `correct_aggregate_device` over
`_stage_correct`, against jax_tpu's on the CPU.

A committee's full aggregate minus its absent members, for 1, 5 and 33
absent (absent-count buckets 4, 8 and 64): the same point as the host sum
of the present members (curve_ref) and as JAX's correction; None when
every member is absent; the committee table's limbs and the
SPECULATE_TABLE_BYTES gauge as JAX's."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu.utils import metrics as JM
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.utils import metrics as TM

from torch_port_util import need_card

N_MEMBERS = 40


@pytest.fixture(scope="module")
def committee():
    """40 members with small secret keys (cheap host scalar muls): the
    port's keys, the JAX package's keys, and each package's full
    aggregate as a public key."""
    scalars = [1009 + 13 * i for i in range(N_MEMBERS)]
    tkeys = [tapi.SecretKey(s).public_key() for s in scalars]
    jkeys = [japi.SecretKey(s).public_key() for s in scalars]
    tfull, jfull = tkeys[0].point, jkeys[0].point
    for t, j in zip(tkeys[1:], jkeys[1:]):
        tfull, jfull = tfull + t.point, jfull + j.point
    return (tkeys, tapi.PublicKey(tfull, subgroup_checked=True),
            jkeys, japi.PublicKey(jfull, subgroup_checked=True))


def _xy(p):
    return None if p is None else (p.x.n, p.y.n)


@pytest.mark.parametrize("k", [1, 5, 33])
def test_correct_aggregate_device_equals_host_and_jax(committee, k):
    tkeys, tfull, jkeys, jfull = committee
    want = tkeys[k].point
    for key in tkeys[k + 1:]:
        want = want + key.point
    got = TB.correct_aggregate_device(tfull, tkeys[:k], device="cpu")
    assert not got.inf and _xy(got) == _xy(want)
    assert _xy(jax_tpu.correct_aggregate_device(jfull, jkeys[:k])) == _xy(want)
    if k == 1:
        # every member of a 4-member committee absent (bucket 4 again):
        # the correction is infinity, and the caller aggregates on the host
        sub = tkeys[:4]
        full4 = tapi.PublicKey(sub[0].point + sub[1].point + sub[2].point
                               + sub[3].point, subgroup_checked=True)
        assert TB.correct_aggregate_device(full4, sub, device="cpu") is None
        jsub = jkeys[:4]
        jfull4 = japi.PublicKey(jsub[0].point + jsub[1].point + jsub[2].point
                                + jsub[3].point, subgroup_checked=True)
        assert jax_tpu.correct_aggregate_device(jfull4, jsub) is None


def test_stage_correct_bitexact_with_jax(committee):
    tkeys, tfull, _, _ = committee
    absent = np.broadcast_to(TB._INF_G1, (8, 3, 35)).copy()
    for i, key in enumerate(tkeys[:5]):
        absent[i] = TB._pk_limbs(key)
    real = np.arange(8) < 5
    full = TB._pk_limbs(tfull)
    want = jax_tpu._stage_correct(full, absent, real)
    got = TB._correct_graphs(*(torch.as_tensor(a) for a in (full, absent, real)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_set_committee_aggregates_table_and_gauge_equal_jax(committee):
    tkeys, _, jkeys, _ = committee
    TB.set_committee_aggregates(tkeys[:9], device="cpu")
    jax_tpu.set_committee_aggregates(jkeys[:9])
    table = TB.committee_table()
    assert len(table) == 9 and table.device.type == "cpu"
    np.testing.assert_array_equal(
        table.device_table().numpy(), np.asarray(jax_tpu.committee_table().device_table()))
    assert TM.SPECULATE_TABLE_BYTES.value == JM.SPECULATE_TABLE_BYTES.value == 16 * 3 * 35 * 4
    # rebuilt, not grown
    TB.set_committee_aggregates(tkeys[:2], device="cpu")
    assert len(TB.committee_table()) == 2


def test_committee_table_refuses_a_poisoned_key():
    """The table import is a key_validate seam: a key with a low-order
    component is refused, as by the validator table."""
    from lighthouse_tpu_torch.crypto.bls import adversary as TA

    bad = tapi.PublicKey(tapi.SecretKey(5).public_key().point + TA.low_order_g1_point())
    with pytest.raises(tapi.BlsError, match="key_validate"):
        TB.set_committee_aggregates([bad], device="cpu")


def test_speculate_device_switch_read_per_call(monkeypatch):
    monkeypatch.delenv("LIGHTHOUSE_TPU_SPECULATE_DEVICE", raising=False)
    assert not TB._speculate_device_enabled()
    assert not jax_tpu._speculate_device_enabled()
    monkeypatch.setenv("LIGHTHOUSE_TPU_SPECULATE_DEVICE", "1")
    assert TB._speculate_device_enabled() and jax_tpu._speculate_device_enabled()
    monkeypatch.setenv("LIGHTHOUSE_TPU_SPECULATE_DEVICE", "0")
    assert not TB._speculate_device_enabled()


@pytest.mark.gpu
def test_correct_aggregate_device_on_card_equals_cpu(committee):
    """On the card (one graph per absent-count bucket, captured, then
    replayed): the CPU's points, and None when every member is absent."""
    dev = need_card()
    tkeys, tfull, _, _ = committee
    for k in (1, 5, 33, 5):
        got = TB.correct_aggregate_device(tfull, tkeys[:k], device=dev)
        want = TB.correct_aggregate_device(tfull, tkeys[:k], device="cpu")
        assert _xy(got) == _xy(want)
    TB.set_committee_aggregates(tkeys[:9], device=dev)
    assert TB.committee_table().device_table().device.type == "cuda"

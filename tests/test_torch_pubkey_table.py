"""The device pubkey-table route of the port: backends/torch_cuda.py's
PubkeyTable, _common_table, prepack_indices and
_marshal_batch(index_pack=, pad_to=) against lighthouse_tpu's jax_tpu
counterparts, array for array, on the CPU; the table route's verdicts
against the JAX package's pure-Python cpu oracle; and the atomic
key_validate refusal of a bad import."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import adversary
from lighthouse_tpu.crypto.bls import aggregation as JAG
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import jax_tpu
from lighthouse_tpu.crypto.bls.curve_ref import Point as JPoint
from lighthouse_tpu_torch.crypto.bls import aggregation as TAG
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.crypto.bls.curve_ref import Point as TPoint
from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp as TFp

N_KEYS = 6
FIELDS = ("u", "h_idx", "pk", "sig", "scalars", "real", "grid_idx", "grid_real")


@pytest.fixture(scope="module")
def registry():
    """Six validators: JAX keys in a JAX PubkeyTable and the same keys,
    decoded from bytes, in the port's table on the CPU; both tagged with
    their validator index, as the chain's pubkey cache tags them."""
    sks = [japi.SecretKey(313131 + 977 * i) for i in range(N_KEYS)]
    jkeys = [sk.public_key() for sk in sks]
    tkeys = [tapi.PublicKey.from_bytes(k.to_bytes()) for k in jkeys]
    jtable, ttable = jax_tpu.PubkeyTable(), TB.PubkeyTable("cpu")
    jtable.import_new_pubkeys(jkeys)
    ttable.import_new_pubkeys(tkeys)
    for i, (jk, tk) in enumerate(zip(jkeys, tkeys)):
        jk.validator_index, jk.table = i, jtable
        tk.validator_index, tk.table = i, ttable
    return sks, jkeys, tkeys, jtable, ttable


def _sets(registry, spec, tagged=True):
    """spec: [(key indices, message, signed message or None)] -> (jax sets,
    port sets); a set signed over another message is a forgery. Untagged
    sets carry fresh untagged copies of the keys (the host-packed route)."""
    sks, jkeys, tkeys, _, _ = registry
    jsets, tsets = [], []
    for keys, msg, signed in spec:
        sig = japi.AggregateSignature.aggregate(
            [sks[i].sign(signed or msg) for i in keys]).to_signature()
        jk = [jkeys[i] for i in keys]
        tk = [tkeys[i] for i in keys]
        if not tagged:
            jk = [japi.PublicKey(k.point, subgroup_checked=True) for k in jk]
            tk = [tapi.PublicKey(k.point, subgroup_checked=True) for k in tk]
        jsets.append(japi.SignatureSet.multiple_pubkeys(sig, jk, msg))
        tsets.append(tapi.SignatureSet.multiple_pubkeys(
            tapi.Signature.from_bytes(sig.to_bytes()), tk, msg))
    return jsets, tsets


def _assert_marshalled_equal(jm, tm):
    for k in FIELDS:
        a, b = getattr(jm, k), getattr(tm, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), k
    assert (jm.n_sets, jm.n_messages) == (tm.n_sets, tm.n_messages)


def test_table_rows_and_gather_equal_jax(registry):
    """Bucketed (8, 3, W) table with G1-infinity padding, and a gather
    that clips out-of-range indices like jnp.take(mode="clip")."""
    _, _, _, jtable, ttable = registry
    assert len(ttable) == len(jtable) == N_KEYS
    dev = ttable.device_table()
    assert dev.shape == (8, 3, 35) and dev.dtype == torch.int32
    assert np.array_equal(np.asarray(jtable.device_table()), dev.numpy())
    idx = np.array([[0, 5], [7, 100], [-3, 2]], np.int32)
    got = ttable.gather(idx)
    assert got.shape == (3, 2, 3, 35)
    assert np.array_equal(np.asarray(jtable.gather(idx)), got.numpy())
    assert torch.equal(ttable.gather(torch.as_tensor(idx)), got)


MARSHAL_CASES = {
    # name: (spec, pad_to, prepack)
    "per_set": ([((0, 1), b"m0", None), ((2,), b"m1", None),
                 ((3, 4), b"m2", None)], None, False),
    "aggregated": ([((0,), b"m0", None), ((1, 2), b"m1", None),
                    ((3,), b"m0", None), ((4,), b"m1", None),
                    ((5,), b"m0", None)], None, True),
    "aggregated_pad_to_16": ([((0,), b"m0", None), ((1, 2), b"m1", None),
                              ((3,), b"m0", None), ((4,), b"m1", None),
                              ((5,), b"m0", None)], 16, True),
    # 6 messages: m_b = 8 lands strictly between 4 and n_b = 16, so the
    # warm-shape rule forces the per-set shape m_b = n_b
    "forced_per_set_pad_to_16": ([((i,), b"m%d" % i, None) for i in range(6)],
                                 16, True),
}


@pytest.mark.parametrize("tagged", [True, False], ids=["table", "host"])
@pytest.mark.parametrize("case", sorted(MARSHAL_CASES))
def test_marshal_batch_arrays_equal_jax(registry, case, tagged):
    """The same sets, seed and pad_to marshal to the same arrays in both
    packages, over the index-gather route (a JAX table against the port's)
    and over the host-packed route; a prepacked index pack at the natural
    bucket is repacked under pad_to."""
    spec, pad_to, prepack = MARSHAL_CASES[case]
    jsets, tsets = _sets(registry, spec, tagged=tagged)
    assert (TB._common_table(tsets) is not None) == tagged
    jpack = jax_tpu.prepack_indices(jsets) if prepack else None
    tpack = TB.prepack_indices(tsets) if prepack else None
    assert (jpack is None) == (tpack is None)
    if jpack is not None:
        for a, b in zip(jpack, tpack):
            assert np.array_equal(a, b) and a.dtype == b.dtype
    jm = jax_tpu._marshal_batch(jsets, seed=3, index_pack=jpack, pad_to=pad_to)
    tm = TB._marshal_batch(tsets, "cpu", seed=3, index_pack=tpack, pad_to=pad_to)
    _assert_marshalled_equal(jm, tm)
    if pad_to:
        assert tm.real.shape[0] == pad_to


def test_common_table_needs_one_table_for_every_key(registry):
    _, _, tkeys, _, ttable = registry
    _, tsets = _sets(registry, [((0, 1), b"m0", None), ((2,), b"m1", None)])
    assert TB._common_table(tsets) is ttable
    other = TB.PubkeyTable("cpu")
    stray = tapi.PublicKey(tkeys[2].point, subgroup_checked=True)
    stray.validator_index, stray.table = 0, other
    mixed = [tsets[0], tapi.SignatureSet.multiple_pubkeys(
        tsets[1].signature, [stray], tsets[1].message)]
    assert TB._common_table(mixed) is None
    assert TB.prepack_indices(mixed) is None
    untagged = tapi.PublicKey(tkeys[2].point, subgroup_checked=True)
    assert TB._common_table([tapi.SignatureSet.multiple_pubkeys(
        tsets[1].signature, [untagged], tsets[1].message)]) is None


def test_gather_needs_the_batch_device(registry):
    """No silent copy between devices: rows gathered on another device
    than the batch's raise."""
    _, tsets = _sets(registry, [((0,), b"m0", None)])

    class OtherDevice:
        def gather(self, idx):
            return torch.zeros(tuple(np.shape(idx)) + (3, 35), dtype=torch.int32,
                               device="meta")

    for key in tsets[0].pubkeys:
        key.table = OtherDevice()
    try:
        with pytest.raises(ValueError, match="pubkey table on meta"):
            TB._marshal_batch(tsets, "cpu", seed=1)
    finally:
        for key in tsets[0].pubkeys:
            key.table = registry[4]


@pytest.mark.parametrize("forged", [False, True], ids=["honest", "forged"])
def test_table_route_verdicts_match_jax_cpu_oracle(registry, forged):
    """Three sets over the table route: the port's verdict (the honest one
    through the pipeline's keyword duck type with groups, index_pack and
    pad_to=8, which takes the message-aggregated path) equals the JAX cpu
    oracle's."""
    spec = [((0, 1), b"m0", None), ((2,), b"m1", b"m2" if forged else None),
            ((3,), b"m0", None)]
    jsets, tsets = _sets(registry, spec)
    saved = japi._BACKEND, japi._BACKEND_NAME
    japi.set_backend("cpu")
    try:
        want = japi.verify_signature_sets(jsets, seed=9)
    finally:
        japi._BACKEND, japi._BACKEND_NAME = saved
    assert want is (not forged)
    if forged:
        got = tapi.verify_signature_sets(tsets, seed=9, device="cpu")
    else:
        groups = TAG.group_sets(tsets)
        assert groups.set_message == JAG.group_sets(jsets).set_message
        mb = TB._marshal_batch(tsets, "cpu", seed=9, pad_to=8)
        assert mb.grid_idx is not None and mb.real.shape[0] == 8
        got = bool(TB.dispatch_verify_signature_sets(
            tsets, seed=9, groups=groups, index_pack=TB.prepack_indices(tsets),
            pad_to=8, device="cpu"))
    assert got is want


@pytest.mark.parametrize("bad", ["infinity", "non_subgroup", "malformed"])
def test_bad_import_refused_atomically(registry, bad):
    """An import holding one infinity, non-subgroup or malformed key is
    refused whole, with BlsError, in both packages; the table keeps its
    length and its device rows."""
    _, jkeys, tkeys, _, _ = registry
    if bad == "infinity":
        p = jkeys[0].point
        jbad = japi.PublicKey(JPoint(p.x, p.y, True))
        tbad = tapi.PublicKey(TPoint(TFp(p.x.n), TFp(p.y.n), True))
    elif bad == "non_subgroup":
        p = adversary.non_subgroup_g1_point()
        jbad = japi.PublicKey(p)
        tbad = tapi.PublicKey(TPoint(TFp(p.x.n), TFp(p.y.n)))
    else:
        jbad = tbad = object()
    jtable, ttable = jax_tpu.PubkeyTable(), TB.PubkeyTable("cpu")
    jtable.import_new_pubkeys(jkeys[:2])
    ttable.import_new_pubkeys(tkeys[:2])
    before = ttable.device_table().clone()
    with pytest.raises(japi.BlsError, match="key_validate"):
        jtable.import_new_pubkeys([jkeys[2], jbad, jkeys[3]])
    with pytest.raises(tapi.BlsError, match="key_validate"):
        ttable.import_new_pubkeys([tkeys[2], tbad, tkeys[3]])
    assert len(ttable) == len(jtable) == 2
    assert torch.equal(ttable.device_table(), before)
    ttable.import_new_pubkeys(tkeys[2:4])
    assert len(ttable) == 4

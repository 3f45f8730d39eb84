"""The port's adversary layer (lighthouse_tpu_torch/crypto/bls/adversary.py)
against the JAX package's: the same probe bytes for one (family, seed),
and the port's paths rejecting every probe.

On the CPU (tier-1): every family's batches for seeds 0 and 1, the honest
control, the rogue-key feasibility batch and the speculation material are
byte-identical to the JAX module's; the first probe batch of each family
is rejected by the port's `cpu` and `torch_per_set` paths, and the honest
control accepted; each weakened verifier accepts its probe while the
sound oracle rejects it; the G1 low-order probe is refused at the
PubkeyTable import, and with key_validate off the table-gathered batch
verifies (the pairing cannot see the component); `mesh_grouped` raises,
and the speculation-poisoning audit reports nothing, as the JAX one does
(tests/test_torch_speculate.py holds it against a planted weak confirm
too). The full matrix over every batch is
`slow` on the CPU (a torch verify is ~8 s here), with a card twin."""

import functools

import pytest

from lighthouse_tpu.crypto.bls import adversary as JA
from lighthouse_tpu_torch.crypto.bls import adversary as TA
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB

from torch_port_util import need_card

pytestmark = pytest.mark.adversary


@functools.lru_cache(maxsize=None)
def _port_batches(family, seed):
    return TA.BATCHES[family](seed)


def _bytes(batch):
    return [(s.signature.to_bytes(), [k.to_bytes() for k in s.pubkeys],
             bytes(s.message)) for s in batch]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", sorted(JA.BATCHES))
def test_probe_batches_byte_identical_to_jax(family, seed):
    assert sorted(TA.BATCHES) == sorted(JA.BATCHES)
    got = [_bytes(b) for b in _port_batches(family, seed)]
    want = [_bytes(b) for b in JA.BATCHES[family](seed)]
    assert got == want and len(got) >= 2


def test_controls_and_material_byte_identical_to_jax():
    assert _bytes(TA.honest_sets(0)) == _bytes(JA.honest_sets(0))
    assert (_bytes(TA.rogue_key_feasibility_sets(0))
            == _bytes(JA.rogue_key_feasibility_sets(0)))
    assert TA.speculation_poison_material(0) == JA.speculation_poison_material(0)
    assert TA.FAMILIES == JA.FAMILIES
    assert TA.PATHS == ("cpu", "torch_per_set", "torch_aggregated",
                        "mesh_grouped", "fallback")


def test_honest_control_accepted_on_cpu_and_torch_per_set():
    sets = TA.honest_sets(0)
    assert TA.run_path("cpu", sets, seed=11) is True
    assert TA.run_path("torch_per_set", sets, seed=11, device="cpu") is True


@pytest.mark.parametrize("family", sorted(JA.BATCHES))
def test_first_probe_batch_rejected_on_cpu_and_torch_per_set(family):
    """The cpu oracle through `audit` (quick: the first batch), and the
    torch per-set path with LIGHTHOUSE_TPU_MSG_AGG pinned to 0 and
    restored."""
    import os

    batch = _port_batches(family, 0)[0]
    assert TA.audit([family], seed=0, quick=True) == []
    before = os.environ.get("LIGHTHOUSE_TPU_MSG_AGG")
    assert TA.run_path("torch_per_set", batch, seed=11, device="cpu") is False
    assert os.environ.get("LIGHTHOUSE_TPU_MSG_AGG") == before


@pytest.mark.parametrize("weakness,family,index", [
    ("constant_weight", "weight-collision", 0),
    ("zero_weight", "weight-collision", 2),
    ("related_weights", "weight-collision", 1),
    ("group_then_weight", "grouping-cancellation", 0),
])
def test_weakened_verifier_accepts_its_probe(weakness, family, index):
    batch = _port_batches(family, 0)[index]
    assert getattr(TA, "weakened_verify_" + weakness)(batch, seed=0) is True
    if index:  # the first batches' rejection is the test above
        assert TA.run_path("cpu", batch, seed=11) is False


def test_low_order_pubkey_refused_at_the_table_import(monkeypatch):
    """The subgroup family's first probe through the PubkeyTable route:
    the import refuses the poisoned key (and the wholly non-subgroup one
    of the second probe); with LIGHTHOUSE_TPU_KEY_VALIDATE=0, the planted
    weakness, the import takes it and the batch gathered from the table
    VERIFIES, since e(T, Q) == 1: only key_validate rejects it."""
    batches = _port_batches("subgroup", 0)
    for batch in batches[:2]:
        table = TB.PubkeyTable("cpu")
        with pytest.raises(tapi.BlsError, match="key_validate"):
            table.import_new_pubkeys([k for s in batch for k in s.pubkeys])
        assert len(table) == 0
    monkeypatch.setenv("LIGHTHOUSE_TPU_KEY_VALIDATE", "0")
    batch = batches[0]
    table = TB.PubkeyTable("cpu")
    keys = [k for s in batch for k in s.pubkeys]
    table.import_new_pubkeys(keys)
    tagged, n = [], 0
    for s in batch:
        tk = []
        for key in s.pubkeys:
            t = tapi.PublicKey(key.point)
            t.validator_index, t.table = n, table
            tk.append(t)
            n += 1
        tagged.append(tapi.SignatureSet.multiple_pubkeys(s.signature, tk, s.message))
    assert TB._marshal_batch(tagged, "cpu", seed=11) is not None
    assert TB.verify_signature_sets(tagged, seed=11, device="cpu") is True


def test_unreachable_paths_raise():
    sets = TA.honest_sets(0)
    with pytest.raises(RuntimeError, match="item 12"):
        TA.run_path("mesh_grouped", sets)
    assert TA.audit(["speculation-poisoning"]) == JA.audit(["speculation-poisoning"]) == []
    with pytest.raises(ValueError, match="unknown verification path"):
        TA.run_path("jax_per_set", sets)
    assert TA.audit(["no-such-family"]) == ["no-such-family: unknown probe family"]


def test_fallback_primary_really_failed_mid_trip():
    from lighthouse_tpu_torch.crypto.bls.backends import cpu
    from lighthouse_tpu_torch.crypto.bls.backends.fallback import FallbackBackend

    primary = TA._FailingPrimary()
    fb = FallbackBackend(primary=primary, fallback=cpu)
    assert fb.verify_signature_sets(TA.honest_sets(0), seed=11, device="cpu")
    assert primary.calls == 1


MATRIX_PATHS = ("cpu", "torch_per_set", "torch_aggregated", "fallback")


def _matrix(device):
    """Every family's batches for seed 0 and the honest control through
    the four reachable paths: every probe False, the control True, on
    every path."""
    rows = {"honest": TA.rejection_matrix(TA.honest_sets(0), seed=11,
                                          paths=MATRIX_PATHS, device=device)}
    assert rows["honest"] == {p: True for p in MATRIX_PATHS}
    for family in sorted(TA.BATCHES):
        for bi, batch in enumerate(_port_batches(family, 0)):
            m = TA.rejection_matrix(batch, seed=11 + bi, paths=MATRIX_PATHS,
                                    device=device)
            rows[f"{family}[{bi}]"] = m
            assert m == {p: False for p in MATRIX_PATHS}, (family, bi, m)
    return rows


@pytest.mark.slow
def test_full_matrix_on_the_cpu():
    _matrix("cpu")


@pytest.mark.gpu
def test_full_matrix_on_the_card():
    """The slow test's twin: the torch paths on the card, through the
    kernels and the stage graphs."""
    _matrix(need_card())

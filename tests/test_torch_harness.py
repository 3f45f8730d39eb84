"""The port's chain harness (lighthouse_tpu_torch/harness/{chain,
beacon_chain_harness}.py) against the JAX package's on the CPU:

- `BeaconChainHarness(16, MINIMAL, sign=False)` on both packages' `fake`
  backend (the port's chain on `device="cpu"`), extended a block at a time
  for 2 epochs: every produced block's SSZ bytes equal, and after every
  block the head root, head state root and justified and finalized
  checkpoints equal; a fork block on an older parent the same; the
  single-bit attestation and the signed aggregate the harness makes the
  same bytes;
- `BeaconChainHarness(16, sign=True)` on both packages' `cpu` backend:
  the block at slot 1 the same bytes, imported with VERIFY_BULK by both
  chains to the same head; a block at slot 2 with its first
  attestation's signature over a wrong root (chip_smoke.py's
  `forged_harness_block`) the same bytes, refused by both chains with the
  same error (`FORGED_BLOCK_ERROR`), the head kept.

The JAX side takes its public keys from the port's bytes
(`jax_keys_from_port`; its chain's pubkey cache decompresses them
without the subgroup check). No XLA compile."""

import importlib.util
from pathlib import Path

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.chain import BlockError as JBlockError
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.harness import BeaconChainHarness as JHarness
from lighthouse_tpu.state_transition import clone_state as jclone
from lighthouse_tpu.state_transition import process_slots as jslots
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain import BlockError as TBlockError
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import BeaconChainHarness
from lighthouse_tpu_torch.ssz import cached_root
from lighthouse_tpu_torch.state_transition import BlockSignatureStrategy
from lighthouse_tpu_torch.state_transition import clone_state, process_slots
from torch_port_util import jax_keys_from_port, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

N = 16
SPE = T.MINIMAL.slots_per_epoch


@pytest.fixture(autouse=True)
def _backends(monkeypatch):
    jax_keys_from_port(monkeypatch)
    monkeypatch.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _recording(harness):
    """Record every block the harness's producer makes."""
    made, produce = [], harness.producer.produce_block

    def produce_block(*args, **kwargs):
        out = produce(*args, **kwargs)
        made.append(out[0])
        return out

    harness.producer.produce_block = produce_block
    return made


def _view(chain, state_root):
    return (chain.head_root, state_root, tuple(chain.justified_checkpoint),
            tuple(chain.finalized_checkpoint))


def test_beacon_chain_harness_equals_jax_block_by_block():
    japi.set_backend("fake")
    tapi.set_backend("fake")
    th = BeaconChainHarness(N, T.MINIMAL, T.ChainSpec.minimal(), device="cpu")
    jh = JHarness(N, J.MINIMAL, J.ChainSpec.minimal())
    assert th.strategy is BlockSignatureStrategy.NO_VERIFICATION
    assert th.producer.state.as_ssz_bytes() == jh.producer.state.as_ssz_bytes()
    tmade, jmade = _recording(th), _recording(jh)
    for _ in range(2 * SPE):
        troot, jroot = th.extend_chain(1), jh.extend_chain(1)
        assert troot == jroot
        assert tmade[-1].as_ssz_bytes() == jmade[-1].as_ssz_bytes()
        assert _view(th.chain, cached_root(th.chain.head_state)) == _view(
            jh.chain, jh.chain.head_state.tree_hash_root())
    assert th.finalized_epoch() == jh.finalized_epoch()
    # a fork on the block two back, then the same unaggregated and aggregate
    parent = tmade[-3].message.tree_hash_root()
    slot = int(th.chain.head_state.slot) + 1
    assert th.add_block_at_slot(slot, parent_root=parent) == jh.add_block_at_slot(
        slot, parent_root=parent)
    assert tmade[-1].as_ssz_bytes() == jmade[-1].as_ssz_bytes()
    assert _view(th.chain, cached_root(th.chain.head_state)) == _view(
        jh.chain, jh.chain.head_state.tree_hash_root())
    ts = process_slots(clone_state(th.chain.head_state), slot + 1, T.MINIMAL, th.spec)
    js = jslots(jclone(jh.chain.head_state), slot + 1, J.MINIMAL, jh.spec)
    assert (th.producer.make_unaggregated(ts, slot, 0, 2).as_ssz_bytes()
            == jh.producer.make_unaggregated(js, slot, 0, 2).as_ssz_bytes())
    assert (th.producer.make_signed_aggregate(ts, slot, 0).as_ssz_bytes()
            == jh.producer.make_signed_aggregate(js, slot, 0).as_ssz_bytes())


def test_signed_blocks_equal_jax_and_a_forged_one_fails_alike():
    japi.set_backend("cpu")
    tapi.set_backend("cpu")
    th = BeaconChainHarness(N, T.MINIMAL, T.ChainSpec.minimal(), sign=True, device="cpu")
    jh = JHarness(N, J.MINIMAL, J.ChainSpec.minimal(), sign=True)
    assert th.strategy is BlockSignatureStrategy.VERIFY_BULK
    tmade, jmade = _recording(th), _recording(jh)
    assert th.add_block_at_slot(1) == jh.add_block_at_slot(1)
    assert tmade[-1].as_ssz_bytes() == jmade[-1].as_ssz_bytes()
    # block 2 with attestation 0 signed over a wrong root: both chains
    # refuse it with the same error and keep their head
    C = CS.consensus_modules()
    forged, parent = CS.forged_harness_block(C, th, 2)
    js = jslots(jclone(jh.chain.head_state), 2, J.MINIMAL, jh.spec)
    jatts = jh.producer.attestations_for_slot(js, 1)
    jatts[0].signature = bytes(forged.message.body.attestations[0].signature)
    jforged, _ = jh.producer.produce_block(2, jatts, base_state=jh.chain._states[parent])
    assert jforged.as_ssz_bytes() == forged.as_ssz_bytes()
    errors = []
    for h, block, err in ((th, forged, TBlockError), (jh, jforged, JBlockError)):
        h.chain.slot_clock.set_slot(2)
        with pytest.raises(err) as e:
            h.chain.process_block(block, strategy=h.strategy)
        errors.append(str(e.value))
        assert h.chain.head_root == parent
    assert errors == [CS.FORGED_BLOCK_ERROR] * 2

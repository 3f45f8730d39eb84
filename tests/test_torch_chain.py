"""The port's BeaconChain and its block pipelines
(lighthouse_tpu_torch/chain/{beacon_chain,block_verification,state_cache,
early_attester_cache}.py over store/ and fork_choice/) against the JAX
package's on the CPU:

- the JAX BeaconChainHarness (MINIMAL, 64 validators, altair at genesis)
  runs 4 epochs with a fork and a reorg; the port's chain (`device="cpu"`),
  fed the same blocks as SSZ bytes, has after every block the JAX chain's
  head root, head state root and justified and finalized checkpoints,
  finalized epoch >= 1 at the end;
- a duplicate import is a no-op; `from_store` over the port's store
  resumes at the same head; unknown parent, a future slot and a wrong
  state_root raise the JAX chain's BlockError text;
- the pipelines' backend calls, spied on both packages' `fake` backend:
  `process_gossip_block` makes 2 (the proposal alone, then the rest) and
  `signature_verify_chain_segment` 1 over the whole segment, each with
  the JAX call's set count and messages.

The JAX side takes its public keys from the port's bytes
(`jax_keys_from_port`, and its chain's pubkey cache decompresses them
without the subgroup check). No XLA compile."""

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.chain import BlockError as JBlockError
from lighthouse_tpu.chain import block_verification as JBV
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import fake as JFAKE
from lighthouse_tpu.harness import BeaconChainHarness
from lighthouse_tpu.state_transition import BlockSignatureStrategy as JStrategy
from lighthouse_tpu.state_transition import per_slot as JPS
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain import BeaconChain
from lighthouse_tpu_torch.chain import BlockError as TBlockError
from lighthouse_tpu_torch.chain import block_verification as TBV
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import fake as TFAKE
from lighthouse_tpu_torch.ssz import cached_root
from lighthouse_tpu_torch.state_transition import BlockSignatureStrategy
from lighthouse_tpu_torch.store.hot_cold import HotColdDB
from lighthouse_tpu_torch.store.kv import MemoryStore
from lighthouse_tpu_torch.utils import metrics as TM
from torch_port_util import carry_block, carry_state, jax_keys_from_port, no_xla_compile

N_VALIDATORS = 64
SPE = J.MINIMAL.slots_per_epoch
EPOCHS = 4
FORK_AT = 12  # the block at FORK_AT + 1 is orphaned by a fork on FORK_AT


def _jax_chain_keys(mp):
    jax_keys_from_port(mp)
    mp.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)


@pytest.fixture(autouse=True)
def _backends(monkeypatch):
    _jax_chain_keys(monkeypatch)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _view(chain, head_state_root):
    return (chain.head_root, head_state_root, chain.justified_checkpoint,
            chain.finalized_checkpoint)


def _port_view(chain):
    return _view(chain, cached_root(chain.head_state))


def _jax_view(chain):
    return _view(chain, chain.head_state.tree_hash_root())


def _port_import(chain, jax_block):
    chain.slot_clock.set_slot(int(jax_block.message.slot))
    return chain.process_block(carry_block(jax_block, J.MINIMAL),
                               strategy=BlockSignatureStrategy.NO_VERIFICATION)


@pytest.fixture(scope="module")
def run():
    """The JAX harness chain over EPOCHS epochs, with a fork on FORK_AT
    that wins (a reorg), and the port's chain fed each block as it is
    made: (harness, port chain, [(slot, jax view, port view)], roots)."""
    saved = (japi._BACKEND, japi._BACKEND_NAME, tapi._BACKEND,
             tapi._BACKEND_NAME, tapi._DEVICE)
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        _jax_chain_keys(mp)
        japi.set_backend("fake")
        tapi.set_backend("fake")
        try:
            h = BeaconChainHarness(N_VALIDATORS, J.MINIMAL,
                                   J.ChainSpec.interop(altair_fork_epoch=0))
            tspec = T.ChainSpec.interop(altair_fork_epoch=0)
            chain = BeaconChain(HotColdDB(MemoryStore(), T.MINIMAL, tspec),
                                carry_state(h.producer.state, J.MINIMAL),
                                T.MINIMAL, tspec, device="cpu")
            views, roots = [], {}

            def add(slot, parent=None):
                root = h.add_block_at_slot(slot, parent_root=parent)
                roots[slot] = root
                assert _port_import(chain, h.store.get_block(root)) == root
                views.append((slot, _jax_view(h.chain), _port_view(chain)))

            for slot in range(1, FORK_AT + 2):
                add(slot)
            # the fork: two blocks on FORK_AT, skipping FORK_AT + 1
            add(FORK_AT + 2, roots[FORK_AT])
            add(FORK_AT + 3, roots[FORK_AT + 2])
            for slot in range(FORK_AT + 4, EPOCHS * SPE + 1):
                add(slot)
        finally:
            (japi._BACKEND, japi._BACKEND_NAME, tapi._BACKEND,
             tapi._BACKEND_NAME, tapi._DEVICE) = saved
    return h, chain, views, roots


def test_chain_matches_jax_after_every_block(run):
    h, chain, views, roots = run
    for slot, jview, tview in views:
        assert tview == jview, slot
    heads = [v[1][0] for v in views]
    # the fork took the head from the block at FORK_AT + 1 for good
    assert roots[FORK_AT + 1] in heads
    assert roots[FORK_AT + 1] not in heads[heads.index(roots[FORK_AT + 1]) + 1:]
    assert chain.head_root == h.chain.head_root == heads[-1]
    assert chain.finalized_checkpoint[0] >= 1
    assert h.chain.finalized_checkpoint[0] >= 1


def test_duplicate_import_is_a_noop(run):
    h, chain, views, roots = run
    imported, before = TM.BLOCKS_IMPORTED.value, _port_view(chain)
    assert _port_import(chain, h.store.get_block(roots[EPOCHS * SPE])) == roots[EPOCHS * SPE]
    assert TM.BLOCKS_IMPORTED.value == imported
    assert _port_view(chain) == before


def test_from_store_resumes_at_the_same_head(run):
    h, chain, views, roots = run
    tspec = T.ChainSpec.interop(altair_fork_epoch=0)
    resumed = BeaconChain.from_store(chain.store, T.MINIMAL, tspec, device="cpu")
    assert resumed.head_root == chain.head_root == h.chain.head_root
    assert cached_root(resumed.head_state) == cached_root(chain.head_state)
    assert resumed.pubkey_cache._device == "cpu"


def _bad_block(h, case):
    """A block on the head at the next slot, broken as `case` says."""
    slot = h.chain.head_state.slot + 1
    signed, _ = h.producer.produce_block(slot, base_state=h.chain.head_state)
    if case == "unknown_parent":
        signed.message.parent_root = b"\x5a" * 32
    elif case == "state_root":
        signed.message.state_root = b"\x5a" * 32
    return signed


@pytest.mark.parametrize("case", ["unknown_parent", "future_slot", "state_root"])
def test_rejected_block_raises_the_same_block_error(run, case):
    h, chain, views, roots = run
    jblock = _bad_block(h, case)
    clock = int(jblock.message.slot) - (case == "future_slot")
    errors = []
    for c, block, err, strategy in (
            (h.chain, jblock, JBlockError, JStrategy.NO_VERIFICATION),
            (chain, carry_block(jblock, J.MINIMAL), TBlockError,
             BlockSignatureStrategy.NO_VERIFICATION)):
        c.slot_clock.set_slot(clock)
        before = c.head_root
        with pytest.raises(err) as e:
            c.process_block(block, strategy=strategy)
        assert c.head_root == before
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _spy(mp, module):
    calls = []
    real = module.verify_signature_sets

    def spy(sets, *a, **kw):
        calls.append([bytes(s.message) for s in sets])
        return real(sets, *a, **kw)

    mp.setattr(module, "verify_signature_sets", spy)
    return calls


def test_pipelines_make_the_jax_calls(run, monkeypatch):
    """A gossip block, then a segment of three, on both chains' heads."""
    h, chain, views, roots = run
    jcalls, tcalls = _spy(monkeypatch, JFAKE), _spy(monkeypatch, TFAKE)
    blocks, state = [], h.chain.head_state
    for slot in range(EPOCHS * SPE + 1, EPOCHS * SPE + 5):
        adv = JPS.process_slots(JPS.clone_state(state), slot, h.preset, h.spec)
        signed, state = h.producer.produce_block(
            slot, h.producer.attestations_for_slot(adv, slot - 1), base_state=state)
        blocks.append(signed)
    for c in (h.chain, chain):
        c.slot_clock.set_slot(EPOCHS * SPE + 4)
    assert (TBV.process_gossip_block(chain, carry_block(blocks[0], J.MINIMAL))
            == JBV.process_gossip_block(h.chain, blocks[0]))
    assert len(jcalls) == 2 and len(jcalls[0]) == 1 and len(jcalls[1]) > 1
    assert tcalls == jcalls
    del jcalls[:], tcalls[:]
    jseg = JBV.signature_verify_chain_segment(h.chain, blocks[1:])
    tseg = TBV.signature_verify_chain_segment(
        chain, [carry_block(b, J.MINIMAL) for b in blocks[1:]])
    assert len(jcalls) == 1 and len(jcalls[0]) > 3 * 3
    assert tcalls == jcalls
    for jv, tv in zip(jseg, tseg):
        assert tv.import_into(chain) == jv.import_into(h.chain)
    assert _port_view(chain) == _jax_view(h.chain)
    assert chain.head_root == blocks[-1].message.tree_hash_root()

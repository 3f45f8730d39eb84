"""The port's signature-set builders and BlockSignatureVerifier
(lighthouse_tpu_torch/state_transition) against the JAX package's, on
blocks of a signed MINIMAL chain that the JAX harness builds
(`StateHarness(..., sign=True)`, the producer under BeaconChainHarness)
and that reach the port as SSZ bytes with their parent states:

- every set of `include_all_signatures`, in order, has the JAX set's
  pubkey bytes, message and signature bytes (phase0 blocks with
  attestations, and an altair block with a sync aggregate);
- one backend call per block on both packages' `fake` backend;
- the same verdicts on both `cpu` backends: honest True, one attestation
  under another committee's signature False;
- with the port's ValidatorPubkeyCache as the key source every set is
  table-tagged, and `torch_cuda._marshal_batch(device="cpu")` gathers the
  pk rows that host packing gives.

The JAX side takes its public keys from the port's bytes
(`jax_keys_from_port`). No XLA compile."""

import pytest
import torch

from lighthouse_tpu import types as J
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.backends import fake as JFAKE
from lighthouse_tpu.harness.chain import StateHarness
from lighthouse_tpu.state_transition import per_slot as JPS
from lighthouse_tpu.state_transition.block_signature_verifier import (
    BlockSignatureVerifier as JBSV,
)
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.chain.pubkey_cache import ValidatorPubkeyCache
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.backends import fake as TFAKE
from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from lighthouse_tpu_torch.state_transition.block_signature_verifier import (
    BlockSignatureVerifier as TBSV,
)
from torch_port_util import carry_block, carry_state, jax_keys_from_port, no_xla_compile

N_VALIDATORS = 64


@pytest.fixture(autouse=True)
def _backends(monkeypatch):
    jax_keys_from_port(monkeypatch)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


@pytest.fixture(scope="module")
def blocks():
    """[(jax parent state, jax signed block)] for slots 1 and 2 of a phase0
    chain (the block at 2 carries slot 1's two attestations), and one
    altair block at slot 1 with a sync aggregate of five members."""
    saved = (japi._BACKEND, japi._BACKEND_NAME)
    out = []
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        jax_keys_from_port(mp)
        japi.set_backend("fake")
        try:
            h = StateHarness(N_VALIDATORS, J.MINIMAL, J.ChainSpec.interop(), sign=True)
            for _ in range(2):
                parent = JPS.clone_state(h.state)
                h.extend_chain(1)
                out.append((parent, h.blocks[-1]))
            out.append(_altair_block())
        finally:
            japi._BACKEND, japi._BACKEND_NAME = saved
    return out


def _altair_block():
    spec = J.ChainSpec.interop(altair_fork_epoch=0)
    parent = J.interop_genesis_state(N_VALIDATORS, J.MINIMAL, spec)
    state = JPS.process_slots(JPS.clone_state(parent), 1, J.MINIMAL, spec)
    t = J.types_for(J.MINIMAL)
    block = t.SignedBeaconBlockAltair.default()
    msg = block.message
    msg.slot = 1
    msg.proposer_index = JPS.get_beacon_proposer_index(state, J.MINIMAL, spec)
    msg.parent_root = state.latest_block_header.tree_hash_root()
    sig = japi.SecretKey(97).sign(b"any valid point").to_bytes()
    block.signature = msg.body.randao_reveal = sig
    bits = [False] * J.MINIMAL.sync_committee_size
    for i in (0, 3, 4, 17, 31):
        bits[i] = True
    msg.body.sync_aggregate = t.SyncAggregate(
        sync_committee_bits=tuple(bits), sync_committee_signature=sig)
    return parent, block


def _spec(pkg, block):
    altair = 0 if block.fork_name == "altair" else None
    return pkg.ChainSpec.interop(altair_fork_epoch=altair)


def _jax_sets(parent, block):
    state = JPS.process_slots(JPS.clone_state(parent), block.message.slot,
                              J.MINIMAL, _spec(J, block))
    v = JBSV(state, J.MINIMAL, _spec(J, block))
    v.include_all_signatures(block)
    return v


def _port_verifier(parent, block, **kw):
    spec = _spec(T, block)
    state = TPS.process_slots(carry_state(parent, J.MINIMAL), block.message.slot,
                              T.MINIMAL, spec)
    return TBSV(state, T.MINIMAL, spec, **kw), state


def _as_bytes(s):
    return ([pk.to_bytes() for pk in s.pubkeys], bytes(s.message), s.signature.to_bytes())


@pytest.mark.parametrize("i", range(3))
def test_block_sets_equal_jax_in_order(blocks, i):
    parent, jblock = blocks[i]
    jv = _jax_sets(parent, jblock)
    tv, _ = _port_verifier(parent, jblock)
    tv.include_all_signatures(carry_block(jblock, J.MINIMAL))
    assert [_as_bytes(s) for s in tv.sets] == [_as_bytes(s) for s in jv.sets]
    want = {0: 2, 1: 4, 2: 3}[i]  # proposal, randao, attestations, sync
    assert len(tv.sets) == want
    if i == 2:
        assert len(tv.sets[-1].pubkeys) == 5


def test_one_fake_backend_call_per_block(blocks, monkeypatch):
    calls = {"jax": 0, "torch": 0}

    def counting(pkg, fn):
        def verify(sets, *a, **kw):
            calls[pkg] += 1
            return fn(sets, *a, **kw)
        return verify

    monkeypatch.setattr(JFAKE, "verify_signature_sets",
                        counting("jax", JFAKE.verify_signature_sets))
    monkeypatch.setattr(TFAKE, "verify_signature_sets",
                        counting("torch", TFAKE.verify_signature_sets))
    japi.set_backend("fake")
    tapi.set_backend("fake")
    for n, (parent, jblock) in enumerate(blocks, start=1):
        jv = _jax_sets(parent, jblock)
        tv, _ = _port_verifier(parent, jblock)
        tv.include_all_signatures(carry_block(jblock, J.MINIMAL))
        slot = int(jblock.message.slot)
        assert tv.verify(slot=slot) is True and jv.verify(slot=slot) is True
        assert calls == {"jax": n, "torch": n}


def _forged(block):
    """The block with its first attestation under the second one's
    signature (another committee's data)."""
    forged = type(block).from_ssz_bytes(block.as_ssz_bytes())
    atts = list(forged.message.body.attestations)
    atts[0].signature = atts[1].signature
    forged.message.body.attestations = tuple(atts)
    return forged


def test_cpu_backends_agree_on_honest_and_forged_blocks(blocks):
    """The slot-2 block (proposal, randao, two attestations of four
    keys)."""
    parent, jblock = blocks[1]
    japi.set_backend("cpu")
    tapi.set_backend("cpu")
    for block, want in ((jblock, True), (_forged(jblock), False)):
        jv = _jax_sets(parent, block)
        tv, _ = _port_verifier(parent, block)
        tv.include_all_signatures(carry_block(block, J.MINIMAL))
        assert tv.verify(slot=2) is want
        assert jv.verify(slot=2) is want


@pytest.mark.parametrize("i", [1, 2])
def test_pubkey_cache_tags_every_key_and_gathers_the_host_rows(blocks, i):
    torch.set_num_threads(1)
    parent, jblock = blocks[i]
    tblock = carry_block(jblock, J.MINIMAL)
    plain, state = _port_verifier(parent, jblock)
    plain.include_all_signatures(tblock)
    cache = ValidatorPubkeyCache(state, device="cpu")
    tagged, _ = _port_verifier(parent, jblock, get_pubkey=cache.getter(state),
                               resolve_pubkey=cache.resolve)
    tagged.include_all_signatures(tblock)
    assert [_as_bytes(s) for s in tagged.sets] == [_as_bytes(s) for s in plain.sets]
    assert TB._common_table(tagged.sets) is cache
    assert TB._common_table(plain.sets) is None
    gathered = TB._marshal_batch(tagged.sets, "cpu", seed=3)
    packed = TB._marshal_batch(plain.sets, "cpu", seed=3)
    assert gathered.pk.device.type == "cpu"
    assert torch.equal(gathered.pk, packed.pk)
    assert torch.equal(gathered.sig, packed.sig) and torch.equal(gathered.u, packed.u)

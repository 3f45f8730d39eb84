"""The port's builder (lighthouse_tpu_torch/execution_layer/builder.py) and
the beacon node's block production (validator_client/beacon_node.py)
against the JAX package's on the CPU, byte for byte:

- `MockBuilder` bids in both packages over the same engine state: equal
  SignedBuilderBid bytes; `verify_bid` on both packages' `cpu` oracle
  accepts the bid and refuses it with its value raised ("bad builder bid
  signature"), and refuses a bid from an unpinned key alike;
- tests/test_builder.py's blinded flow on both packages' `fake` backend
  (bellatrix from epoch 1): registrations over a BuilderHttpServer,
  `InProcessBeaconNode.produce_blinded_block` on the bid, the signed
  blinded block unblinded and imported: equal blinded blocks and heads;
  no bid before registration, a refused reveal and a corrupted header
  fail alike; a signed registration the same bytes;
- the beacon node's duties (proposers, attesters) on the same chain.

Every server is stopped in `finally`; every client has a short timeout.
A `gpu`-marked test checks a bid on the card. No XLA compile."""

import pytest

from lighthouse_tpu import execution_layer as JX
from lighthouse_tpu import types as J
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.harness import BeaconChainHarness as JHarness
from lighthouse_tpu.types import containers as JCT
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu.validator_client.beacon_node import InProcessBeaconNode as JNode
from lighthouse_tpu_torch import execution_layer as X
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import BeaconChainHarness
from lighthouse_tpu_torch.types import containers as CT
from lighthouse_tpu_torch.validator_client import InProcessBeaconNode
from torch_port_util import jax_keys_from_port, need_card, no_xla_compile

SPE = T.MINIMAL.slots_per_epoch
BUILDER_KEY, PROPOSER_KEY = 7, 11


@pytest.fixture(autouse=True)
def _backends(monkeypatch):
    jax_keys_from_port(monkeypatch)
    monkeypatch.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _bids():
    """(package, engine, bid) for both packages: a builder keyed by
    SecretKey(7) bids on the mock engine's genesis for a proposer keyed
    by SecretKey(11); the JAX side is handed the port's registration."""
    out = []
    reg = None
    for pkg, XX, api in ((T, X, tapi), (J, JX, japi)):
        spec = pkg.ChainSpec.interop()
        engine = XX.MockExecutionEngine(pkg.types_for(pkg.MINIMAL))
        builder = XX.MockBuilder(XX.ExecutionLayer(engine), pkg.MINIMAL, spec,
                                 secret_key=api.SecretKey(BUILDER_KEY))
        if reg is None:
            reg = X.make_validator_registration(
                tapi.SecretKey(PROPOSER_KEY), b"\xaa" * 20, 30_000_000, 5, spec)
        builder.register_validators([reg if pkg is T else
                                     JCT.SignedValidatorRegistration.from_ssz_bytes(
                                         reg.as_ssz_bytes())])
        bid = builder.get_header(1, engine.genesis_hash, bytes(reg.message.pubkey))
        out.append((pkg, XX, engine, spec, builder, bid))
    return out


def test_bids_equal_jax_and_verify_alike_on_the_cpu_oracle():
    (_, _, te, tspec, tb, tbid), (_, _, je, jspec, jb, jbid) = _bids()
    assert tbid.as_ssz_bytes() == jbid.as_ssz_bytes()
    assert tb.pubkey.to_bytes() == jb.pubkey.to_bytes()
    japi.set_backend("cpu")
    tapi.set_backend("cpu")
    X.verify_bid(tbid, tspec, te.genesis_hash, trusted_pubkey=tb.pubkey.to_bytes())
    JX.verify_bid(jbid, jspec, je.genesis_hash, trusted_pubkey=jb.pubkey.to_bytes())
    errors = []
    for XX, bid, spec, engine in ((X, tbid, tspec, te), (JX, jbid, jspec, je)):
        bid.message.value = int(bid.message.value) + 1
        with pytest.raises(XX.BuilderError) as e:
            XX.verify_bid(bid, spec, engine.genesis_hash)
        errors.append(str(e.value))
        with pytest.raises(XX.BuilderError) as e:
            XX.verify_bid(bid, spec, engine.genesis_hash,
                          trusted_pubkey=tapi.SecretKey(666).public_key().to_bytes())
        errors.append(str(e.value))
        with pytest.raises(XX.BuilderError) as e:
            XX.verify_bid(bid, spec, b"\x01" * 32)
        errors.append(str(e.value))
    assert errors[:3] == errors[3:] == [
        "bad builder bid signature", "bid signed by an unexpected builder key",
        "bid builds on the wrong parent"]


def _rig(pkg, XX, harness, kwargs):
    """A harness chain merged at epoch 1 (16 validators, sign=False) and a
    mock builder behind HTTP, with its client (a short timeout)."""
    engine = XX.MockExecutionEngine(pkg.types_for(pkg.MINIMAL))
    el = XX.ExecutionLayer(engine)
    spec = pkg.ChainSpec.interop(altair_fork_epoch=0, bellatrix_fork_epoch=1)
    h = harness(16, pkg.MINIMAL, spec, execution_layer=el, **kwargs)
    h.extend_chain(SPE + 1)
    builder = XX.MockBuilder(el, pkg.MINIMAL, spec, chain=h.chain)
    server = XX.BuilderHttpServer(builder).start()
    client = XX.BuilderHttpClient(server.url, pkg.MINIMAL, timeout_s=2.0,
                                  trusted_pubkey=builder.pubkey.to_bytes())
    return h, builder, server, client


def test_blinded_flow_equals_jax():
    results = []
    for pkg, XX, CC, harness, node, api in (
            (T, X, CT, BeaconChainHarness, InProcessBeaconNode, tapi),
            (J, JX, JCT, JHarness, JNode, japi)):
        kwargs = dict(device="cpu") if pkg is T else {}
        h, builder, server, client = _rig(pkg, XX, harness, kwargs)
        try:
            assert h.chain.head_state.fork_name == "bellatrix"
            bn = node(h.chain)
            bn.builder = client
            slot = int(h.chain.head_state.slot) + 1
            h.chain.slot_clock.set_slot(slot)
            # nobody registered yet: no bid, the caller produces locally
            with pytest.raises(XX.NoBidAvailable):
                bn.produce_blinded_block(slot, api.INFINITY_SIGNATURE)
            # every validator registers over HTTP (the mock builder checks
            # no registration signature, as the reference's mock)
            client.register_validators([CC.SignedValidatorRegistration(
                message=CC.ValidatorRegistrationV1(
                    fee_recipient=b"\xfe" * 20, gas_limit=30_000_000, timestamp=1234,
                    pubkey=bytes(v.pubkey)), signature=api.INFINITY_SIGNATURE)
                for v in h.chain.head_state.validators])
            blinded = bn.produce_blinded_block(slot, api.INFINITY_SIGNATURE)
            t = pkg.types_for(pkg.MINIMAL)
            signed = t.SignedBlindedBeaconBlock(message=blinded,
                                                signature=api.INFINITY_SIGNATURE)
            builder.refuse_reveal = True
            head0 = h.chain.head_root
            with pytest.raises(XX.BuilderError):
                bn.publish_blinded_block(signed)
            assert h.chain.head_root == head0
            builder.refuse_reveal = False
            root = bn.publish_blinded_block(signed)
            assert h.chain.head_root == root
            builder.corrupt_header = True
            h.chain.slot_clock.set_slot(slot + 1)
            bad = bn.produce_blinded_block(slot + 1, api.INFINITY_SIGNATURE)
            with pytest.raises(XX.BuilderError, match="does not match"):
                bn.publish_blinded_block(t.SignedBlindedBeaconBlock(
                    message=bad, signature=api.INFINITY_SIGNATURE))
            results.append((blinded.as_ssz_bytes(), root, bad.as_ssz_bytes(),
                            len(builder.registrations)))
        finally:
            server.stop()
    assert results[0] == results[1]
    assert results[0][3] == 16


def test_validator_registration_equals_jax():
    reg = X.make_validator_registration(tapi.SecretKey(PROPOSER_KEY), b"\xaa" * 20,
                                        30_000_000, 5, T.ChainSpec.interop())
    jreg = JX.make_validator_registration(japi.SecretKey(PROPOSER_KEY), b"\xaa" * 20,
                                          30_000_000, 5, J.ChainSpec.interop())
    assert reg.as_ssz_bytes() == jreg.as_ssz_bytes()
    assert len(reg.as_ssz_bytes()) == X.builder.REGISTRATION_SSZ_LEN


def test_duties_equal_jax():
    views = []
    for pkg, harness, node in ((T, BeaconChainHarness, InProcessBeaconNode),
                               (J, JHarness, JNode)):
        kwargs = dict(device="cpu") if pkg is T else {}
        h = harness(16, pkg.MINIMAL, pkg.ChainSpec.interop(altair_fork_epoch=0), **kwargs)
        h.extend_chain(3)
        bn = node(h.chain)
        views.append((bn.get_proposer_duties(1), bn.get_attester_duties(1, range(0, 16, 3)),
                       bn.get_sync_duties(0, range(16)), bn.genesis_validators_root(),
                       bn.validator_index_map([v.pubkey for v in h.chain.head_state.validators
                                               ][:5]),
                       bn.produce_attestation_data(3, 0).as_ssz_bytes()))
    assert views[0] == views[1]


@pytest.mark.gpu
def test_bid_check_on_the_card():
    """verify_bid's one set through torch_cuda on the card: the honest bid
    passes, the raised one is refused."""
    need_card()
    (_, _, te, spec, builder, bid), _ = _bids()
    tapi.set_backend("torch_cuda")
    X.verify_bid(bid, spec, te.genesis_hash, trusted_pubkey=builder.pubkey.to_bytes())
    bid.message.value = int(bid.message.value) + 1
    with pytest.raises(X.BuilderError, match="bad builder bid signature"):
        X.verify_bid(bid, spec, te.genesis_hash, trusted_pubkey=builder.pubkey.to_bytes())

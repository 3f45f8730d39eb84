"""The port's wire stack (lighthouse_tpu_torch/network/{wire,secure,
discovery}.py over crypto/aes.py and network/snappy.py) against the JAX
package's on the CPU, exact equality throughout:

- `WireCodec`: the ssz_snappy bytes of every gossip kind and of every
  req/resp request and response, equal across the packages, and each
  package decodes the other's bytes to the same SSZ;
- `aes128_ctr` on seeded keys, counters and lengths, and the NIST SP
  800-38A F.5.1 CTR-AES128 vector; the secure channel's key derivation
  and a frame's bytes under fixed keys;
- node records (ENR): the same bytes for the same key and fields, and the
  same verdicts on records made by the other package, one tampered;
  both pin the check to their cpu oracle, whatever the ambient backend;
- one block gossiped between two of the port's WireBus nodes over
  loopback, then a range sync over the same sockets (`fake` backend, the
  chains on the CPU); every socket test under a timeout, every server
  closed."""

import socket
import time

import numpy as np
import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.crypto import aes as JAES
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.network import discovery as JD
from lighthouse_tpu.network import secure as JS
from lighthouse_tpu.network import wire as JW
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto import aes as TAES
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.network import discovery as TD
from lighthouse_tpu_torch.network import node as TNODE
from lighthouse_tpu_torch.network import topic_name
from lighthouse_tpu_torch.network import secure as TS
from lighthouse_tpu_torch.network import wire as TW
from torch_port_util import no_xla_compile

DIGEST = b"\x0a\x0b\x0c\x0d"
SOCKET_TIMEOUT_S = 10.0


def _topic(kind, subnet=None):
    return topic_name(kind, DIGEST, subnet)


def _port_messages(rng):
    """One seeded message of each gossip kind, in the port's types:
    {kind: object}."""
    from lighthouse_tpu_torch.types import containers as C

    t = T.types_for(T.MINIMAL)

    def b(n):
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))

    data = C.AttestationData(slot=int(rng.integers(1, 1 << 20)), index=3,
                             beacon_block_root=b(32),
                             source=C.Checkpoint(epoch=1, root=b(32)),
                             target=C.Checkpoint(epoch=2, root=b(32)))
    att = t.Attestation(aggregation_bits=(True, False, True), data=data, signature=b(96))
    body = t.BeaconBlockBody.default()
    body.graffiti, body.randao_reveal, body.attestations = b(32), b(96), (att,)
    block = t.SignedBeaconBlock(message=t.BeaconBlock(
        slot=int(data.slot), proposer_index=5, parent_root=b(32), state_root=b(32),
        body=body), signature=b(96))
    header = C.SignedBeaconBlockHeader(message=C.BeaconBlockHeader(
        slot=9, proposer_index=2, parent_root=b(32), state_root=b(32), body_root=b(32)),
        signature=b(96))
    indexed = t.IndexedAttestation(attesting_indices=(1, 4, 9), data=data, signature=b(96))
    contribution = t.SyncCommitteeContribution.default()
    contribution.slot, contribution.signature = 7, b(96)
    return {
        "beacon_block": block,
        "beacon_aggregate_and_proof": t.SignedAggregateAndProof(
            message=t.AggregateAndProof(aggregator_index=11, aggregate=att,
                                        selection_proof=b(96)), signature=b(96)),
        "beacon_attestation": att,
        "sync_committee_contribution_and_proof": t.SignedContributionAndProof(
            message=t.ContributionAndProof(aggregator_index=4, contribution=contribution,
                                           selection_proof=b(96)), signature=b(96)),
        "sync_committee": C.SyncCommitteeMessage(slot=8, beacon_block_root=b(32),
                                                 validator_index=6, signature=b(96)),
        "proposer_slashing": C.ProposerSlashing(signed_header_1=header,
                                                signed_header_2=header),
        "attester_slashing": t.AttesterSlashing(attestation_1=indexed,
                                                attestation_2=indexed),
        "voluntary_exit": C.SignedVoluntaryExit(
            message=C.VoluntaryExit(epoch=3, validator_index=12), signature=b(96)),
    }


def _jax_twin(kind, obj):
    """The JAX package's object with the same SSZ bytes."""
    jcodec = JW.WireCodec(J.MINIMAL)
    topic = _topic(kind, 1 if kind in ("beacon_attestation", "sync_committee") else None)
    from lighthouse_tpu.network.snappy import compress

    return jcodec.decode_gossip(topic, compress(obj.as_ssz_bytes()))


@pytest.mark.parametrize("seed", [0, 1])
def test_gossip_codec_bytes_for_every_kind(seed):
    rng = np.random.default_rng(seed)
    tcodec, jcodec = TW.WireCodec(T.MINIMAL), JW.WireCodec(J.MINIMAL)
    for kind, obj in _port_messages(rng).items():
        topic = _topic(kind, 1 if kind in ("beacon_attestation", "sync_committee") else None)
        jobj = _jax_twin(kind, obj)
        wire = tcodec.encode_gossip(topic, obj)
        assert wire == jcodec.encode_gossip(topic, jobj), kind
        assert tcodec.decode_gossip(topic, wire).as_ssz_bytes() == obj.as_ssz_bytes(), kind
        assert jcodec.decode_gossip(topic, wire).as_ssz_bytes() == obj.as_ssz_bytes(), kind
    with pytest.raises(ValueError, match="unknown gossip kind"):
        tcodec.decode_gossip(_topic("no_such_kind"), tcodec.encode_gossip("", obj))


def test_req_resp_codec_bytes():
    rng = np.random.default_rng(2)
    tcodec, jcodec = TW.WireCodec(T.MINIMAL), JW.WireCodec(J.MINIMAL)
    msgs = _port_messages(rng)
    block = msgs["beacon_block"]
    jblock = _jax_twin("beacon_block", block)
    status = {"fork_digest": DIGEST, "finalized_root": b"\x05" * 32,
              "finalized_epoch": 7, "head_root": b"\x06" * 32, "head_slot": 99}
    requests = [
        (TNODE.STATUS_PROTOCOL, {}),
        (TNODE.BLOCKS_BY_RANGE, {"start_slot": 17, "count": 32}),
        (TNODE.BLOCKS_BY_ROOT, {"roots": [b"\x01" * 32, b"\x02" * 32]}),
        (TNODE.LIGHT_CLIENT_BOOTSTRAP, {"root": b"\x03" * 32}),
    ]
    for protocol, payload in requests:
        wire = tcodec.encode_request(protocol, payload)
        assert wire == jcodec.encode_request(protocol, payload), protocol
        assert tcodec.decode_request(protocol, wire) == jcodec.decode_request(protocol, wire)
    fabric = "/lighthouse_tpu/fabric_gossip/1"
    topic = _topic("beacon_attestation", 1)
    payload = {"topic": topic, "data": tcodec.encode_gossip(topic, msgs["beacon_attestation"])}
    wire = tcodec.encode_request(fabric, payload)
    assert wire == jcodec.encode_request(fabric, payload)
    assert tcodec.decode_request(fabric, wire)["payload"].as_ssz_bytes() == \
        msgs["beacon_attestation"].as_ssz_bytes()
    wire = tcodec.encode_response(TNODE.STATUS_PROTOCOL, status)
    assert wire == jcodec.encode_response(TNODE.STATUS_PROTOCOL, status)
    assert tcodec.decode_response(TNODE.STATUS_PROTOCOL, wire) == status
    wire = tcodec.encode_response(TNODE.BLOCKS_BY_RANGE, [block, block])
    assert wire == jcodec.encode_response(TNODE.BLOCKS_BY_RANGE, [jblock, jblock])
    assert [b.as_ssz_bytes() for b in tcodec.decode_response(TNODE.BLOCKS_BY_RANGE, wire)] \
        == [block.as_ssz_bytes()] * 2
    with pytest.raises(ValueError, match="unknown protocol"):
        tcodec.encode_request("/no/such/protocol", {})


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_aes128_ctr_on_seeded_inputs(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 15, 16, 17, 100):
        key, iv = bytes(rng.integers(0, 256, 16, dtype=np.uint8)), bytes(
            rng.integers(0, 256, 16, dtype=np.uint8))
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        out = TAES.aes128_ctr(key, iv, data)
        assert out == JAES.aes128_ctr(key, iv, data)
        assert TAES.aes128_ctr(key, iv, out) == data


def test_aes128_ctr_nist_vector():
    """NIST SP 800-38A, F.5.1 CTR-AES128.Encrypt."""
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    counter = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    plain = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
    cipher = bytes.fromhex(
        "874d6191b620e3261bef6864990db6ce" "9806f66b7970fdff8617187bb9fffdff"
        "5ae4df3edbd5d35e5b4f09020db03eab" "1e031dda2fbe03d1792170a0f3009cee")
    assert TAES.aes128_ctr(key, counter, plain) == cipher == JAES.aes128_ctr(
        key, counter, plain)


def test_secure_frames_under_fixed_keys():
    """The handshake's key derivation from one shared point, and a frame
    sealed by one package's SecureSocket, opened by the other's."""
    from lighthouse_tpu.crypto.bls import curve_ref as JCR
    from lighthouse_tpu_torch.crypto.bls import curve_ref as TCR

    e_i, e_r = b"\x11" * 48, b"\x22" * 48
    tpoint = TCR.g1_generator().mul(12345)
    jpoint = JCR.g1_generator().mul(12345)
    tkeys = TS._derive_keys(tpoint, e_i, e_r)
    assert tkeys == JS._derive_keys(jpoint, e_i, e_r)
    assert TS._hkdf(b"s" * 32, b"info", 77) == JS._hkdf(b"s" * 32, b"info", 77)
    i2r, r2i = tkeys
    for sender, receiver in ((TS, JS), (JS, TS)):
        a, b = socket.socketpair()
        a.settimeout(SOCKET_TIMEOUT_S)
        b.settimeout(SOCKET_TIMEOUT_S)
        try:
            out, into = sender.SecureSocket(a, i2r, r2i), receiver.SecureSocket(b, r2i, i2r)
            for n, body in enumerate((b"", b"frame", bytes(range(256)) * 3)):
                out.send_frame(7 + n, body)
                assert into.recv_frame() == (7 + n, body)
        finally:
            a.close()
            b.close()
    raw = []
    for S in (TS, JS):
        a, b = socket.socketpair()
        b.settimeout(SOCKET_TIMEOUT_S)
        try:
            S.SecureSocket(a, i2r, r2i).send_frame(3, b"same bytes")
            raw.append(b.recv(4096))
        finally:
            a.close()
            b.close()
    assert raw[0] == raw[1]


def test_node_record_bytes_and_verdicts(monkeypatch):
    """make_enr gives the same bytes in both packages; each package's
    verify accepts the other's record and refuses it with its UDP port
    changed, on its cpu oracle even with the ambient backend `fake`."""
    from torch_port_util import jax_keys_decompressed

    jax_keys_decompressed(monkeypatch)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    try:
        with no_xla_compile():
            args = ("127.0.0.1", 9000, 9001, DIGEST, (1, 5, 63), (2,), 3)
            tenr = TD.make_enr(tapi.SecretKey(0xE1), *args)
            jenr = JD.make_enr(japi.SecretKey(0xE1), *args)
            raw = tenr.to_bytes()
            assert raw == jenr.to_bytes()
            tampered = bytearray(raw)
            tampered[8 + 48 + 4] ^= 1
            for D in (TD, JD):
                D.Enr._verified.clear()
                assert D.Enr.from_bytes(raw).verify() is True
                assert D.Enr.from_bytes(bytes(tampered)).verify() is False
            assert [TD.Enr.from_bytes(raw).has_attnet(s) for s in range(64)] == [
                JD.Enr.from_bytes(raw).has_attnet(s) for s in range(64)]
    finally:
        (japi._BACKEND, japi._BACKEND_NAME,
         tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def test_block_gossip_and_range_sync_over_loopback():
    """Two of the port's WireBus nodes on 127.0.0.1 (plain channels), via
    a Bootnode: a block published on w0 reaches w1 as an ssz_snappy frame
    and imports; a late joiner range-syncs both blocks over the socket."""
    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.harness.chain import StateHarness
    from lighthouse_tpu_torch.network import NetworkNode
    from lighthouse_tpu_torch.state_transition import clone_state
    from lighthouse_tpu_torch.store.hot_cold import HotColdDB
    from lighthouse_tpu_torch.store.kv import MemoryStore

    saved = (tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    tapi.set_backend("fake")
    spec = T.ChainSpec.interop()
    producer = StateHarness(16, T.MINIMAL, spec, sign=False)
    boot = TW.Bootnode().start()
    buses = []

    def spawn(name):
        bus = TW.WireBus(T.MINIMAL)
        buses.append(bus)
        chain = BeaconChain(HotColdDB(MemoryStore(), T.MINIMAL, spec),
                            clone_state(producer.state), T.MINIMAL, spec, device="cpu")
        node = NetworkNode(name, chain, bus)
        bus.listen(name)
        bus.bootstrap(boot)
        return node

    try:
        w0, w1 = spawn("w0"), spawn("w1")
        heads = []
        for slot in (1, 2):
            parent = w0.chain._states[w0.chain.head_root]
            signed, _ = producer.produce_block(slot, (), base_state=parent)
            for n in (w0, w1):
                n.chain.slot_clock.set_slot(slot)
            w0.publish_block(signed)
            heads.append(signed.message.tree_hash_root())
            deadline = time.monotonic() + SOCKET_TIMEOUT_S
            while w1.chain.head_root != heads[-1] and time.monotonic() < deadline:
                w1.processor.run_until_idle()
                time.sleep(0.01)
            assert w1.chain.head_root == heads[-1], f"slot {slot} did not cross"
        late = spawn("late")
        assert late.sync_with("w0") == 2
        assert late.chain.head_root == w0.chain.head_root == heads[-1]
    finally:
        for bus in buses:
            bus.stop()
        boot.stop()
        tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE = saved
    with pytest.raises(OSError):
        socket.create_connection((buses[0].host, buses[0].port), timeout=1.0).close()

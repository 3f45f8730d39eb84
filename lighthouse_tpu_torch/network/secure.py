"""Encrypted, authenticated channel for the wire stack (the reference's
noise-handshake seat: lighthouse_network/src/service/utils.rs
build_transport -- noise XX over x25519, then a muxed secure stream).

TPU-native divergences, both deliberate: the key exchange is
Diffie-Hellman over BLS12-381 G1 -- the framework's native curve, so one
keypair type serves identity, signing, and transport -- instead of
x25519, and identity binding is a BLS signature over the handshake
transcript, verified against the peer's ENR-advertised identity key
(discovery.py) rather than a separate libp2p identity. Symmetric crypto
is the in-repo AES-128-CTR (crypto/aes.py) with HMAC-SHA256 per frame;
keys derive via HKDF-SHA256.

Handshake (XX-shaped):
    I -> R:  e_i                 48-byte compressed G1 ephemeral
    R -> I:  e_r [|| sig_r]      responder ephemeral, + transcript sig
    I -> R:  [sig_i]             initiator transcript sig
Shared secret: sha256(compress(dh)) where dh = e_peer * e_own_sk; four
direction keys expand from it. Frames carry a strictly-increasing
per-direction sequence (the high 64 bits of the AES-CTR counter, so
frames never share keystream) and a truncated HMAC tag --
tampering, replay, and reordering all fail the MAC and kill the
connection.

Signatures are optional (`authenticate=False` skips them): a BLS verify
costs ~2 s on the pure-Python oracle, which multi-node simulations pay
per persistent connection only when identity binding is the thing under
test.


The port's copy of lighthouse_tpu/network/secure.py.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import secrets
import struct

from ..crypto.aes import aes128_ctr
from ..crypto.bls import api as bls
from ..crypto.bls.constants import R as CURVE_ORDER
from ..crypto.bls.curve_ref import g1_from_bytes, g1_generator, g1_to_bytes

_PROTO = b"lighthouse-tpu-secure-v1"
_TAG_LEN = 16


class SecureError(OSError):
    """Handshake or frame authentication failure: the connection is
    unusable (OSError so wire.py's redial/drop paths treat it as a dead
    peer)."""


def _hkdf(secret: bytes, info: bytes, length: int) -> bytes:
    prk = hmac_mod.new(_PROTO, secret, hashlib.sha256).digest()
    out = b""
    block = b""
    counter = 1
    while len(out) < length:
        block = hmac_mod.new(
            prk, block + info + bytes([counter]), hashlib.sha256
        ).digest()
        out += block
        counter += 1
    return out[:length]


def _send_raw(sock, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_raw(sock) -> bytes | None:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = struct.unpack(">I", head)
    if n > 1 << 24:
        raise SecureError("oversized handshake/frame")
    body = b""
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            return None
        body += chunk
    return body


def _transcript_root(e_i: bytes, e_r: bytes, role: bytes) -> bytes:
    return hashlib.sha256(_PROTO + e_i + e_r + role).digest()


def _sign_transcript(identity_sk, e_i: bytes, e_r: bytes, role: bytes) -> bytes:
    sig = identity_sk.sign(_transcript_root(e_i, e_r, role))
    return identity_sk.public_key().to_bytes() + sig.to_bytes()


def _verify_transcript(
    blob: bytes, e_i: bytes, e_r: bytes, role: bytes, expect_pubkey
) -> bytes:
    """Returns the peer's identity pubkey bytes; raises SecureError on a
    bad signature or an identity mismatch. Verification is pinned to the
    CPU oracle (control plane, like ENR checks)."""
    from ..crypto.bls.backends import cpu as cpu_bls

    if len(blob) != 48 + 96:
        raise SecureError("malformed identity blob")
    pk_bytes, sig_bytes = blob[:48], blob[48:]
    if expect_pubkey is not None and bytes(expect_pubkey) != pk_bytes:
        raise SecureError("peer identity key does not match expectation")
    try:
        pk = bls.PublicKey.from_bytes(pk_bytes)
        sig = bls.Signature.from_bytes(sig_bytes)
        ok = cpu_bls.verify_signature_sets(
            [
                bls.SignatureSet.single_pubkey(
                    sig, pk, _transcript_root(e_i, e_r, role)
                )
            ]
        )
    except bls.BlsError as e:
        raise SecureError(f"invalid identity material: {e}") from None
    if not ok:
        raise SecureError("peer transcript signature failed verification")
    return pk_bytes


class SecureSocket:
    """Frame-level AEAD wrapper: seq(8) || aes128ctr(ct) || hmac_tag(16).
    One instance per connection per direction pair. The frame sequence
    occupies the high 64 bits of the CTR counter (the low 64 count the
    blocks within a frame), so no two frames ever share a keystream
    block."""

    def __init__(self, sock, send_keys, recv_keys, peer_pubkey=None):
        self.sock = sock
        self._send_key, self._send_mac = send_keys
        self._recv_key, self._recv_mac = recv_keys
        self._send_seq = 0
        self._recv_seq = 0
        self.peer_pubkey = peer_pubkey  # None when unauthenticated

    def send_frame(self, ftype: int, body: bytes) -> None:
        plain = bytes([ftype]) + body
        seq = self._send_seq
        self._send_seq += 1
        # the frame seq owns the HIGH 64 counter bits: every frame gets
        # its own 2^64-block counter space, so keystream blocks can never
        # overlap between frames (CTR reuse = two-time pad)
        iv = (seq << 64).to_bytes(16, "big")
        ct = aes128_ctr(self._send_key, iv, plain)
        seq8 = seq.to_bytes(8, "big")
        tag = hmac_mod.new(
            self._send_mac, seq8 + ct, hashlib.sha256
        ).digest()[:_TAG_LEN]
        _send_raw(self.sock, seq8 + ct + tag)

    def recv_frame(self):
        payload = _recv_raw(self.sock)
        if payload is None:
            return None, None
        if len(payload) < 8 + _TAG_LEN:
            raise SecureError("truncated secure frame")
        seq8, ct, tag = payload[:8], payload[8:-_TAG_LEN], payload[-_TAG_LEN:]
        want = hmac_mod.new(
            self._recv_mac, seq8 + ct, hashlib.sha256
        ).digest()[:_TAG_LEN]
        if not hmac_mod.compare_digest(tag, want):
            raise SecureError("frame MAC failure (tampering?)")
        seq = int.from_bytes(seq8, "big")
        if seq != self._recv_seq:
            raise SecureError("frame out of sequence (replay?)")
        self._recv_seq += 1
        plain = aes128_ctr(self._recv_key, (seq << 64).to_bytes(16, "big"), ct)
        if not plain:
            raise SecureError("empty secure frame")
        return plain[0], plain[1:]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _derive_keys(shared_point, e_i: bytes, e_r: bytes):
    secret = hashlib.sha256(g1_to_bytes(shared_point)).digest()
    material = _hkdf(secret, e_i + e_r, 96)
    # i->r key/mac, r->i key/mac
    return (
        (material[0:16], material[32:64]),
        (material[16:32], material[64:96]),
    )


def _ephemeral():
    sk = (secrets.randbits(256) % (CURVE_ORDER - 1)) + 1
    return sk, g1_to_bytes(g1_generator().mul(sk))


def handshake_initiator(
    sock, identity_sk=None, expect_pubkey=None, authenticate: bool = False
) -> SecureSocket:
    e_sk, e_i = _ephemeral()
    _send_raw(sock, e_i)
    reply = _recv_raw(sock)
    if reply is None or len(reply) < 48:
        raise SecureError("handshake: no responder ephemeral")
    e_r, r_blob = reply[:48], reply[48:]
    peer_pk = None
    if authenticate:
        peer_pk = _verify_transcript(r_blob, e_i, e_r, b"resp", expect_pubkey)
        if identity_sk is None:
            raise SecureError("authenticate=True needs an identity key")
        _send_raw(sock, _sign_transcript(identity_sk, e_i, e_r, b"init"))
    shared = g1_from_bytes(e_r).mul(e_sk)
    i2r, r2i = _derive_keys(shared, e_i, e_r)
    return SecureSocket(sock, i2r, r2i, peer_pk)


def handshake_responder(
    sock, identity_sk=None, expect_pubkey=None, authenticate: bool = False
) -> SecureSocket:
    e_i = _recv_raw(sock)
    if e_i is None or len(e_i) != 48:
        raise SecureError("handshake: no initiator ephemeral")
    e_sk, e_r = _ephemeral()
    if authenticate:
        if identity_sk is None:
            raise SecureError("authenticate=True needs an identity key")
        _send_raw(sock, e_r + _sign_transcript(identity_sk, e_i, e_r, b"resp"))
        i_blob = _recv_raw(sock)
        if i_blob is None:
            raise SecureError("handshake: no initiator identity")
        peer_pk = _verify_transcript(i_blob, e_i, e_r, b"init", expect_pubkey)
    else:
        _send_raw(sock, e_r)
        peer_pk = None
    shared = g1_from_bytes(e_i).mul(e_sk)
    i2r, r2i = _derive_keys(shared, e_i, e_r)
    return SecureSocket(sock, r2i, i2r, peer_pk)

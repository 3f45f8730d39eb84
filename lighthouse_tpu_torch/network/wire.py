"""Socket-backed network stack (the wire seat of reference
beacon_node/lighthouse_network: service/mod.rs swarm, rpc/codec/
ssz_snappy.rs framing, types/pubsub.rs gossip en/decode, discovery/).

`WireBus` exposes the same Router-facing API as the in-process
`MessageBus` (subscribe / register_rpc / publish / request / peers_on),
so a `NetworkNode` runs unchanged over real TCP sockets:

- every payload crosses the wire as **SSZ + snappy** (snappy.py), with
  gossip topics in the reference's fork-digest namespacing and req/resp
  responses in varint-length-prefixed chunks (ssz_snappy.rs framing);
- gossip rides a degree-bounded MESH per topic (gossipsub's eager-push
  mesh, behaviour.rs/mesh maintenance) with a seen-cache: each node
  relays to at most MESH_DEGREE mesh peers instead of flooding every
  subscriber (peer scoring stays in NetworkNode's score table);
- connections are PERSISTENT: one long-lived outbound socket per peer,
  reused for every gossip push and req/resp exchange (the reference's
  noise/yamux stream seat), redialed once on failure;
- req/resp is token-bucket rate-limited PER PEER on the server side
  (reference rpc/rate_limiter.rs): an over-quota requester gets an
  error chunk, not service;
- `Bootnode` is a registry server standing in for discv5: peers
  REGISTER their (peer_id, host, port) and LIST others (discovery/'s
  ENR directory role; the UDP DHT itself is out of scope).

NOTE: no `from __future__ import annotations` — the @container wire types
below need live annotations (see types/containers.py header).

The port's copy of lighthouse_tpu/network/wire.py.
"""

import hashlib
import json
import random
import socket
import socketserver
import struct
import threading
import time
from collections import OrderedDict

from ..ssz import Bytes4, Bytes32, List, container, uint64
from ..types import decode_block_any_fork, types_for
from .snappy import compress, decompress

FRAME_HELLO = 0
FRAME_GOSSIP = 1
FRAME_REQ = 2
FRAME_RESP = 3
FRAME_GRAFT = 4
FRAME_PRUNE = 5

SEEN_CACHE_SIZE = 4096
# gossipsub mesh degree (the reference's D; config.rs mesh_n)
MESH_DEGREE = 4


class TokenBucket:
    """Per-peer request quota (reference rpc/rate_limiter.rs): `burst`
    tokens, refilled at `rate_per_s`."""

    def __init__(self, burst: float, rate_per_s: float):
        self.capacity = float(burst)
        self.rate = float(rate_per_s)
        self.tokens = float(burst)
        self.stamp = time.monotonic()

    def allow(self, cost: float = 1.0) -> bool:
        now = time.monotonic()
        self.tokens = min(
            self.capacity, self.tokens + (now - self.stamp) * self.rate
        )
        self.stamp = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class PlainChannel:
    """Unencrypted frame channel over a raw socket -- the same interface
    SecureSocket (secure.py) exposes, so every wire path talks to ONE
    channel abstraction and encryption is purely a handshake choice."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.peer_pubkey = None

    def send_frame(self, ftype: int, body: bytes) -> None:
        _send_frame(self.sock, ftype, body)

    def recv_frame(self):
        return _recv_frame(self.sock)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _PeerConn:
    """One persistent outbound channel to a peer, serialized by a lock;
    redials (and re-handshakes, in secure mode) once when the cached
    connection has died. `wrap` upgrades a fresh socket to a channel."""

    def __init__(self, host: str, port: int, wrap=PlainChannel):
        self.host = host
        self.port = port
        self.wrap = wrap
        self.lock = threading.Lock()
        self._chan = None

    def _dial(self):
        s = socket.create_connection((self.host, self.port), timeout=10)
        s.settimeout(10)
        try:
            return self.wrap(s)
        except OSError:
            s.close()
            raise

    def _get(self):
        if self._chan is None:
            self._chan = self._dial()
        return self._chan

    def _drop(self) -> None:
        if self._chan is not None:
            self._chan.close()
            self._chan = None

    def send(self, ftype: int, body: bytes) -> None:
        """Fire-and-forget frame (gossip push)."""
        with self.lock:
            for attempt in (0, 1):
                try:
                    # lint: allow[blocking-under-lock] -- this per-peer
                    # lock EXISTS to serialize one socket; dialing and
                    # framing under it is the design, and it guards no
                    # other state
                    self._get().send_frame(ftype, body)
                    return
                except OSError:
                    self._drop()
                    if attempt:
                        raise

    def exchange(self, ftype: int, body: bytes):
        """Frame out, response frame back on the same stream. The redial
        retry covers ONLY a failed send on a stale cached socket (nothing
        was delivered); once the request is on the wire, a receive failure
        raises -- re-sending would execute the rpc twice and burn a second
        rate-limit token."""
        with self.lock:
            for attempt in (0, 1):
                try:
                    # lint: allow[blocking-under-lock] -- same as send():
                    # the lock serializes exactly this socket
                    chan = self._get()
                    chan.send_frame(ftype, body)
                except OSError:
                    self._drop()
                    if attempt:
                        raise
                    continue
                try:
                    rtype, resp = chan.recv_frame()
                    if rtype is None:
                        raise OSError("peer closed mid-exchange")
                    return rtype, resp
                except OSError:
                    self._drop()
                    raise

    def close(self) -> None:
        with self.lock:
            self._drop()


# NOTE: no `from __future__ annotations` interplay — these descriptors are
# evaluated eagerly by @container via the module-level calls below.
def _make_wire_types():
    @container
    class StatusMessage:
        fork_digest: Bytes4
        finalized_root: Bytes32
        finalized_epoch: uint64
        head_root: Bytes32
        head_slot: uint64

    @container
    class BlocksByRangeRequest:
        start_slot: uint64
        count: uint64
        step: uint64

    @container
    class BlocksByRootRequest:
        roots: List(Bytes32, 1024)

    return StatusMessage, BlocksByRangeRequest, BlocksByRootRequest


StatusMessage, BlocksByRangeRequest, BlocksByRootRequest = _make_wire_types()


def _ssz_snappy(obj) -> bytes:
    return compress(obj.as_ssz_bytes())


def _chunks_encode(parts: list[bytes]) -> bytes:
    out = bytearray()
    for p in parts:
        out += struct.pack(">I", len(p)) + p
    return bytes(out)


def _chunks_decode(data: bytes) -> list[bytes]:
    out = []
    pos = 0
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        out.append(data[pos : pos + n])
        pos += n
    return out


class WireCodec:
    """ssz_snappy payload codecs per gossip kind and req/resp protocol
    (reference types/pubsub.rs PubsubMessage + rpc/codec)."""

    def __init__(self, preset):
        self.preset = preset
        self.t = types_for(preset)

    # -- gossip ---------------------------------------------------------------

    def _gossip_kind(self, topic: str) -> str:
        # /eth2/<digest>/<kind>[_<subnet>]/ssz_snappy
        kind = topic.split("/")[3]
        for prefix in (
            "beacon_attestation",
            "sync_committee_contribution_and_proof",
            "sync_committee",
        ):
            if kind.startswith(prefix):
                return prefix
        return kind

    def encode_gossip(self, topic: str, payload) -> bytes:
        return _ssz_snappy(payload)

    def decode_gossip(self, topic: str, data: bytes):
        raw = decompress(data)
        kind = self._gossip_kind(topic)
        t = self.t
        if kind == "beacon_block":
            return decode_block_any_fork(raw, self.preset)
        if kind == "beacon_aggregate_and_proof":
            return t.SignedAggregateAndProof.from_ssz_bytes(raw)
        if kind == "beacon_attestation":
            return t.Attestation.from_ssz_bytes(raw)
        if kind == "sync_committee_contribution_and_proof":
            return t.SignedContributionAndProof.from_ssz_bytes(raw)
        if kind == "sync_committee":
            from ..types.containers import SyncCommitteeMessage

            return SyncCommitteeMessage.from_ssz_bytes(raw)
        # operation gossip (types/topics.rs pubsub kinds): the scenario
        # wire fabric routes EVERY node topic over sockets, so the codec
        # must cover the op lanes the in-process bus carried for free
        if kind == "proposer_slashing":
            from ..types.containers import ProposerSlashing

            return ProposerSlashing.from_ssz_bytes(raw)
        if kind == "attester_slashing":
            return t.AttesterSlashing.from_ssz_bytes(raw)
        if kind == "voluntary_exit":
            from ..types.containers import SignedVoluntaryExit

            return SignedVoluntaryExit.from_ssz_bytes(raw)
        raise ValueError(f"unknown gossip kind in topic {topic}")

    # -- req/resp -------------------------------------------------------------

    def encode_request(self, protocol: str, payload) -> bytes:
        if "fabric_gossip" in protocol:
            # scenario-fabric delivery: a gossip message pushed as a
            # SYNCHRONOUS req/resp exchange (topic-prefixed ssz_snappy)
            # so the sender observes completion — the determinism seam
            # that lets wire-transport scenarios replay bit-identically
            topic = payload["topic"].encode()
            return struct.pack(">H", len(topic)) + topic + payload["data"]
        if "status" in protocol:
            return b""  # our Router's status handler takes no input
        if "by_range" in protocol:
            return _ssz_snappy(
                BlocksByRangeRequest(
                    start_slot=payload["start_slot"],
                    count=payload["count"],
                    step=1,
                )
            )
        if "by_root" in protocol:
            return _ssz_snappy(
                BlocksByRootRequest(
                    roots=tuple(bytes(r) for r in payload["roots"])
                )
            )
        if "light_client_bootstrap" in protocol:
            return compress(bytes(payload["root"]))
        raise ValueError(f"unknown protocol {protocol}")

    def decode_request(self, protocol: str, data: bytes):
        if "fabric_gossip" in protocol:
            (tlen,) = struct.unpack_from(">H", data, 0)
            topic = data[2 : 2 + tlen].decode()
            return {
                "topic": topic,
                "payload": self.decode_gossip(topic, data[2 + tlen :]),
            }
        if "status" in protocol:
            return {}
        if "by_range" in protocol:
            req = BlocksByRangeRequest.from_ssz_bytes(decompress(data))
            return {"start_slot": req.start_slot, "count": req.count}
        if "by_root" in protocol:
            req = BlocksByRootRequest.from_ssz_bytes(decompress(data))
            return {"roots": [bytes(r) for r in req.roots]}
        if "light_client_bootstrap" in protocol:
            return {"root": decompress(data)}
        raise ValueError(f"unknown protocol {protocol}")

    def encode_response(self, protocol: str, result) -> bytes:
        if "fabric_gossip" in protocol:
            return b""  # delivery ack carries no body
        if "status" in protocol:
            msg = StatusMessage(
                fork_digest=bytes(result["fork_digest"]),
                finalized_root=bytes(result["finalized_root"]),
                finalized_epoch=result["finalized_epoch"],
                head_root=bytes(result["head_root"]),
                head_slot=result["head_slot"],
            )
            return _chunks_encode([_ssz_snappy(msg)])
        if "light_client_bootstrap" in protocol:
            return _chunks_encode([_ssz_snappy(result)])
        # block streams: one ssz_snappy chunk per block (ssz_snappy.rs)
        return _chunks_encode([_ssz_snappy(b) for b in result])

    def decode_response(self, protocol: str, data: bytes):
        if "fabric_gossip" in protocol:
            return None
        chunks = _chunks_decode(data)
        if "status" in protocol:
            msg = StatusMessage.from_ssz_bytes(decompress(chunks[0]))
            return {
                "fork_digest": bytes(msg.fork_digest),
                "finalized_root": bytes(msg.finalized_root),
                "finalized_epoch": msg.finalized_epoch,
                "head_root": bytes(msg.head_root),
                "head_slot": msg.head_slot,
            }
        if "light_client_bootstrap" in protocol:
            from ..chain.light_client import light_client_types

            lt = light_client_types(self.preset)
            return lt.LightClientBootstrap.from_ssz_bytes(
                decompress(chunks[0])
            )
        return [
            decode_block_any_fork(decompress(c), self.preset) for c in chunks
        ]


# -- framing ------------------------------------------------------------------


def _send_frame(sock: socket.socket, ftype: int, body: bytes) -> None:
    sock.sendall(struct.pack(">IB", len(body) + 1, ftype) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket):
    head = _recv_exact(sock, 5)
    if head is None:
        return None, None
    length, ftype = struct.unpack(">IB", head[:4] + head[4:5])
    body = _recv_exact(sock, length - 1) if length > 1 else b""
    if body is None:
        return None, None  # truncated body == dead peer, same as EOF
    return ftype, body


# -- discovery registry (the discv5 seat) -------------------------------------


def _register_signing_root(
    peer_id: str, host: str, port: int, seq: int
) -> bytes:
    # seq gives the proof freshness (the ENR seq-number seat): a replayed
    # old registration cannot revert a peer's entry to a stale address
    return hashlib.sha256(
        b"lighthouse-tpu-bootnode-register\x00"
        + peer_id.encode()
        + b"\x00"
        + host.encode()
        + b"\x00"
        + int(port).to_bytes(4, "big")
        + int(seq).to_bytes(8, "big")
    ).digest()


def _sign_register_proof(
    identity_sk, peer_id: str, host: str, port: int, seq: int
) -> str:
    return identity_sk.sign(
        _register_signing_root(peer_id, host, port, seq)
    ).to_bytes().hex()


def _verify_register_proof(
    pk_bytes: bytes,
    sig_bytes: bytes,
    peer_id: str,
    host: str,
    port: int,
    seq: int,
) -> bool:
    """Pinned to the CPU oracle like ENR verification (discovery.py):
    identity registrations are control plane, never routed through the
    ambient batch backend (which may be `fake` under test)."""
    from ..crypto.bls import api as bls
    from ..crypto.bls.backends import cpu as cpu_bls

    try:
        pk = bls.PublicKey.from_bytes(pk_bytes)
        sig = bls.Signature.from_bytes(sig_bytes)
        return cpu_bls.verify_signature_sets(
            [
                bls.SignatureSet.single_pubkey(
                    sig, pk, _register_signing_root(peer_id, host, port, seq)
                )
            ]
        )
    except (TypeError, ValueError, IndexError, AttributeError, OverflowError):
        # remote-controlled input: malformed key/signature material
        # (BlsError is a ValueError), non-string peer_id/host
        # (AttributeError/TypeError), out-of-range port (OverflowError)
        # == invalid registration, never a crashed handler thread
        return False


class Bootnode:
    """Peer directory over TCP: REGISTER/LIST json frames (reference
    boot_node/ + discovery/enr.rs directory role)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        outer = self
        self._peers: dict[str, dict] = {}
        self._lock = threading.Lock()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                ftype, body = _recv_frame(self.request)
                if ftype is None:
                    return
                msg = json.loads(body)
                if msg.get("op") == "register":
                    reply = outer._register(msg)
                else:  # list
                    with outer._lock:
                        reply = {"peers": list(outer._peers.values())}
                _send_frame(
                    self.request, FRAME_HELLO, json.dumps(reply).encode()
                )

        self._server = socketserver.ThreadingTCPServer(
            (host, port), Handler, bind_and_activate=True
        )
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def _register(self, msg: dict) -> dict:
        """Identity-carrying registrations must PROVE key possession (a
        BLS signature over the registration transcript) and may not rebind
        a peer_id already registered under a different key -- otherwise the
        listing dialers pin from (the ENR seat) lets an attacker bind a
        victim's peer_id to its own key (review finding)."""
        pk_hex = msg.get("identity_pk")
        entry = {
            "peer_id": msg["peer_id"],
            "host": msg["host"],
            "port": msg["port"],
            "identity_pk": None,
            "seq": 0,
        }
        if pk_hex is not None:
            try:
                pk_bytes = bytes.fromhex(str(pk_hex))
                sig_bytes = bytes.fromhex(str(msg["register_proof"]))
                seq = int(msg["seq"])
            except (KeyError, ValueError, TypeError):
                return {"ok": False, "error": "malformed identity proof"}
            if not _verify_register_proof(
                pk_bytes,
                sig_bytes,
                msg["peer_id"],
                msg["host"],
                msg["port"],
                seq,
            ):
                return {"ok": False, "error": "bad identity proof"}
            entry["identity_pk"] = pk_hex
            entry["seq"] = seq
        with self._lock:
            prev = self._peers.get(msg["peer_id"])
            if prev is not None and prev.get("identity_pk") not in (
                None,
                pk_hex,
            ):
                # first-come binding: a different key cannot take the id
                return {"ok": False, "error": "peer id bound to another key"}
            if prev is not None and prev.get("identity_pk") is not None:
                if pk_hex is None:
                    # an unauthenticated re-register may not strip a binding
                    return {"ok": False, "error": "peer id requires identity"}
                if entry["seq"] <= prev.get("seq", 0):
                    # replayed/stale proof may not revert the entry
                    return {"ok": False, "error": "stale registration seq"}
            self._peers[msg["peer_id"]] = entry
        return {"ok": True}

    def start(self) -> "Bootnode":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @staticmethod
    def rpc(host: str, port: int, msg: dict) -> dict:
        with socket.create_connection((host, port), timeout=5) as s:
            _send_frame(s, FRAME_HELLO, json.dumps(msg).encode())
            _, body = _recv_frame(s)
            return json.loads(body)


# -- the per-node transport ---------------------------------------------------


class WireBus:
    """Per-node socket transport with the MessageBus API. One instance
    per node (unlike the shared in-process MessageBus); `listen()` then
    `bootstrap()`/`connect_to()` wire it into the network."""

    def __init__(
        self,
        preset,
        host: str = "127.0.0.1",
        mesh_degree: int = MESH_DEGREE,
        req_burst: float = 16.0,
        req_rate_per_s: float = 8.0,
        secure: bool = False,
        identity_sk=None,
        authenticate: bool = False,
        rng: random.Random | None = None,
    ):
        self.codec = WireCodec(preset)
        self.host = host
        # mesh-maintenance randomness (lint rule `nondeterminism`): tests
        # inject an rng for exact replay; otherwise derive from the node
        # identity so DISTINCT nodes make independent shuffle/sample
        # choices (a shared fixed seed would correlate gossip topology
        # across the whole network) while a fixed identity still replays
        if rng is not None:
            self.rng = rng
        elif identity_sk is not None:
            digest = hashlib.sha256(
                b"wirebus-mesh-rng" + identity_sk.to_bytes()
            ).digest()
            self.rng = random.Random(int.from_bytes(digest[:8], "big"))
        else:
            self.rng = random.Random()  # OS entropy, as before
        # transport security (the noise seat, secure.py): with secure=True
        # every connection -- inbound and outbound -- runs the DH handshake
        # and all frames are encrypted+MACed; authenticate adds BLS
        # transcript signatures binding the connection to identity keys
        self.secure = secure
        self.identity_sk = identity_sk
        self.authenticate = authenticate
        self.peer_id: str | None = None
        self.port: int | None = None
        self._subs: dict[str, object] = {}  # topic -> handler
        self._rpc: dict[str, object] = {}  # protocol -> handler
        # peer_id -> {"host", "port", "topics": set}
        self._peers: dict[str, dict] = {}
        self._conns: dict[str, _PeerConn] = {}  # persistent outbound
        self.mesh_degree = mesh_degree
        self._mesh: dict[str, set] = {}  # topic -> mesh peer ids
        # peers that PRUNEd our graft, per topic: excluded from re-grafts
        self._pruned_by: dict[str, set] = {}
        self.req_burst = req_burst
        self.req_rate_per_s = req_rate_per_s
        self._seen: OrderedDict[bytes, bool] = OrderedDict()
        # gossipsub behavioral scoring (gossipsub_scoring_parameters.rs):
        # relayer-keyed; graylisted peers' gossip drops at the door and
        # negative-score mesh peers are pruned during relay
        from .peer_score import PeerScorer

        self.scorer = PeerScorer()
        # relay-path score snapshot: peer_id -> (score, stamp). Scoring a
        # peer takes the scorer lock and lazily decays every topic, so
        # the relay loop must not do it per subscriber per message under
        # the bus lock; scores are recomputed at most once per TTL and
        # always OUTSIDE the bus lock (penalties surface one TTL late at
        # worst, which mesh behavior tolerates)
        self.score_ttl_s = 1.0
        self._score_cache: dict[str, tuple[float, float]] = {}
        self._lock = threading.Lock()
        self._server = None
        # observability for mesh/limiter tests
        self.stats = {"gossip_frames_sent": 0, "requests_rejected": 0}

    # -- MessageBus API ------------------------------------------------------

    def subscribe(self, peer_id: str, topic: str, handler) -> None:
        self._subs[topic] = handler

    def unsubscribe(self, peer_id: str, topic: str) -> None:
        self._subs.pop(topic, None)

    def register_rpc(self, peer_id: str, protocol: str, handler) -> None:
        self._rpc[protocol] = handler

    def peers_on(self, topic: str) -> list[str]:
        with self._lock:
            return [
                pid
                for pid, info in self._peers.items()
                if topic in info["topics"]
            ] + ([self.peer_id] if topic in self._subs else [])

    def publish(self, source_peer: str, topic: str, payload) -> int:
        data = self.codec.encode_gossip(topic, payload)
        msg_id = self._msg_id(topic, data)
        self._mark_seen(msg_id)
        return self._gossip_send(topic, data, exclude=None)

    def request(self, from_peer: str, to_peer: str, protocol: str, payload):
        conn = self._conn_for(to_peer)
        if conn is None:
            raise ConnectionError(f"unknown peer {to_peer}")
        body = (
            struct.pack(">H", len(protocol))
            + protocol.encode()
            + struct.pack(">H", len(self.peer_id))
            + self.peer_id.encode()
            + self.codec.encode_request(protocol, payload)
        )
        try:
            ftype, resp = conn.exchange(FRAME_REQ, body)
        except OSError as e:
            raise ConnectionError(f"peer {to_peer} unreachable: {e}") from None
        if ftype != FRAME_RESP or resp is None:
            raise ConnectionError(f"peer {to_peer} sent no response")
        if resp[:1] == b"\x01":
            raise ConnectionError(
                f"peer {to_peer} error: {resp[1:].decode(errors='replace')}"
            )
        return self.codec.decode_response(protocol, resp[1:])

    # -- lifecycle -----------------------------------------------------------

    def _wrap_client(self, sock, expect_pubkey=None):
        if not self.secure:
            return PlainChannel(sock)
        from .secure import handshake_initiator

        return handshake_initiator(
            sock,
            self.identity_sk,
            expect_pubkey=expect_pubkey,
            authenticate=self.authenticate,
        )

    def _wrap_server(self, sock):
        if not self.secure:
            return PlainChannel(sock)
        from .secure import handshake_responder

        return handshake_responder(
            sock, self.identity_sk, authenticate=self.authenticate
        )

    def listen(self, peer_id: str, port: int = 0) -> int:
        self.peer_id = peer_id
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    chan = outer._wrap_server(self.request)
                except OSError:
                    return  # failed/mismatched handshake: drop the dial
                # the quota is keyed to the CONNECTION, not a requester id
                # copied from the request body -- ids are free to rotate,
                # re-dialing costs the flooder a handshake per bucket
                bucket = TokenBucket(outer.req_burst, outer.req_rate_per_s)
                while True:
                    try:
                        ftype, body = chan.recv_frame()
                    except OSError:
                        return  # MAC/sequence failure: kill the stream
                    if ftype is None:
                        return
                    outer._handle_frame(chan, ftype, body, bucket)

        self._server = socketserver.ThreadingTCPServer(
            (self.host, port), Handler, bind_and_activate=True
        )
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.close()

    def connect_to(
        self, host: str, port: int, expect_pubkey: bytes | None = None
    ) -> str | None:
        """Dial a peer: HELLO exchange records each other's listen
        address + topic interests (the identify/handshake seat).

        With authenticate=True the transcript signature is verified
        against `expect_pubkey` when the caller knows it (bootnode
        listing / discovery ENR); otherwise the key the peer presents is
        PINNED trust-on-first-use, so every later re-dial to this peer id
        (the persistent _conn_for connections) rejects an impostor."""
        hello = {
            "peer_id": self.peer_id,
            "host": self.host,
            "port": self.port,
            "topics": sorted(self._subs),
        }
        try:
            with socket.create_connection((host, port), timeout=10) as s:
                chan = self._wrap_client(s, expect_pubkey)
                chan.send_frame(FRAME_HELLO, json.dumps(hello).encode())
                ftype, body = chan.recv_frame()
        except OSError as e:
            raise ConnectionError(f"dial {host}:{port} failed: {e}") from None
        if ftype != FRAME_HELLO:
            return None
        peer = json.loads(body)
        # only a key the handshake PROVED may pin -- never one claimed in
        # the reply body, and never the caller's unverified expectation
        # (with authenticate off, expect_pubkey was not checked by anyone)
        peer.pop("identity_pk", None)
        proved = getattr(chan, "peer_pubkey", None)
        if proved is not None:
            peer["identity_pk"] = bytes(proved).hex()
        self._record_peer(peer)
        return peer["peer_id"]

    def bootstrap(self, bootnode: Bootnode | tuple) -> int:
        """Register with the bootnode and dial every listed peer."""
        host, port = (
            (bootnode.host, bootnode.port)
            if isinstance(bootnode, Bootnode)
            else bootnode
        )
        register = {
            "op": "register",
            "peer_id": self.peer_id,
            "host": self.host,
            "port": self.port,
        }
        if self.authenticate and self.identity_sk is not None:
            seq = time.time_ns()
            register["identity_pk"] = (
                self.identity_sk.public_key().to_bytes().hex()
            )
            register["seq"] = seq
            register["register_proof"] = _sign_register_proof(
                self.identity_sk, self.peer_id, self.host, self.port, seq
            )
        Bootnode.rpc(host, port, register)
        listed = Bootnode.rpc(host, port, {"op": "list"})["peers"]
        connected = 0
        for p in listed:
            if p["peer_id"] == self.peer_id:
                continue
            try:
                # inside the try: a poisoned registration (malformed hex,
                # wrong type) must skip THIS peer, not abort the bootstrap
                pk_hex = p.get("identity_pk")
                expect = bytes.fromhex(pk_hex) if pk_hex else None
                if self.connect_to(p["host"], p["port"], expect_pubkey=expect):
                    connected += 1
            except (ConnectionError, ValueError, TypeError):
                continue
        return connected

    # -- internals -----------------------------------------------------------

    def _record_peer(self, peer: dict) -> None:
        with self._lock:
            prev = self._peers.get(peer["peer_id"], {})
            prev_pin = prev.get("identity_pk")
            new_pin = peer.get("identity_pk")
            if prev_pin and new_pin and new_pin != prev_pin:
                # a DIFFERENT proved key claiming an already-pinned peer id
                # is a hijack attempt: adopting it (key OR address) would
                # redirect the persistent dials to the newcomer. Drop the
                # record; the legitimate peer keeps its pin and address.
                return
            self._peers[peer["peer_id"]] = {
                "host": peer["host"],
                "port": peer["port"],
                # an existing pin survives re-records (HELLO refreshes
                # carry no identity; they must not unpin a peer)
                "identity_pk": new_pin or prev_pin,
                "topics": set(peer.get("topics", ())),
            }
            # mesh maintenance: a new subscriber can graft into any topic
            # mesh that is below degree; grafts are SYMMETRIC (gossipsub
            # GRAFT control) so the mesh union is an undirected connected
            # graph, not a one-way star
            graft_topics = []
            for topic in peer.get("topics", ()):
                # a topology change invalidates stale prune verdicts
                self._pruned_by.get(topic, set()).discard(peer["peer_id"])
                mesh = self._mesh.setdefault(topic, set())
                if (
                    peer["peer_id"] not in mesh
                    and len(mesh) < self.mesh_degree
                ):
                    mesh.add(peer["peer_id"])
                    self.scorer.on_graft(peer["peer_id"], topic)
                    graft_topics.append(topic)
        for topic in graft_topics:
            self._send_graft(peer["peer_id"], topic)

    def _send_graft(self, peer_id: str, topic: str) -> None:
        conn = self._conn_for(peer_id)
        if conn is None:
            return
        try:
            conn.send(
                FRAME_GRAFT,
                json.dumps(
                    {"peer_id": self.peer_id, "topic": topic}
                ).encode(),
            )
        except OSError:
            pass

    def _conn_for(self, peer_id: str) -> "_PeerConn | None":
        with self._lock:
            info = self._peers.get(peer_id)
            if info is None:
                return None
            conn = self._conns.get(peer_id)
            if conn is None:
                pk_hex = info.get("identity_pk")
                expect = bytes.fromhex(pk_hex) if pk_hex else None
                conn = self._conns[peer_id] = _PeerConn(
                    info["host"],
                    info["port"],
                    wrap=lambda s, e=expect: self._wrap_client(s, e),
                )
            return conn

    def _drop_peer(self, peer_id: str) -> None:
        self.scorer.forget(peer_id)
        self._score_cache.pop(peer_id, None)
        with self._lock:
            self._peers.pop(peer_id, None)
            conn = self._conns.pop(peer_id, None)
            for mesh in self._mesh.values():
                mesh.discard(peer_id)
        if conn is not None:
            conn.close()
        # backfill meshes from remaining subscribers -- symmetrically
        # (send GRAFT) and never toward a peer that PRUNEd us
        grafts = []
        with self._lock:
            for topic, mesh in self._mesh.items():
                if len(mesh) < self.mesh_degree:
                    candidates = [
                        pid
                        for pid, info in self._peers.items()
                        if topic in info["topics"]
                        and pid not in mesh
                        and pid not in self._pruned_by.get(topic, ())
                    ]
                    self.rng.shuffle(candidates)
                    for pid in candidates[: self.mesh_degree - len(mesh)]:
                        mesh.add(pid)
                        grafts.append((pid, topic))
        for pid, topic in grafts:
            self._send_graft(pid, topic)

    def _msg_id(self, topic: str, data: bytes) -> bytes:
        return hashlib.sha256(topic.encode() + data).digest()[:20]

    def _mark_seen(self, msg_id: bytes) -> bool:
        """True if newly seen."""
        with self._lock:
            if msg_id in self._seen:
                return False
            self._seen[msg_id] = True
            while len(self._seen) > SEEN_CACHE_SIZE:
                self._seen.popitem(last=False)
            return True

    def _cached_scores(self, peer_ids) -> dict[str, float]:
        """Fresh-enough scores for `peer_ids`, recomputed at most once
        per `score_ttl_s` per peer. MUST be called outside the bus lock:
        a cache miss takes the scorer lock and runs lazy decay over the
        peer's topics."""
        now = time.monotonic()
        out = {}
        for pid in peer_ids:
            hit = self._score_cache.get(pid)
            if hit is None or now - hit[1] >= self.score_ttl_s:
                hit = (self.scorer.score(pid), now)
                self._score_cache[pid] = hit
            out[pid] = hit[0]
        if len(self._score_cache) > 4 * max(len(out), 64):
            # forget snapshot entries for long-gone peers
            stale = [
                p
                for p, (_, stamp) in list(self._score_cache.items())
                if now - stamp >= self.score_ttl_s
            ]
            for p in stale:
                self._score_cache.pop(p, None)
        return out

    def _gossip_send(self, topic: str, data: bytes, exclude: str | None) -> int:
        """Eager-push to the topic MESH over persistent connections (the
        gossipsub relay; flood only if the mesh is empty but subscribers
        exist, which covers bootstrap races)."""
        body = (
            struct.pack(">H", len(topic))
            + topic.encode()
            + struct.pack(">H", len(self.peer_id))
            + self.peer_id.encode()
            + data
        )
        # snapshot scores OUTSIDE the bus lock (relay cost was
        # O(subscribers x their topics) per message under BOTH locks)
        with self._lock:
            candidates = set(self._mesh.get(topic, ())) | {
                pid
                for pid, info in self._peers.items()
                if topic in info["topics"]
            }
        scores = self._cached_scores(candidates)
        with self._lock:
            mesh = set(self._mesh.get(topic, ()))
            # behavioral eviction: peers scored below the prune threshold
            # leave the mesh (and get a PRUNE) before this relay
            evict = {
                p
                for p in mesh
                if scores.get(p, 0.0) < self.scorer.prune_threshold
            }
            if evict:
                self._mesh[topic] = mesh - evict
                mesh -= evict
                for p in evict:
                    self.scorer.on_prune(p, topic)
            subscribers = {
                pid
                for pid, info in self._peers.items()
                if topic in info["topics"]
                # gossip_threshold: stop relaying TO low-score peers
                and scores.get(pid, 0.0) >= self.scorer.gossip_threshold
            }
            # backfill the mesh after eviction (every other removal path
            # re-grafts; eviction must not strand the mesh below degree)
            backfill = []
            if evict and len(mesh) < self.mesh_degree:
                candidates = [
                    pid
                    for pid in subscribers
                    if pid not in mesh
                    and pid not in evict
                    and pid not in self._pruned_by.get(topic, set())
                ]
                backfill = candidates[: self.mesh_degree - len(mesh)]
                self._mesh[topic].update(backfill)
                mesh.update(backfill)
                for pid in backfill:
                    self.scorer.on_graft(pid, topic)
        for pid in backfill:
            self._send_graft(pid, topic)
        # symmetric PRUNE (outside the lock: network sends): the evicted
        # peer must drop US from its mesh too or it keeps pushing to us
        for p in evict:
            conn = self._conn_for(p)
            if conn is not None:
                try:
                    conn.send(
                        FRAME_PRUNE,
                        json.dumps(
                            {"peer_id": self.peer_id, "topic": topic, "px": []}
                        ).encode(),
                    )
                except OSError:
                    pass
        subscribers.discard(exclude)
        # exclude FIRST: a mesh shrunk to exactly the upstream sender must
        # fall back to the other known subscribers, not relay to nobody
        targets = (mesh & subscribers) or subscribers
        sent = 0
        for pid in targets:
            conn = self._conn_for(pid)
            if conn is None:
                continue
            try:
                conn.send(FRAME_GOSSIP, body)
                sent += 1
                self.stats["gossip_frames_sent"] += 1
            except OSError:
                self._drop_peer(pid)
        return sent

    def _handle_frame(self, chan, ftype: int, body: bytes, bucket=None) -> None:
        if ftype == FRAME_HELLO:
            peer = json.loads(body)
            # inbound side: pin the identity the dialer PROVED during the
            # handshake (chan.peer_pubkey), never one it merely claims
            proved = getattr(chan, "peer_pubkey", None)
            if proved is not None:
                peer["identity_pk"] = bytes(proved).hex()
            else:
                peer.pop("identity_pk", None)
            self._record_peer(peer)
            reply = {
                "peer_id": self.peer_id,
                "host": self.host,
                "port": self.port,
                "topics": sorted(self._subs),
            }
            chan.send_frame(FRAME_HELLO, json.dumps(reply).encode())
            return
        if ftype == FRAME_GRAFT:
            msg = json.loads(body)
            topic = msg["topic"]
            refuse = False
            with self._lock:
                if msg["peer_id"] in self._peers:
                    # a graft IS a subscription signal: without recording
                    # it, the `mesh & subscribers` send filter would
                    # silently starve the grafted peer
                    self._peers[msg["peer_id"]]["topics"].add(topic)
                    mesh = self._mesh.setdefault(topic, set())
                    if msg["peer_id"] in mesh:
                        pass
                    elif self.scorer.should_prune(msg["peer_id"]):
                        # an evicted peer cannot graft straight back in:
                        # behavioral eviction must outlast a re-GRAFT
                        refuse = True
                        self.scorer.on_behaviour_penalty(
                            msg["peer_id"], 0.5
                        )
                    elif len(mesh) < 2 * self.mesh_degree:
                        # accept grafts up to 2x degree (gossipsub D_high)
                        mesh.add(msg["peer_id"])
                        self.scorer.on_graft(msg["peer_id"], topic)
                    else:
                        refuse = True
                        # repeated grafts into a saturated mesh are the
                        # gossipsub behaviour-penalty case (P7)
                        self.scorer.on_behaviour_penalty(msg["peer_id"], 0.5)
            if refuse:
                # full mesh: PRUNE so the grafter re-grafts elsewhere,
                # carrying peer-exchange suggestions (gossipsub PX) so a
                # late joiner facing saturated meshes still finds a seat
                with self._lock:
                    px = self.rng.sample(
                        sorted(self._mesh.get(topic, ())),
                        k=min(2, len(self._mesh.get(topic, ()))),
                    )
                conn = self._conn_for(msg["peer_id"])
                if conn is not None:
                    try:
                        conn.send(
                            FRAME_PRUNE,
                            json.dumps(
                                {
                                    "peer_id": self.peer_id,
                                    "topic": topic,
                                    "px": px,
                                }
                            ).encode(),
                        )
                    except OSError:
                        pass
            return
        if ftype == FRAME_PRUNE:
            msg = json.loads(body)
            topic = msg["topic"]
            with self._lock:
                self._mesh.get(topic, set()).discard(msg["peer_id"])
                self._pruned_by.setdefault(topic, set()).add(msg["peer_id"])
                mesh = self._mesh.setdefault(topic, set())
                # PX suggestions first (they have capacity signals), then
                # any other known subscriber we have not been pruned by
                candidates = [
                    pid
                    for pid in msg.get("px", ())
                    if pid in self._peers
                    and pid != self.peer_id
                    and pid not in mesh
                ]
                others = [
                    pid
                    for pid, info in self._peers.items()
                    if topic in info["topics"]
                    and pid not in mesh
                    and pid not in self._pruned_by[topic]
                    and pid not in candidates
                ]
                self.rng.shuffle(others)
                candidates.extend(others)
                chosen = candidates[: max(self.mesh_degree - len(mesh), 1)]
                mesh.update(chosen)
            for pid in chosen:
                self._send_graft(pid, topic)
            return
        if ftype == FRAME_GOSSIP:
            (tlen,) = struct.unpack_from(">H", body, 0)
            topic = body[2 : 2 + tlen].decode()
            pos = 2 + tlen
            (plen,) = struct.unpack_from(">H", body, pos)
            source = body[pos + 2 : pos + 2 + plen].decode()
            data = body[pos + 2 + plen :]
            with self._lock:
                if self.scorer.graylisted(source):
                    self.stats["gossip_graylisted"] = (
                        self.stats.get("gossip_graylisted", 0) + 1
                    )
                    return
            first = self._mark_seen(self._msg_id(topic, data))
            with self._lock:
                self.scorer.on_deliver(source, topic, first)
            if not first:
                return
            handler = self._subs.get(topic)
            if handler is not None:
                payload = self.codec.decode_gossip(topic, data)
                handler(payload, source)
            # relay onward through the mesh, not back to the sender
            self._gossip_send(topic, data, exclude=source)
            return
        if ftype == FRAME_REQ:
            (plen,) = struct.unpack_from(">H", body, 0)
            protocol = body[2 : 2 + plen].decode()
            pos = 2 + plen
            (rlen,) = struct.unpack_from(">H", body, pos)
            requester = body[pos + 2 : pos + 2 + rlen].decode()
            data = body[pos + 2 + rlen :]
            # per-connection token bucket (rpc/rate_limiter.rs):
            # over-quota requesters get an error chunk, not service
            if bucket is not None and not bucket.allow():
                self.stats["requests_rejected"] += 1
                chan.send_frame(FRAME_RESP, b"\x01rate limited")
                return
            handler = self._rpc.get(protocol)
            if handler is None:
                chan.send_frame(FRAME_RESP, b"\x01unknown protocol")
                return
            try:
                payload = self.codec.decode_request(protocol, data)
                result = handler(payload, requester or "remote")
                chan.send_frame(
                    FRAME_RESP,
                    b"\x00" + self.codec.encode_response(protocol, result),
                )
            # lint: allow[broad-except] -- RPC dispatch boundary: the
            # handler is arbitrary application code and a remote request
            # must never kill the connection thread; the failure is
            # counted and returned to the requester, not dropped
            except Exception as e:  # noqa: BLE001
                self.stats["rpc_handler_errors"] = (
                    self.stats.get("rpc_handler_errors", 0) + 1
                )
                chan.send_frame(
                    FRAME_RESP, b"\x01" + str(e).encode()[:512]
                )
            return

"""discv5-style UDP peer discovery with signed node records.

Reference: beacon_node/lighthouse_network/src/discovery/ (the discv5 UDP
DHT; enr.rs ENR fields incl. the eth2 fork digest and attnets/syncnets
subnet bits; subnet_predicate.rs peer-for-subnet selection) and
boot_node/ (the standalone discovery-only node).

TPU-native design divergences, both deliberate: node identity keys are
BLS12-381 — the framework's native signature scheme — rather than
secp256k1 ECDSA, and the record wire format is SSZ (this repo's native
codec) rather than RLP. Everything else follows discv5's shape:

- **ENR**: signed, seq-versioned node records carrying (ip, udp, tcp,
  fork_digest, attnets, syncnets). Higher seq supersedes; records are
  verified against the embedded pubkey (memoized — a BLS verify on the
  pure-Python oracle costs ~2 s, so each distinct record body is checked
  at most once per process).
- **Routing table**: XOR-metric k-buckets over sha256 node ids
  (log2-distance buckets, k=16).
- **Protocol**: PING/PONG liveness with observed-address feedback (the
  ip-vote that lets a node learn its external address), FINDNODE by
  log2 distance → NODES batches, iterative alpha-parallel LOOKUP.
- **Subnet advertisement**: attnets bits in the record;
  `peers_on_subnet` filters the live table the way the reference's
  subnet predicate gates peer dials.

Transport is one UDP socket per service; messages are JSON envelopes
(control metadata) carrying hex-encoded SSZ ENRs (the signed payload —
signatures cover SSZ bytes, never the JSON framing).


The port's copy of lighthouse_tpu/network/discovery.py.
"""

import hashlib
import json
import os
import secrets
import socket
import threading
import time

from ..crypto.bls import api as bls
from ..ssz import Bytes4, Bytes48, Bytes96, ByteVector, container, uint64

Bytes8 = ByteVector(8)

K_BUCKET = 16
MAX_NODES_REPLY = 16
ATT_SUBNET_COUNT = 64
SYNC_SUBNET_COUNT = 4


def _make_enr_content():
    @container
    class EnrContent:
        seq: uint64
        pubkey: Bytes48
        ip: Bytes4
        udp_port: uint64
        tcp_port: uint64
        fork_digest: Bytes4
        attnets: Bytes8
        syncnets: Bytes8

    return EnrContent


EnrContent = _make_enr_content()


def _ip_bytes(host: str) -> bytes:
    try:
        return socket.inet_aton(host)
    except OSError:
        return socket.inet_aton("127.0.0.1")


class Enr:
    """A signed node record (discovery/enr.rs; discv5 spec shape)."""

    _verified: dict[bytes, bool] = {}  # memo: record bytes -> verdict

    def __init__(self, content: "EnrContent", signature: bytes):
        self.content = content
        self.signature = bytes(signature)

    # -- identity -------------------------------------------------------------

    @property
    def node_id(self) -> bytes:
        """sha256 of the identity pubkey (discv5 derives node ids by
        hashing the key; the metric space below is XOR over these)."""
        return hashlib.sha256(bytes(self.content.pubkey)).digest()

    @property
    def seq(self) -> int:
        return int(self.content.seq)

    @property
    def ip(self) -> str:
        return socket.inet_ntoa(bytes(self.content.ip))

    @property
    def udp_addr(self) -> tuple:
        return (self.ip, int(self.content.udp_port))

    @property
    def tcp_addr(self) -> tuple:
        return (self.ip, int(self.content.tcp_port))

    def has_attnet(self, subnet: int) -> bool:
        bits = bytes(self.content.attnets)
        return bool(bits[subnet // 8] >> (subnet % 8) & 1)

    def has_syncnet(self, subnet: int) -> bool:
        bits = bytes(self.content.syncnets)
        return bool(bits[subnet // 8] >> (subnet % 8) & 1)

    # -- wire -----------------------------------------------------------------

    def to_bytes(self) -> bytes:
        return self.content.as_ssz_bytes() + self.signature

    @classmethod
    def from_bytes(cls, data: bytes) -> "Enr":
        return cls(
            EnrContent.from_ssz_bytes(data[:-96]), data[-96:]
        )

    def verify(self) -> bool:
        """Check the BLS signature over the SSZ content bytes, memoized
        per distinct record body."""
        key = self.to_bytes()
        hit = Enr._verified.get(key)
        if hit is None:
            # pinned to the CPU oracle: identity records are control
            # plane, verified once each -- never routed through the
            # ambient batch backend (which may be `fake` under test)
            from ..crypto.bls.backends import cpu as cpu_bls

            try:
                pk = bls.PublicKey.from_bytes(bytes(self.content.pubkey))
                sig = bls.Signature.from_bytes(self.signature)
                hit = cpu_bls.verify_signature_sets(
                    [
                        bls.SignatureSet.single_pubkey(
                            sig, pk, _enr_signing_root(self.content)
                        )
                    ]
                )
            except (ValueError, IndexError):  # BlsError is a ValueError:
                hit = False  # malformed record == invalid, never fatal
            if len(Enr._verified) > 4096:
                Enr._verified.clear()
            Enr._verified[key] = hit
        return hit


def _enr_signing_root(content: "EnrContent") -> bytes:
    return hashlib.sha256(b"lighthouse-tpu-enr" + content.as_ssz_bytes()).digest()


def _subnet_bits(subnets, count: int) -> bytes:
    out = bytearray(8)
    for s in subnets or ():
        if not 0 <= s < count:
            raise ValueError(f"subnet {s} out of range")
        out[s // 8] |= 1 << (s % 8)
    return bytes(out)


def make_enr(
    sk: "bls.SecretKey",
    host: str,
    udp_port: int,
    tcp_port: int = 0,
    fork_digest: bytes = b"\x00" * 4,
    attnets=(),
    syncnets=(),
    seq: int = 1,
) -> Enr:
    content = EnrContent(
        seq=seq,
        pubkey=sk.public_key().to_bytes(),
        ip=_ip_bytes(host),
        udp_port=udp_port,
        tcp_port=tcp_port,
        fork_digest=bytes(fork_digest),
        attnets=_subnet_bits(attnets, ATT_SUBNET_COUNT),
        syncnets=_subnet_bits(syncnets, SYNC_SUBNET_COUNT),
    )
    sig = sk.sign(_enr_signing_root(content)).to_bytes()
    enr = Enr(content, sig)
    Enr._verified[enr.to_bytes()] = True  # self-signed: trivially valid
    return enr


def log2_distance(a: bytes, b: bytes) -> int:
    """discv5 log2 XOR distance: 0 for identical ids, else bit length of
    the XOR (1..256)."""
    x = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    return x.bit_length()


class RoutingTable:
    """XOR-metric k-buckets of verified ENRs (discv5's kbucket table).
    Bucket i holds nodes at log2 distance i; each bucket keeps at most
    K_BUCKET entries, preferring incumbents (discv5 keeps long-lived
    nodes; newcomers wait for an eviction)."""

    def __init__(self, local_id: bytes, k: int = K_BUCKET):
        self.local_id = local_id
        self.k = k
        self._buckets: dict[int, dict[bytes, Enr]] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buckets.values())

    def add(self, enr: Enr) -> bool:
        """Insert/refresh a record; higher seq supersedes. False if the
        bucket is full of other incumbents or the record is our own."""
        nid = enr.node_id
        d = log2_distance(self.local_id, nid)
        if d == 0:
            return False
        with self._lock:
            bucket = self._buckets.setdefault(d, {})
            cur = bucket.get(nid)
            if cur is not None:
                if enr.seq >= cur.seq:
                    bucket[nid] = enr
                return True
            if len(bucket) >= self.k:
                return False
            bucket[nid] = enr
            return True

    def remove(self, node_id: bytes) -> None:
        d = log2_distance(self.local_id, node_id)
        with self._lock:
            self._buckets.get(d, {}).pop(node_id, None)

    def at_distance(self, d: int) -> list:
        with self._lock:
            return list(self._buckets.get(d, {}).values())

    def enrs(self) -> list:
        with self._lock:
            return [e for b in self._buckets.values() for e in b.values()]

    def closest(self, target: bytes, n: int) -> list:
        return sorted(
            self.enrs(),
            key=lambda e: int.from_bytes(e.node_id, "big")
            ^ int.from_bytes(target, "big"),
        )[:n]


class DiscoveryService:
    """One UDP discovery endpoint: serves PING/FINDNODE, issues
    PING/FINDNODE/LOOKUP, maintains the routing table and the local
    signed record (discovery/mod.rs Discovery behaviour + discv5)."""

    def __init__(
        self,
        sk: "bls.SecretKey",
        host: str = "127.0.0.1",
        udp_port: int = 0,
        tcp_port: int = 0,
        fork_digest: bytes = b"\x00" * 4,
        attnets=(),
        syncnets=(),
        verify_sigs: bool = True,
        rpc_timeout: float = 2.0,
    ):
        self.sk = sk
        self.verify_sigs = verify_sigs
        self.rpc_timeout = rpc_timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, udp_port))
        self.host, self.udp_port = self._sock.getsockname()
        self.local_enr = make_enr(
            sk,
            self.host,
            self.udp_port,
            tcp_port,
            fork_digest,
            attnets,
            syncnets,
        )
        self.node_id = self.local_enr.node_id
        self.table = RoutingTable(self.node_id)
        self._waiters: dict[str, list] = {}  # rpc id -> [event, reply]
        self._ip_votes: dict[str, set] = {}  # observed ip -> voting peers
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()
        self.stats = {"pings": 0, "findnodes": 0, "bad_sigs": 0}

    # -- local record maintenance --------------------------------------------

    def update_local_enr(
        self, attnets=None, syncnets=None, fork_digest=None, ip=None
    ) -> None:
        """Re-sign the local record with bumped seq (enr.rs
        update_local_enr; how subnet subscriptions are advertised)."""
        c = self.local_enr.content
        self.local_enr = Enr(
            EnrContent(
                seq=c.seq + 1,
                pubkey=c.pubkey,
                ip=_ip_bytes(ip) if ip is not None else c.ip,
                udp_port=c.udp_port,
                tcp_port=c.tcp_port,
                fork_digest=(
                    bytes(fork_digest)
                    if fork_digest is not None
                    else c.fork_digest
                ),
                attnets=(
                    _subnet_bits(attnets, ATT_SUBNET_COUNT)
                    if attnets is not None
                    else c.attnets
                ),
                syncnets=(
                    _subnet_bits(syncnets, SYNC_SUBNET_COUNT)
                    if syncnets is not None
                    else c.syncnets
                ),
            ),
            b"",
        )
        sig = self.sk.sign(_enr_signing_root(self.local_enr.content))
        self.local_enr = Enr(self.local_enr.content, sig.to_bytes())
        Enr._verified[self.local_enr.to_bytes()] = True

    # -- table ingestion -------------------------------------------------------

    def _ingest(self, enr_hex: str) -> "Enr | None":
        try:
            enr = Enr.from_bytes(bytes.fromhex(enr_hex))
        except (TypeError, ValueError, IndexError):
            # remote-controlled input: non-string json value (TypeError),
            # bad hex / truncated SSZ (SszError is a ValueError)
            return None
        if self.verify_sigs and not enr.verify():
            self.stats["bad_sigs"] += 1
            return None
        self.table.add(enr)
        return enr

    # -- outbound rpcs ---------------------------------------------------------

    def _rpc(self, addr: tuple, msg: dict) -> "dict | None":
        rid = secrets.token_hex(8)
        msg["id"] = rid
        ev = threading.Event()
        slot = [ev, None]
        with self._lock:
            self._waiters[rid] = slot
        try:
            self._sock.sendto(json.dumps(msg).encode(), addr)
            if not ev.wait(self.rpc_timeout):
                return None
            return slot[1]
        except OSError:
            return None
        finally:
            with self._lock:
                self._waiters.pop(rid, None)

    def ping(self, addr: tuple) -> "dict | None":
        """PING -> PONG: liveness + seq + observed-address feedback."""
        reply = self._rpc(
            addr,
            {"t": "ping", "enr": self.local_enr.to_bytes().hex()},
        )
        if reply is None:
            return None
        if "enr" in reply:
            self._ingest(reply["enr"])
        obs = reply.get("observed")
        if (
            obs
            and isinstance(obs, (list, tuple))
            and isinstance(obs[0], str)
            and obs[0] != self.local_enr.ip
        ):
            # the ip VOTE (discv5 majority rule, not single-reply trust):
            # re-sign the record only once a SECOND distinct peer reports
            # the same different address, and only if it parses as an ip
            # (otherwise one lying/buggy peer rewrites our reachability)
            try:
                socket.inet_aton(obs[0])
            except OSError:
                return reply
            voters = self._ip_votes.setdefault(obs[0], set())
            voters.add(addr)
            if len(voters) >= 2:
                self._ip_votes.clear()
                self.update_local_enr(ip=obs[0])
        return reply

    def find_node(self, addr: tuple, distances) -> list:
        """FINDNODE(distances) -> NODES: records from the peer's buckets."""
        reply = self._rpc(
            addr,
            {
                "t": "findnode",
                "distances": list(distances),
                "enr": self.local_enr.to_bytes().hex(),
            },
        )
        if reply is None:
            return []
        out = []
        for h in reply.get("enrs", ()):
            enr = self._ingest(h)
            if enr is not None:
                out.append(enr)
        return out

    def lookup(self, target: "bytes | None" = None, alpha: int = 3, rounds: int = 3) -> list:
        """Iterative lookup toward `target` (random walk if None): each
        round queries the alpha closest not-yet-asked nodes for the
        distances bracketing the target (discv5's recursive FINDNODE)."""
        target = target or secrets.token_bytes(32)
        asked: set[bytes] = set()
        for _ in range(rounds):
            cand = [
                e for e in self.table.closest(target, alpha * 2)
                if e.node_id not in asked
            ][:alpha]
            if not cand:
                break
            # the alpha queries of a round run CONCURRENTLY: a round costs
            # one rpc timeout even when every candidate is dead, not alpha
            threads = []
            for enr in cand:
                asked.add(enr.node_id)
                d = log2_distance(enr.node_id, target)
                ds = sorted({max(1, d - 1), d, min(256, d + 1)})
                th = threading.Thread(
                    target=self.find_node, args=(enr.udp_addr, ds), daemon=True
                )
                th.start()
                threads.append(th)
            for th in threads:
                th.join(timeout=self.rpc_timeout + 1.0)
        return self.table.closest(target, K_BUCKET)

    def bootstrap(self, boot_addr: tuple) -> int:
        """Join via a boot node: PING it, pull our neighborhood, then a
        random walk to spread across buckets. Returns table size."""
        if self.ping(boot_addr) is None:
            return len(self.table)
        self.find_node(
            boot_addr, sorted({256, 255, 254, 253, 252})
        )
        self.lookup(self.node_id)
        self.lookup(None)
        return len(self.table)

    def peers_on_subnet(self, subnet: int, sync: bool = False) -> list:
        """Records advertising the subnet bit (subnet_predicate.rs)."""
        return [
            e
            for e in self.table.enrs()
            if (e.has_syncnet(subnet) if sync else e.has_attnet(subnet))
        ]

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # -- server side -----------------------------------------------------------

    def _recv_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                data, addr = self._sock.recvfrom(65535)
            except OSError:
                return
            try:
                msg = json.loads(data)
                if not isinstance(msg, dict):
                    continue
                self._dispatch(msg, addr)
            # lint: allow[broad-except] -- datagram ingress boundary: a
            # single crafted packet must never kill the recv loop (remote
            # DoS otherwise); failures are counted, not dropped silently
            except Exception:  # noqa: BLE001
                self.stats["bad_datagrams"] = (
                    self.stats.get("bad_datagrams", 0) + 1
                )
                continue

    def _dispatch(self, msg: dict, addr: tuple) -> None:
        t = msg.get("t")
        if t == "ping":
            self.stats["pings"] += 1
            if "enr" in msg:
                self._ingest(msg["enr"])
            self._send(
                addr,
                {
                    "t": "pong",
                    "id": msg.get("id"),
                    "enr": self.local_enr.to_bytes().hex(),
                    "enr_seq": self.local_enr.seq,
                    "observed": [addr[0], addr[1]],
                },
            )
        elif t == "findnode":
            self.stats["findnodes"] += 1
            if "enr" in msg:
                self._ingest(msg["enr"])
            enrs = []
            for d in msg.get("distances", ())[:8]:
                if d == 0:
                    enrs.append(self.local_enr)
                    continue
                enrs.extend(self.table.at_distance(int(d)))
            self._send(
                addr,
                {
                    "t": "nodes",
                    "id": msg.get("id"),
                    "enrs": [
                        e.to_bytes().hex()
                        for e in enrs[:MAX_NODES_REPLY]
                    ],
                },
            )
        elif t in ("pong", "nodes"):
            with self._lock:
                slot = self._waiters.get(msg.get("id"))
            if slot is not None:
                slot[1] = msg
                slot[0].set()

    def _send(self, addr: tuple, msg: dict) -> None:
        try:
            self._sock.sendto(json.dumps(msg).encode(), addr)
        except OSError:
            pass


class DiscoveryBootNode:
    """Standalone discovery-only node (reference boot_node/): a
    DiscoveryService with no chain behind it, relaying records between
    joining peers. Signature verification stays ON unless the caller
    opts out (a boot node vouches for records it hands out)."""

    def __init__(
        self,
        sk: "bls.SecretKey | None" = None,
        host: str = "127.0.0.1",
        udp_port: int = 0,
        verify_sigs: bool = True,
    ):
        self.service = DiscoveryService(
            sk or bls.SecretKey(int.from_bytes(os.urandom(24), "big")),
            host=host,
            udp_port=udp_port,
            verify_sigs=verify_sigs,
        )
        self.host = self.service.host
        self.udp_port = self.service.udp_port

    @property
    def enr(self) -> Enr:
        return self.service.local_enr

    def stop(self) -> None:
        self.service.stop()

"""mev-boost builder flow (reference builder_client/src/lib.rs + the
builder paths in beacon_node/execution_layer/src/lib.rs, mocked by
test_utils/mock_builder.rs):

  1. the VC's preparation service registers validators with the builder
     (SignedValidatorRegistration, application-builder domain),
  2. block production asks the builder for a header-only bid
     (get_header -> SignedBuilderBid), builds and signs a BLINDED block,
  3. submitting the signed blinded block makes the builder reveal the
     full ExecutionPayload, which unblinds into the publishable block.

Transport is the builder REST surface (builder-specs paths) with SSZ
request/response bodies (the spec's application/octet-stream encoding),
served in-process by `BuilderHttpServer` over a real socket.

The port's copy of lighthouse_tpu/execution_layer/builder.py.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..types import compute_domain, compute_signing_root, types_for
from ..types.chain_spec import DOMAIN_APPLICATION_BUILDER
from ..types.containers import (
    SignedValidatorRegistration,
    ValidatorRegistrationV1,
)

REGISTRATION_SSZ_LEN = 180  # fixed-size SignedValidatorRegistration


class BuilderError(RuntimeError):
    pass


class NoBidAvailable(BuilderError):
    """Builder has no bid for this slot/parent (HTTP 204)."""


def builder_signing_root(message, spec) -> bytes:
    """Application-builder domain: genesis fork version, EMPTY
    genesis_validators_root (builder-specs; reference signing logic in
    validator_store.rs sign_validator_registration)."""
    domain = compute_domain(
        DOMAIN_APPLICATION_BUILDER, spec.genesis_fork_version, bytes(32)
    )
    return compute_signing_root(message, domain)


def header_from_payload(payload, preset):
    """ExecutionPayload -> consensus ExecutionPayloadHeader (SSZ
    transactions root, NOT the MPT root -- consensus-layer semantics)."""
    from ..state_transition.per_block import payload_to_header

    return payload_to_header(payload, preset)


def unblind_signed_block(signed_blinded, payload, preset):
    """SignedBlindedBeaconBlock + revealed payload -> full
    SignedBeaconBlock. Raises BuilderError if the payload does not match
    the header the proposer committed to (a lying builder)."""
    t = types_for(preset)
    blinded = signed_blinded.message
    committed_root = blinded.body.execution_payload_header.tree_hash_root()
    revealed_root = header_from_payload(payload, preset).tree_hash_root()
    if committed_root != revealed_root:
        raise BuilderError("revealed payload does not match the signed header")
    body = blinded.body
    full_body = t.BeaconBlockBodyBellatrix(
        randao_reveal=body.randao_reveal,
        eth1_data=body.eth1_data,
        graffiti=body.graffiti,
        proposer_slashings=body.proposer_slashings,
        attester_slashings=body.attester_slashings,
        attestations=body.attestations,
        deposits=body.deposits,
        voluntary_exits=body.voluntary_exits,
        sync_aggregate=body.sync_aggregate,
        execution_payload=payload,
    )
    full = t.BeaconBlockBellatrix(
        slot=blinded.slot,
        proposer_index=blinded.proposer_index,
        parent_root=blinded.parent_root,
        state_root=blinded.state_root,
        body=full_body,
    )
    # the unblinded block must hash to the very root the proposer signed
    if full.tree_hash_root() != blinded.tree_hash_root():
        raise BuilderError("unblinded block root diverges from signed root")
    return t.SignedBeaconBlockBellatrix(
        message=full, signature=bytes(signed_blinded.signature)
    )


# --- the builder itself (mock; reference test_utils/mock_builder.rs) --------


class MockBuilder:
    """An in-process block builder over an ExecutionLayer: serves signed
    bids for its payloads and reveals them on submission. Fault knobs:

      * `refuse_reveal`  -- accept the signed blinded block, never reveal
                            (the classic builder griefing case)
      * `corrupt_header` -- bid a header that doesn't match the payload
      * `no_bid`         -- decline to bid entirely
    """

    def __init__(self, execution_layer, preset, spec, secret_key=None, chain=None):
        from ..crypto.bls.api import SecretKey

        self.el = execution_layer
        self.preset = preset
        self.spec = spec
        # the chain the builder watches (mock_builder.rs holds a BN handle):
        # payload attributes must match what process_execution_payload will
        # check -- state-derived timestamp and randao mix
        self.chain = chain
        self.sk = secret_key or SecretKey(0x42B1DE5)
        self.pubkey = self.sk.public_key()
        self.t = types_for(preset)
        self.registrations: dict[bytes, object] = {}  # pubkey -> registration
        self._payloads: dict[bytes, object] = {}  # header root -> payload
        self.refuse_reveal = False
        self.corrupt_header = False
        self.no_bid = False
        self.bid_value = 10**18  # wei

    # -- builder-specs verbs -------------------------------------------------

    def register_validators(self, registrations) -> None:
        """POST /eth/v1/builder/validators (signature checking mirrors the
        reference mock: structural + known-pubkey only)."""
        for signed in registrations:
            self.registrations[bytes(signed.message.pubkey)] = signed

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes):
        """GET /eth/v1/builder/header/{slot}/{parent_hash}/{pubkey} ->
        SignedBuilderBid. The proposer must be registered (fee recipient
        comes from its registration)."""
        if self.no_bid:
            raise NoBidAvailable("builder declined to bid")
        reg = self.registrations.get(bytes(pubkey))
        if reg is None:
            raise NoBidAvailable("proposer not registered with this builder")
        payload = self.el.get_payload(
            bytes(parent_hash),
            self._timestamp_for(slot),
            self._randao_for(slot),
            fee_recipient=bytes(reg.message.fee_recipient),
        )
        header = header_from_payload(payload, self.preset)
        if self.corrupt_header:
            header.gas_used = int(header.gas_used) + 1
        self._payloads[header.tree_hash_root()] = payload
        bid = self.t.BuilderBid(
            header=header, value=self.bid_value, pubkey=self.pubkey.to_bytes()
        )
        sig = self.sk.sign(builder_signing_root(bid, self.spec))
        return self.t.SignedBuilderBid(message=bid, signature=sig.to_bytes())

    def submit_blinded_block(self, signed_blinded):
        """POST /eth/v1/builder/blinded_blocks -> the full payload."""
        if self.refuse_reveal:
            raise BuilderError("builder refused to reveal the payload")
        root = signed_blinded.message.body.execution_payload_header.tree_hash_root()
        payload = self._payloads.get(root)
        if payload is None:
            raise BuilderError("unknown header: builder never bid this block")
        return payload

    # payload attributes derived from the watched chain's state, exactly
    # as process_execution_payload will check them
    def _timestamp_for(self, slot: int) -> int:
        if self.chain is not None:
            state = self.chain.head_state
            return int(state.genesis_time) + slot * self.spec.seconds_per_slot
        return slot * self.spec.seconds_per_slot

    def _randao_for(self, slot: int) -> bytes:
        if self.chain is not None:
            from ..types import compute_epoch_at_slot
            from ..types.helpers import get_randao_mix

            state = self.chain.state_for_block_production(slot)
            return bytes(
                get_randao_mix(
                    state, compute_epoch_at_slot(slot, self.preset), self.preset
                )
            )
        return slot.to_bytes(32, "little")


class BuilderHttpServer:
    """The mock builder behind the builder-specs REST paths with SSZ
    bodies, over a real socket."""

    def __init__(self, builder: MockBuilder, host="127.0.0.1", port=0):
        self.builder = builder
        self.fail_next = 0
        outer = self
        t = builder.t

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes = b""):
                self.send_response(code)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_GET(self):
                if outer.fail_next > 0:
                    outer.fail_next -= 1
                    self.send_error(503)
                    return
                parts = self.path.strip("/").split("/")
                # eth/v1/builder/header/{slot}/{parent_hash}/{pubkey}
                if len(parts) == 7 and parts[:4] == ["eth", "v1", "builder", "header"]:
                    try:
                        slot = int(parts[4])
                        parent = bytes.fromhex(parts[5].removeprefix("0x"))
                        pubkey = bytes.fromhex(parts[6].removeprefix("0x"))
                        bid = outer.builder.get_header(slot, parent, pubkey)
                    except NoBidAvailable:
                        self._reply(204)
                        return
                    except Exception:  # noqa: BLE001
                        self.send_error(400)
                        return
                    self._reply(200, bid.as_ssz_bytes())
                    return
                self.send_error(404)

            def do_POST(self):
                if outer.fail_next > 0:
                    outer.fail_next -= 1
                    self.send_error(503)
                    return
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                path = self.path.rstrip("/")
                try:
                    if path.endswith("/eth/v1/builder/validators"):
                        if len(body) % REGISTRATION_SSZ_LEN:
                            self.send_error(400)
                            return
                        regs = [
                            SignedValidatorRegistration.from_ssz_bytes(
                                body[i : i + REGISTRATION_SSZ_LEN]
                            )
                            for i in range(0, len(body), REGISTRATION_SSZ_LEN)
                        ]
                        outer.builder.register_validators(regs)
                        self._reply(200)
                        return
                    if path.endswith("/eth/v1/builder/blinded_blocks"):
                        signed = t.SignedBlindedBeaconBlock.from_ssz_bytes(body)
                        payload = outer.builder.submit_blinded_block(signed)
                        self._reply(200, payload.as_ssz_bytes())
                        return
                except BuilderError:
                    self.send_error(502)
                    return
                except Exception:  # noqa: BLE001
                    self.send_error(400)
                    return
                self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.url = f"http://{host}:{self._server.server_address[1]}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class BuilderHttpClient:
    """The BN's builder handle (builder_client/src/lib.rs): REST verbs
    with SSZ bodies, bounded timeout, 204 -> NoBidAvailable."""

    def __init__(
        self,
        url: str,
        preset,
        timeout_s: float = 5.0,
        trusted_pubkey: bytes | None = None,
    ):
        self.url = url.rstrip("/")
        self.preset = preset
        self.t = types_for(preset)
        self.timeout_s = timeout_s
        # the configured builder's BLS identity (verify_bid pins bids to it)
        self.trusted_pubkey = (
            bytes(trusted_pubkey) if trusted_pubkey is not None else None
        )

    def _request(self, method: str, path: str, body: bytes | None = None):
        req = urllib.request.Request(
            self.url + path,
            data=body,
            method=method,
            headers={"Content-Type": "application/octet-stream"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            raise BuilderError(f"builder {path}: HTTP {e.code}") from None
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise BuilderError(f"builder {path}: {e}") from None

    def register_validators(self, registrations) -> None:
        body = b"".join(r.as_ssz_bytes() for r in registrations)
        self._request("POST", "/eth/v1/builder/validators", body)

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes):
        status, body = self._request(
            "GET",
            f"/eth/v1/builder/header/{slot}/0x{bytes(parent_hash).hex()}"
            f"/0x{bytes(pubkey).hex()}",
        )
        if status == 204:
            raise NoBidAvailable("no bid for this slot")
        return self.t.SignedBuilderBid.from_ssz_bytes(body)

    def submit_blinded_block(self, signed_blinded):
        _, body = self._request(
            "POST",
            "/eth/v1/builder/blinded_blocks",
            signed_blinded.as_ssz_bytes(),
        )
        return self.t.ExecutionPayload.from_ssz_bytes(body)


def verify_bid(
    signed_bid,
    spec,
    expected_parent_hash: bytes,
    trusted_pubkey: bytes | None = None,
) -> None:
    """The BN-side bid checks (execution_layer/src/lib.rs builder path):
    the bid's header must build on the right parent and the signature must
    verify. `trusted_pubkey` pins the CONFIGURED builder identity -- a bid
    self-signed under an attacker's fresh key must not pass, or a relay
    can burn the proposer's slot with a header nobody will reveal."""
    from ..crypto.bls.api import PublicKey, Signature, verify_signature_sets
    from ..crypto.bls.api import SignatureSet

    bid = signed_bid.message
    if bytes(bid.header.parent_hash) != bytes(expected_parent_hash):
        raise BuilderError("bid builds on the wrong parent")
    if trusted_pubkey is not None and bytes(bid.pubkey) != bytes(trusted_pubkey):
        raise BuilderError("bid signed by an unexpected builder key")
    root = builder_signing_root(bid, spec)
    pk = PublicKey.from_bytes(bytes(bid.pubkey))
    sig = Signature.from_bytes(bytes(signed_bid.signature))
    if not verify_signature_sets([SignatureSet.single_pubkey(sig, pk, root)]):
        raise BuilderError("bad builder bid signature")


def make_validator_registration(
    secret_key, fee_recipient: bytes, gas_limit: int, timestamp: int, spec
):
    """Build + sign a registration (the VC preparation-service flow,
    validator_client/src/preparation_service.rs)."""
    msg = ValidatorRegistrationV1(
        fee_recipient=bytes(fee_recipient),
        gas_limit=gas_limit,
        timestamp=timestamp,
        pubkey=secret_key.public_key().to_bytes(),
    )
    sig = secret_key.sign(builder_signing_root(msg, spec))
    return SignedValidatorRegistration(message=msg, signature=sig.to_bytes())

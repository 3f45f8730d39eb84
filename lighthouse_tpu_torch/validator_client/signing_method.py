"""Remote signing (reference validator_client/src/signing_method.rs:
SigningMethod::Web3Signer). The VC computes the signing root locally
(exactly as the local-keystore path does) and posts it to a Web3Signer
endpoint — `POST /api/v1/eth2/sign/{pubkey}` with a JSON body carrying
the signing root; the signer returns the BLS signature.

`Web3SignerServer` is the in-process stand-in for the real signer jar
the reference drives in testing/web3signer_tests: a real HTTP server
holding secret keys, honoring the same route and payload shape, with
failure injection for the fallback paths.

The port's copy of lighthouse_tpu/validator_client/signing_method.py.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..crypto.bls.api import SecretKey, Signature


class Web3SignerError(RuntimeError):
    pass


class Web3SignerMethod:
    """SigningMethod::Web3Signer — duck-types LocalKeystore: `.pubkey`
    + `.sign(root)`. No secret material ever lives in the VC process."""

    def __init__(self, url: str, pubkey, timeout_s: float = 5.0):
        self.url = url.rstrip("/")
        self.pubkey = pubkey
        self.timeout_s = timeout_s

    def sign(self, signing_root: bytes) -> Signature:
        body = json.dumps(
            {
                "type": "BLOCK_V2",  # root-only mode: type is advisory
                "signingRoot": "0x" + bytes(signing_root).hex(),
            }
        ).encode()
        req = urllib.request.Request(
            f"{self.url}/api/v1/eth2/sign/0x{self.pubkey.to_bytes().hex()}",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                payload = json.loads(resp.read())
            sig_hex = payload.get("signature", "")
            if not sig_hex.startswith("0x"):
                raise Web3SignerError("web3signer returned no signature")
            return Signature.from_bytes(bytes.fromhex(sig_hex[2:]))
        except Web3SignerError:
            raise
        except (
            urllib.error.URLError,
            ConnectionError,
            OSError,
            ValueError,  # malformed JSON body or non-hex signature
        ) as e:
            raise Web3SignerError(f"web3signer failure: {e}") from None


class Web3SignerServer:
    """In-process web3signer: holds keys, signs roots over real HTTP."""

    def __init__(self, secret_keys, host: str = "127.0.0.1", port: int = 0):
        self._keys: dict[bytes, SecretKey] = {
            sk.public_key().to_bytes(): sk for sk in secret_keys
        }
        self.fail_next = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                if outer.fail_next > 0:
                    outer.fail_next -= 1
                    self.send_error(500)
                    return
                prefix = "/api/v1/eth2/sign/"
                if not self.path.startswith(prefix):
                    self.send_error(404)
                    return
                pk_hex = self.path[len(prefix) :]
                pk = bytes.fromhex(pk_hex[2:] if pk_hex.startswith("0x") else pk_hex)
                sk = outer._keys.get(pk)
                if sk is None:
                    self.send_error(404, "unknown key")
                    return
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length))
                root = bytes.fromhex(body["signingRoot"][2:])
                sig = sk.sign(root)
                data = json.dumps(
                    {"signature": "0x" + sig.to_bytes().hex()}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                # /api/v1/eth2/publicKeys — key listing for health checks
                if self.path == "/api/v1/eth2/publicKeys":
                    data = json.dumps(
                        ["0x" + pk.hex() for pk in outer._keys]
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
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

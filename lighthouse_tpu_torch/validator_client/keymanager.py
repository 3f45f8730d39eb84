"""Keymanager HTTP API (reference validator_client/src/http_api/: the
standard keymanager routes /eth/v1/keystores with bearer-token auth —
list / import / delete local keystores, with slashing-protection data
riding along on import/export per the keymanager spec).

The port's copy of lighthouse_tpu/validator_client/keymanager.py.
"""

from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..crypto.keystore import Keystore, KeystoreError
from .validator_store import LocalKeystore, ValidatorStore


class KeymanagerApi:
    """Route logic, HTTP-agnostic (tested directly and served below)."""

    def __init__(self, store: ValidatorStore, genesis_validators_root: bytes):
        self.store = store
        self.genesis_validators_root = genesis_validators_root
        self.api_token = "api-token-" + secrets.token_hex(16)

    # GET /eth/v1/keystores — LOCAL keystores only; remote (web3signer)
    # keys are managed exclusively via /eth/v1/remotekeys per the spec
    def list_keystores(self) -> dict:
        return {
            "data": [
                {
                    "validating_pubkey": "0x" + pk.hex(),
                    "derivation_path": "",
                    "readonly": False,
                }
                for pk in self.store.voting_pubkeys()
                if isinstance(self.store.signing_method(pk), LocalKeystore)
            ]
        }

    # POST /eth/v1/keystores
    def import_keystores(self, body: dict) -> dict:
        keystores = body.get("keystores", [])
        passwords = body.get("passwords", [])
        if len(keystores) != len(passwords):
            raise ValueError("keystores/passwords length mismatch")
        if body.get("slashing_protection"):
            self.store.slashing_db.import_json(
                body["slashing_protection"], self.genesis_validators_root
            )
        statuses = []
        for ks_json, password in zip(keystores, passwords):
            try:
                ks = (
                    Keystore.from_json(ks_json)
                    if isinstance(ks_json, str)
                    else Keystore(ks_json)
                )
                pk = bytes.fromhex(ks.pubkey)
                if self.store.has_validator(pk):
                    statuses.append({"status": "duplicate"})
                    continue
                sk = ks.decrypt(password)
                self.store.add_validator(LocalKeystore(sk))
                statuses.append({"status": "imported"})
            except (KeystoreError, ValueError) as e:
                statuses.append({"status": "error", "message": str(e)})
        return {"data": statuses}

    # DELETE /eth/v1/keystores — refuses remote keys (spec: those are
    # /eth/v1/remotekeys territory)
    def delete_keystores(self, body: dict) -> dict:
        statuses = []
        for pk_hex in body.get("pubkeys", []):
            pk = bytes.fromhex(
                pk_hex[2:] if pk_hex.startswith("0x") else pk_hex
            )
            method = self.store.signing_method(pk)
            if method is None:
                statuses.append({"status": "not_found"})
            elif not isinstance(method, LocalKeystore):
                statuses.append(
                    {"status": "error", "message": "key is remote (web3signer)"}
                )
            else:
                self.store.remove_validator(pk)
                statuses.append({"status": "deleted"})
        # per the keymanager spec, deletion returns the slashing data so
        # the keys can be safely re-imported elsewhere
        return {
            "data": statuses,
            "slashing_protection": self.store.slashing_db.export_json(
                self.genesis_validators_root
            ),
        }

    # GET /eth/v1/remotekeys — web3signer-backed keys
    def list_remotekeys(self) -> dict:
        from .signing_method import Web3SignerMethod

        return {
            "data": [
                {
                    "pubkey": "0x" + pk.hex(),
                    "url": self.store.signing_method(pk).url,
                    "readonly": False,
                }
                for pk in self.store.voting_pubkeys()
                if isinstance(self.store.signing_method(pk), Web3SignerMethod)
            ]
        }


class KeymanagerServer:
    def __init__(self, api: KeymanagerApi, host: str = "127.0.0.1", port: int = 0):
        self.api = api
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _authed(self) -> bool:
                auth = self.headers.get("Authorization", "")
                return secrets.compare_digest(
                    auth, f"Bearer {outer.api.api_token}"
                )

            def _send(self, status: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", "0"))
                return json.loads(self.rfile.read(length)) if length else {}

            def _route(self, method: str):
                if not self._authed():
                    self._send(401, {"message": "invalid bearer token"})
                    return
                try:
                    if self.path == "/eth/v1/keystores":
                        if method == "GET":
                            self._send(200, outer.api.list_keystores())
                        elif method == "POST":
                            self._send(
                                200, outer.api.import_keystores(self._body())
                            )
                        else:
                            self._send(
                                200, outer.api.delete_keystores(self._body())
                            )
                    elif self.path == "/eth/v1/remotekeys" and method == "GET":
                        self._send(200, outer.api.list_remotekeys())
                    else:
                        self._send(404, {"message": "unknown route"})
                except ValueError as e:
                    self._send(400, {"message": str(e)})

            def do_GET(self):
                self._route("GET")

            def do_POST(self):
                self._route("POST")

            def do_DELETE(self):
                self._route("DELETE")

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

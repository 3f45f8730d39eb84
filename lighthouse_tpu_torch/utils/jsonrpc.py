"""Shared JSON-RPC 2.0 HTTP plumbing used by both external-chain
boundaries — the eth1 deposit provider (reference eth1/src/http.rs) and
the engine API (execution_layer/src/engine_api/http.rs): a client with
bounded exponential-backoff retries that fails FAST on HTTP 4xx (auth or
protocol misconfiguration is not a transient transport fault), and a
threaded in-process server scaffold with fault injection for rig tests.

The port's copy of lighthouse_tpu/utils/jsonrpc.py.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class JsonRpcClient:
    """POSTs JSON-RPC calls to `url`. `headers_fn` is invoked per attempt
    (JWT tokens are short-lived); `error_cls` shapes raised errors so each
    boundary surfaces its own exception type."""

    def __init__(
        self,
        url: str,
        error_cls=RuntimeError,
        headers_fn=None,
        retries: int = 3,
        backoff_s: float = 0.05,
        timeout_s: float = 5.0,
    ):
        self.url = url
        self.error_cls = error_cls
        self.headers_fn = headers_fn
        self.retries = retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        payload = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        last = None
        for attempt in range(self.retries):
            headers = {"Content-Type": "application/json"}
            if self.headers_fn is not None:
                headers.update(self.headers_fn())
            try:
                req = urllib.request.Request(
                    self.url, data=payload, headers=headers
                )
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    body = json.loads(resp.read())
                if body.get("error") is not None:
                    raise self.error_cls(str(body["error"]))
                return body["result"]
            except urllib.error.HTTPError as e:
                if 400 <= e.code < 500:
                    # 4xx is deterministic (bad auth/request): retrying
                    # cannot help and masks misconfiguration as an outage
                    raise self.error_cls(
                        f"{method} rejected: HTTP {e.code} {e.reason}"
                    ) from None
                last = e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last = e
            if attempt < self.retries - 1:
                time.sleep(self.backoff_s * (2**attempt))
        raise self.error_cls(f"{method} failed after retries: {last}")


class JsonRpcHttpServer:
    """Threaded JSON-RPC server over a scriptable `dispatch(method, params)`
    callable. `fail_next` injects transient 503s; `auth_fn`, when set,
    vets each request's Authorization header and 401s on rejection."""

    def __init__(self, dispatch, host: str = "127.0.0.1", port: int = 0,
                 auth_fn=None):
        self.dispatch = dispatch
        self.auth_fn = auth_fn
        self.fail_next = 0
        self.requests_seen = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                outer.requests_seen += 1
                if outer.fail_next > 0:
                    outer.fail_next -= 1
                    self.send_error(503)
                    return
                if outer.auth_fn is not None and not outer.auth_fn(
                    self.headers.get("Authorization", "")
                ):
                    self.send_error(401)
                    return
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                try:
                    result = outer.dispatch(req["method"], req.get("params", []))
                    body = {"jsonrpc": "2.0", "id": req.get("id"), "result": result}
                except Exception as e:  # noqa: BLE001
                    body = {
                        "jsonrpc": "2.0",
                        "id": req.get("id"),
                        "error": {"code": -32000, "message": str(e)},
                    }
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

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

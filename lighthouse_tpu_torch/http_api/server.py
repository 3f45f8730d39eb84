"""HTTP adapter for BeaconApi (reference http_api's warp server +
http_metrics): stdlib ThreadingHTTPServer on an ephemeral port, JSON
bodies, /eth/v1|v2 routing, Prometheus-style /metrics text, and an SSE
/eth/v1/events stream fed by the chain's event sinks.

Requests flow through the serving tier (serving/): admission control
first (overloaded nodes shed read-only/debug lanes with 503 +
Retry-After, never validator duties), then the anchored response cache
for GETs (finalized/head-keyed entries, ETag + If-None-Match -> 304),
and ``/eth/v1/events?topics=...`` streams live chunked SSE from the
bounded broadcaster instead of replaying the journal.

The port's copy of lighthouse_tpu/http_api/server.py.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..serving import (
    ResponseCache,
    ServingTier,
    classify_anchor,
    classify_lane,
    make_etag,
)
from .api import ApiError, BeaconApi


def _liveness_body(body) -> tuple:
    """Validate the /lighthouse/liveness POST body: indices must be a
    list, epoch a required integer — malformed requests are 400s."""
    body = body or {}
    indices = body.get("indices")
    if not isinstance(indices, list):
        raise ApiError(400, "indices must be a list")
    epoch = body.get("epoch")
    try:
        epoch = int(epoch)
    except (TypeError, ValueError):
        raise ApiError(400, f"bad epoch {epoch!r}") from None
    return indices, epoch


class BeaconApiServer:
    def __init__(
        self,
        api: BeaconApi,
        host: str = "127.0.0.1",
        port: int = 0,
        serving: ServingTier | None = None,
        serving_config=None,
        processor=None,
    ):
        self.api = api
        self.serving = (
            serving
            if serving is not None
            else ServingTier(
                chain=api.chain, config=serving_config, processor=processor
            )
        )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # persistent connections: HTTP/1.0 never keeps alive, and the
            # per-request body-cache reset below depends on reuse being real
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _send(
                self,
                status: int,
                payload,
                content_type="application/json",
                headers: dict | None = None,
            ):
                body = (
                    json.dumps(payload).encode()
                    if not isinstance(payload, (bytes, str))
                    else (
                        payload.encode()
                        if isinstance(payload, str)
                        else payload
                    )
                )
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                length = int(self.headers.get("Content-Length", "0"))
                if not length:
                    return None
                return json.loads(self.rfile.read(length))

            def do_GET(self):
                try:
                    self._route("GET")
                except ApiError as e:
                    self._send(e.status, {"message": str(e)})
                except Exception as e:  # noqa: BLE001
                    # an unread request body would corrupt the next
                    # request on a persistent connection
                    self.close_connection = True
                    self._send(500, {"message": str(e)})

            def do_POST(self):
                try:
                    self._route("POST")
                except ApiError as e:
                    self.close_connection = True
                    self._send(e.status, {"message": str(e)})
                except Exception as e:  # noqa: BLE001
                    self.close_connection = True
                    self._send(500, {"message": str(e)})

            def _route(self, method: str):
                api = outer.api
                # the body memo is PER REQUEST: a persistent connection
                # reuses this handler instance across requests, so a
                # stale memo would replay request N's body into N+1
                self._cached = None
                path, _, query = self.path.partition("?")
                params = dict(
                    urllib.parse.parse_qsl(query, keep_blank_values=True)
                )
                lane = classify_lane(method, path)
                admitted, retry_after = outer.serving.admission.admit(lane)
                if not admitted:
                    self._send(
                        503,
                        {"message": f"node overloaded, {lane} lane shed"},
                        headers={"Retry-After": str(retry_after)},
                    )
                    return

                def q(name: str) -> str:
                    # a missing required query param is the CLIENT's error
                    if name not in params:
                        raise ApiError(400, f"missing query param {name}")
                    return params[name]

                routes_get = [
                    (r"^/eth/v1/beacon/genesis$", lambda m: api.get_genesis()),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/root$",
                        lambda m: api.get_state_root(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/finality_checkpoints$",
                        lambda m: api.get_finality_checkpoints(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/fork$",
                        lambda m: api.get_fork(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/validators$",
                        lambda m: api.get_validators(m.group(1)),
                    ),
                    (
                        r"^/eth/v2/beacon/blocks/([^/]+)$",
                        lambda m: api.get_block(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/headers/([^/]+)$",
                        lambda m: api.get_block_header(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/validator/duties/proposer/(\d+)$",
                        lambda m: api.get_proposer_duties(int(m.group(1))),
                    ),
                    (
                        r"^/eth/v2/validator/blocks/(\d+)$",
                        lambda m: api.produce_block(
                            int(m.group(1)),
                            params["randao_reveal"],
                            graffiti=params.get("graffiti"),
                        ),
                    ),
                    (
                        r"^/eth/v1/validator/attestation_data$",
                        lambda m: api.attestation_data(
                            int(params["slot"]), int(params["committee_index"])
                        ),
                    ),
                    (
                        r"^/eth/v1/validator/aggregate_attestation$",
                        lambda m: api.aggregate_attestation(
                            params["attestation_data"]
                        ),
                    ),
                    (r"^/eth/v1/node/version$", lambda m: api.get_version()),
                    (r"^/eth/v1/node/syncing$", lambda m: api.get_syncing()),
                    (r"^/eth/v1/node/identity$", lambda m: api.get_identity()),
                    (r"^/eth/v1/node/peers$", lambda m: api.get_peers()),
                    (
                        r"^/eth/v1/node/peer_count$",
                        lambda m: api.get_peer_count(),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/randao$",
                        lambda m: api.get_state_randao(
                            m.group(1),
                            int(params["epoch"]) if "epoch" in params else None,
                        ),
                    ),
                    (
                        r"^/eth/v1/beacon/headers$",
                        lambda m: api.get_headers(
                            int(params["slot"]) if "slot" in params else None
                        ),
                    ),
                    (
                        r"^/eth/v1/node/peers/([^/]+)$",
                        lambda m: api.get_peer(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/validators/([^/]+)$",
                        lambda m: api.get_validator(m.group(1), m.group(2)),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/validator_balances$",
                        lambda m: api.get_validator_balances(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/committees$",
                        lambda m: api.get_committees(
                            m.group(1),
                            int(params["epoch"]) if "epoch" in params else None,
                        ),
                    ),
                    (
                        r"^/eth/v1/beacon/states/([^/]+)/sync_committees$",
                        lambda m: api.get_sync_committees(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/blocks/([^/]+)/root$",
                        lambda m: api.get_block_root(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/blocks/([^/]+)/attestations$",
                        lambda m: api.get_block_attestations(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/pool/voluntary_exits$",
                        lambda m: api.get_pool_voluntary_exits(),
                    ),
                    (
                        r"^/eth/v1/beacon/pool/proposer_slashings$",
                        lambda m: api.get_pool_proposer_slashings(),
                    ),
                    (
                        r"^/eth/v1/beacon/pool/attester_slashings$",
                        lambda m: api.get_pool_attester_slashings(),
                    ),
                    (
                        r"^/eth/v1/validator/sync_committee_contribution$",
                        lambda m: api.sync_committee_contribution(
                            int(params["slot"]),
                            int(params["subcommittee_index"]),
                            params["beacon_block_root"],
                        ),
                    ),
                    (
                        r"^/eth/v1/validator/blinded_blocks/(\d+)$",
                        lambda m: api.produce_blinded_block(
                            int(m.group(1)), params["randao_reveal"]
                        ),
                    ),
                    (
                        r"^/eth/v1/beacon/light_client/bootstrap/([^/]+)$",
                        lambda m: api.get_light_client_bootstrap(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/beacon/light_client/finality_update$",
                        lambda m: api.get_light_client_finality_update(),
                    ),
                    (
                        r"^/eth/v1/beacon/light_client/optimistic_update$",
                        lambda m: api.get_light_client_optimistic_update(),
                    ),
                    (r"^/eth/v1/config/spec$", lambda m: api.get_spec()),
                    (
                        r"^/eth/v1/config/fork_schedule$",
                        lambda m: api.get_fork_schedule(),
                    ),
                    (
                        r"^/eth/v1/config/deposit_contract$",
                        lambda m: api.get_deposit_contract(),
                    ),
                    (
                        r"^/eth/v2/debug/beacon/states/([^/]+)$",
                        lambda m: api.get_debug_state(m.group(1)),
                    ),
                    (
                        r"^/eth/v1/debug/beacon/heads$",
                        lambda m: api.get_debug_heads(),
                    ),
                    (
                        r"^/lighthouse/validator_inclusion/(\d+)/global$",
                        lambda m: api.lighthouse_validator_inclusion(
                            int(m.group(1))
                        ),
                    ),
                    (
                        r"^/lighthouse/validator_inclusion/(\d+)/([^/]+)$",
                        lambda m: api.lighthouse_validator_inclusion_validator(
                            int(m.group(1)), m.group(2)
                        ),
                    ),
                    (
                        r"^/lighthouse/analysis/attestation_performance/(\d+)$",
                        lambda m: api.lighthouse_attestation_performance(
                            int(m.group(1)),
                            int(q("start_epoch")),
                            int(q("end_epoch")),
                        ),
                    ),
                    (
                        r"^/lighthouse/database/info$",
                        lambda m: api.lighthouse_database_info(),
                    ),
                    (
                        r"^/lighthouse/health$",
                        lambda m: api.lighthouse_health(),
                    ),
                    (
                        r"^/lighthouse/syncing$",
                        lambda m: api.lighthouse_syncing(),
                    ),
                    (
                        r"^/lighthouse/staking$",
                        lambda m: api.lighthouse_staking(),
                    ),
                    (
                        r"^/lighthouse/eth1/syncing$",
                        lambda m: api.lighthouse_eth1_syncing(),
                    ),
                    (
                        r"^/lighthouse/eth1/block_cache$",
                        lambda m: api.lighthouse_eth1_block_cache(),
                    ),
                    (
                        r"^/lighthouse/eth1/deposit_cache$",
                        lambda m: api.lighthouse_eth1_deposit_cache(),
                    ),
                    (
                        r"^/lighthouse/merge_readiness$",
                        lambda m: api.lighthouse_merge_readiness(),
                    ),
                    (
                        r"^/lighthouse/proto_array$",
                        lambda m: api.lighthouse_proto_array(),
                    ),
                    (
                        r"^/lighthouse/ui/validator_count$",
                        lambda m: api.lighthouse_validator_count(),
                    ),
                    (
                        r"^/lighthouse/analysis/block_packing$",
                        lambda m: api.lighthouse_block_packing(
                            int(q("start_slot")), int(q("end_slot"))
                        ),
                    ),
                    (
                        r"^/lighthouse/analysis/block_rewards$",
                        lambda m: api.lighthouse_block_rewards(
                            int(q("start_slot")), int(q("end_slot"))
                        ),
                    ),
                ]
                routes_post = [
                    (
                        r"^/eth/v1/beacon/blocks$",
                        lambda m: api.post_block(
                            self._body()["ssz"], self._body_fork()
                        ),
                    ),
                    (
                        r"^/lighthouse/ui/validator_metrics$",
                        lambda m: api.lighthouse_validator_metrics(
                            (self._body() or {}).get("indices", [])
                        ),
                    ),
                    (
                        r"^/lighthouse/database/reconstruct$",
                        lambda m: api.lighthouse_database_reconstruct(),
                    ),
                    (
                        r"^/lighthouse/liveness$",
                        lambda m: api.lighthouse_liveness(
                            *_liveness_body(self._body())
                        ),
                    ),
                    (
                        r"^/eth/v1/beacon/pool/attestations$",
                        lambda m: api.post_pool_attestations(self._body()),
                    ),
                    (
                        r"^/eth/v1/validator/duties/attester/(\d+)$",
                        lambda m: api.post_attester_duties(
                            int(m.group(1)), [int(i) for i in self._body()]
                        ),
                    ),
                    (
                        r"^/eth/v1/validator/aggregate_and_proofs$",
                        lambda m: api.post_aggregate_and_proofs(self._body()),
                    ),
                    (
                        r"^/eth/v1/validator/prepare_beacon_proposer$",
                        lambda m: api.prepare_beacon_proposer(self._body()),
                    ),
                    (
                        r"^/eth/v1/validator/beacon_committee_subscriptions$",
                        lambda m: api.subscribe_beacon_committee(self._body()),
                    ),
                    (
                        r"^/eth/v1/validator/sync_committee_subscriptions$",
                        lambda m: api.subscribe_sync_committee(self._body()),
                    ),
                    (
                        r"^/eth/v1/beacon/pool/voluntary_exits$",
                        lambda m: api.post_pool_voluntary_exits(
                            self._body()["ssz"]
                        ),
                    ),
                    (
                        r"^/eth/v1/beacon/pool/sync_committees$",
                        lambda m: api.post_pool_sync_committees(self._body()),
                    ),
                    (
                        r"^/eth/v1/validator/duties/sync/(\d+)$",
                        lambda m: api.post_sync_duties(
                            int(m.group(1)), [int(i) for i in self._body()]
                        ),
                    ),
                    (
                        r"^/eth/v1/validator/contribution_and_proofs$",
                        lambda m: api.post_contribution_and_proofs(
                            self._body()
                        ),
                    ),
                    (
                        r"^/eth/v1/validator/register_validator$",
                        lambda m: api.register_validator(self._body()),
                    ),
                    (
                        r"^/eth/v1/beacon/blinded_blocks$",
                        lambda m: api.post_blinded_block(self._body()["ssz"]),
                    ),
                ]

                if method == "GET" and path == "/eth/v1/node/health":
                    self._send(api.get_health(), {})
                    return
                if method == "GET" and path == "/metrics":
                    self._send(200, outer.metrics_text(), "text/plain")
                    return
                if method == "GET" and path == "/lighthouse/tracing/status":
                    from ..utils.tracing import default_tracer

                    self._send(200, {"data": default_tracer().status()})
                    return
                if method == "GET" and path == "/lighthouse/tracing/dump":
                    # Chrome trace-event JSON: load in Perfetto or
                    # chrome://tracing (the whole bounded ring)
                    from ..utils.tracing import default_tracer

                    self._send(
                        200,
                        default_tracer().dump_json(),
                        "application/json",
                    )
                    return
                if method == "GET" and path == "/lighthouse/ledger/status":
                    from ..obs.ledger import default_ledger

                    self._send(200, {"data": default_ledger().status()})
                    return
                if method == "GET" and path == "/lighthouse/ledger/dump":
                    # the launch-ledger ring as sorted JSON (the same
                    # byte-comparable document the replay contract uses)
                    from ..obs.ledger import default_ledger

                    self._send(
                        200,
                        default_ledger().dump_json(),
                        "application/json",
                    )
                    return
                if method == "GET" and path == "/lighthouse/ledger/report":
                    # the occupancy / pad-waste / compile-tax table
                    from ..obs.ledger import default_ledger

                    self._send(
                        200,
                        default_ledger().report_text() + "\n",
                        "text/plain",
                    )
                    return
                if method == "GET" and path == "/eth/v1/events":
                    if "topics" in params:
                        # live chunked stream from the broadcaster
                        self._stream_events(params)
                        return
                    # bare form: replay-and-close over the bounded ring
                    # (the debug/journal view; back-compat behaviour)
                    self._send(
                        200,
                        "".join(
                            f"event: {k}\ndata: {json.dumps(p)}\n\n"
                            for k, p in api.events
                        ),
                        "text/event-stream",
                    )
                    return

                table = routes_get if method == "GET" else routes_post
                for pattern, handler in table:
                    m = re.match(pattern, path)
                    if m:
                        if method == "GET":
                            self._respond_get(path, params, handler, m)
                        else:
                            self._send(200, handler(m))
                        return
                self._send(404, {"message": f"no route {method} {path}"})

            def _respond_get(self, path, params, handler, m):
                """GET responses route through the anchored cache via
                singleflight: a hit skips the BeaconApi handler entirely;
                concurrent misses on one key run the handler ONCE (the
                followers are coalesced onto the leader's result); every
                path honours If-None-Match with a bodyless 304."""
                tier = outer.serving
                key = None
                if tier.config.cache_enabled:
                    kind = classify_anchor("GET", path)
                    if kind is not None:
                        anchor = tier.anchor_for(kind)
                        if anchor is not None:
                            key = ResponseCache.key(
                                path, params, kind, anchor
                            )
                if key is None:
                    self._send(200, handler(m))
                    return

                def build():
                    body = json.dumps(handler(m)).encode()
                    return body, "application/json", make_etag(body)

                entry, outcome = tier.cache.get_or_compute(key, build)
                inm = self.headers.get("If-None-Match")
                if inm is not None and inm == entry.etag:
                    self._send_not_modified(entry.etag)
                    return
                self._send(
                    200,
                    entry.body,
                    entry.content_type,
                    headers={"ETag": entry.etag, "X-Cache": outcome},
                )

            def _send_not_modified(self, etag: str):
                from ..utils import metrics as M

                M.SERVING_NOT_MODIFIED.inc()
                self.send_response(304)
                self.send_header("ETag", etag)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _stream_events(self, params):
                """Live SSE: a bounded per-subscriber ring drained onto a
                chunkless streaming response (Connection: close frames
                the body by EOF). `limit=N` closes after N events — the
                deterministic-test and curl-friendly escape hatch."""
                topics = [
                    t for t in params.get("topics", "").split(",") if t
                ]
                limit = (
                    int(params["limit"]) if "limit" in params else None
                )
                sub = outer.serving.broadcaster.subscribe(topics or None)
                if sub is None:
                    raise ApiError(503, "SSE subscriber limit reached")
                self.close_connection = True
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                sent = 0
                idle_polls = 0
                try:
                    while True:
                        ev = sub.pop(0.25)
                        if ev is None:
                            if sub.closed:
                                break
                            idle_polls += 1
                            if idle_polls >= 40:
                                # ~10s keepalive comment doubles as the
                                # dead-socket probe freeing the slot
                                self.wfile.write(b":keep-alive\n\n")
                                self.wfile.flush()
                                idle_polls = 0
                            continue
                        idle_polls = 0
                        kind, payload = ev
                        frame = (
                            f"event: {kind}\n"
                            f"data: {json.dumps(payload)}\n\n"
                        )
                        self.wfile.write(frame.encode())
                        self.wfile.flush()
                        sent += 1
                        if limit is not None and sent >= limit:
                            break
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client went away; slot freed below
                finally:
                    outer.serving.broadcaster.unsubscribe(sub)

            def _body_fork(self):
                body = self._body()
                return body.get("version", "phase0") if body else "phase0"

        # cache request body between the two lambda reads in post_block
        # (_route resets the memo per request so persistent connections
        # never replay a previous request's body)
        orig_body = Handler._body

        def _body_cached(handler_self):
            if getattr(handler_self, "_cached", None) is None:
                handler_self._cached = orig_body(handler_self)
            return handler_self._cached

        Handler._body = _body_cached

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread: threading.Thread | None = None

    def metrics_text(self) -> str:
        """Prometheus exposition (reference http_metrics/src/lib.rs:147
        gathering the lighthouse_metrics global registry)."""
        from ..utils.metrics import REGISTRY

        chain = self.api.chain
        lines = [
            "# TYPE beacon_head_slot gauge",
            f"beacon_head_slot {chain.head_state.slot}",
            "# TYPE beacon_finalized_epoch gauge",
            f"beacon_finalized_epoch {chain.finalized_checkpoint[0]}",
            "# TYPE beacon_validator_count gauge",
            f"beacon_validator_count {len(chain.head_state.validators)}",
        ]
        return REGISTRY.expose() + "\n".join(lines) + "\n"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        # wake every live SSE subscriber first so their handler threads
        # exit their streams instead of blocking on the next pop
        self.serving.close()
        self.server.shutdown()
        if self._thread:
            self._thread.join()

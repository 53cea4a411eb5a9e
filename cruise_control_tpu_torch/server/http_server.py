"""REST API server (upstream ``KafkaCruiseControlServlet`` +
``CruiseControlEndPoint`` + request/parameter classes; SURVEY.md §2.7,
call stack §3.2 head).

Endpoint names, methods, and the async ``202 + User-Task-ID`` protocol match
upstream so ``cccli``-style clients port over directly.  Pure stdlib
(``http.server``) — the build environment has no web framework, and the
throughput needs (operator API) don't justify one.

GET  /kafkacruisecontrol/state | load | partition_load | proposals |
     kafka_cluster_state | user_tasks | review_board
POST /kafkacruisecontrol/rebalance | add_broker | remove_broker |
     demote_broker | fix_offline_replicas | topic_configuration |
     stop_proposal_execution | pause_sampling | resume_sampling |
     admin | review | train | rightsize
"""

from __future__ import annotations

import base64
import json
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:  # import cycle: the facade builds this server
    from cruise_control_tpu_torch.facade import CruiseControl
from urllib.parse import parse_qs, urlparse

import numpy as np

from cruise_control_tpu_torch.analyzer.precompute import AnalyzerSaturatedError
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.monitor.load_monitor import NotEnoughValidWindowsError
from cruise_control_tpu_torch.server import admission as admission_mod
from cruise_control_tpu_torch.server.admission import (
    CLASS_COMPUTE,
    CLASS_GET,
    AdmissionController,
    DeadlineExceededError,
    RequestShedError,
)
from cruise_control_tpu_torch.server.purgatory import Purgatory
from cruise_control_tpu_torch.telemetry import critical_path, events, tracing
from cruise_control_tpu_torch.telemetry import trace as trace_mod
from cruise_control_tpu_torch.utils.logging import get_logger
from cruise_control_tpu_torch.server.security import (  # re-exported (legacy import site)
    BasicSecurityProvider,
    SecurityProvider,
)
from cruise_control_tpu_torch.server.user_tasks import (
    TooManyTasksError,
    UserTaskManager,
)

PREFIX = "/kafkacruisecontrol"
USER_TASK_HEADER = "User-Task-ID"
#: per-request deadline header (milliseconds the client is willing to
#: wait); propagated into the facade as a thread-local deadline scope
DEADLINE_HEADER = "deadline-ms"
#: end-to-end correlation header: client-supplied or minted per request,
#: echoed on the response, stamped on every span and journal event the
#: request produces, and queryable via GET /trace?id=
TRACE_HEADER = "X-Trace-Id"
_TRACE_ID_OK = re.compile(r"[A-Za-z0-9._-]{1,64}$")

#: Retry-After guidance on backpressure responses (RFC 9110 §10.2.3).
#: 429 (task capacity) clears as soon as a worker frees up — retry fast;
#: 503 (monitor not ready) clears when enough metric windows accumulate —
#: that takes sampling intervals, so poll an order of magnitude slower.
RETRY_AFTER_BUSY_S = 2
RETRY_AFTER_NOT_READY_S = 30

GET_ENDPOINTS = {
    "state", "load", "partition_load", "proposals", "kafka_cluster_state",
    "user_tasks", "review_board", "metrics", "diagnostics", "events",
    "health", "slo", "trace", "profile/kernels", "profile/mesh",
    "profile/host",
}
ASYNC_POST_ENDPOINTS = {
    "rebalance", "add_broker", "remove_broker", "demote_broker",
    "fix_offline_replicas", "topic_configuration", "rightsize",
    "whatif",
}
SYNC_POST_ENDPOINTS = {
    "stop_proposal_execution", "pause_sampling", "resume_sampling",
    "admin", "review", "train",
}


class CruiseControlHttpServer:
    """Wires the facade to HTTP.  ``start()`` binds and serves on a daemon
    thread; ``port=0`` picks a free port (tests)."""

    def __init__(
        self,
        cruise_control: "CruiseControl",
        host: str = "127.0.0.1",
        port: int = 9090,
        security_provider: Optional[BasicSecurityProvider] = None,
        two_step_verification: bool = False,
        user_task_manager: Optional[UserTaskManager] = None,
        api_prefix: str = PREFIX,
        cors_enabled: bool = False,
        cors_origin: str = "*",
        access_log: bool = True,
        purgatory_retention_s: float = 86_400.0,
        ui_path: Optional[str] = None,
        flight_recorder=None,
        event_journal=None,
        get_max_concurrent: int = 16,
        compute_max_concurrent: int = 4,
        admission_queue_size: int = 16,
        admission_queue_timeout_s: float = 2.0,
        default_deadline_ms: int = 0,
        max_body_bytes: int = 1 << 20,
        read_timeout_s: float = 10.0,
        drain_timeout_s: float = 5.0,
        max_inflight: int = 0,
        slo_engine=None,
        trace_store=None,
        trace_id_factory=None,
    ):
        self.cc = cruise_control
        self.host = host
        self.port = port
        self.security = security_provider
        self.two_step = two_step_verification
        self.tasks = user_task_manager or UserTaskManager()
        self.prefix = api_prefix.rstrip("/") or PREFIX
        self.cors_enabled = cors_enabled
        self.cors_origin = cors_origin
        self.access_log = access_log
        self.ui_path = ui_path
        #: telemetry/recorder.FlightRecorder serving GET /diagnostics
        self.flight_recorder = flight_recorder
        #: telemetry/events.EventJournal serving GET /events (None falls
        #: back to the process-wide events.JOURNAL at request time)
        self.event_journal = event_journal
        #: telemetry/slo.SloEngine serving GET /slo (None → 503)
        self.slo_engine = slo_engine
        #: telemetry/trace.TraceStore serving GET /trace; also installed
        #: as the tracer's root-span sink so request spans are retained
        self.trace_store = trace_mod.install(trace_store)
        #: trace-id source (the scenario simulator injects a deterministic
        #: counter so journal fingerprints stay reproducible)
        self._trace_id_factory = trace_id_factory or (
            lambda: uuid.uuid4().hex[:16]
        )
        self.purgatory = Purgatory(retention_s=purgatory_retention_s)
        #: the overload-safe front door (ISSUE 8): per-class concurrency
        #: limits + one bounded queue; sheds with Retry-After instead of
        #: stacking threads onto the analyzer
        self.admission = AdmissionController(
            max_concurrent={
                CLASS_GET: get_max_concurrent,
                CLASS_COMPUTE: compute_max_concurrent,
            },
            queue_size=admission_queue_size,
            queue_timeout_s=admission_queue_timeout_s,
            retry_after_s=RETRY_AFTER_BUSY_S,
            on_shed=self._on_shed,
            max_inflight=max_inflight,
        )
        self.default_deadline_ms = max(0, int(default_deadline_ms))
        self.max_body_bytes = max(0, int(max_body_bytes))
        self.read_timeout_s = read_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._log = get_logger("server")
        registry = getattr(self.cc, "registry", None)
        if registry is not None:
            registry.gauge("http.admission.queued",
                           lambda: float(self.admission.queued()))
            registry.gauge("http.admission.inflight",
                           lambda: float(self.admission.inflight()))

    def _on_shed(self, cls: str, reason: str) -> None:
        registry = getattr(self.cc, "registry", None)
        if registry is not None:
            registry.meter("http.admission.shed").mark()
        events.emit("http.request_shed", severity="WARNING",
                    admissionClass=cls, reason=reason)

    # ---- lifecycle --------------------------------------------------------------
    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            # per-connection socket timeout: a slow-loris client trickling
            # headers cannot pin a server thread past this (the stdlib
            # handler closes the connection on socket timeout)
            timeout = server.read_timeout_s

            def log_message(self, *args):  # quiet; metrics cover observability
                pass

            def handle_one_request(self):
                try:
                    super().handle_one_request()
                except TimeoutError:  # header/read timeout → reap quietly
                    self.close_connection = True

            def do_GET(self):
                server._dispatch(self, "GET")

            def do_POST(self):
                server._dispatch(self, "POST")

        class Httpd(ThreadingHTTPServer):
            # handler threads are daemons and server_close must not join
            # them unbounded — the graceful drain below does the bounded
            # join through the admission controller's in-flight count
            daemon_threads = True
            block_on_close = False
            # socketserver's default listen backlog is FIVE: under a
            # client storm, connections then queue invisibly in the
            # kernel instead of reaching admission control, which is the
            # layer that must decide (admit/queue/shed) — accept fast,
            # decide explicitly
            request_queue_size = 512

        self._httpd = Httpd((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="cc-http"
        )
        self._thread.start()

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        """Graceful drain: stop accepting, shed the admission queue with
        Retry-After, join in-flight requests (bounded), then shut the task
        pool down (queued tasks cancelled, workers joined bounded)."""
        timeout = (self.drain_timeout_s if drain_timeout_s is None
                   else drain_timeout_s)
        if self._httpd is not None:
            self._httpd.shutdown()  # accept loop stops; in-flight continue
        drained = self.admission.drain(timeout_s=timeout)
        if not drained:
            self._log.warning(
                "server drain timed out after %.1fs with %d request(s) "
                "in flight", timeout, self.admission.inflight(),
            )
        events.emit("http.server_drain", drained=drained,
                    shedTotal=self.admission.shed_total)
        if self._httpd is not None:
            self._httpd.server_close()
            self._httpd = None
        self.tasks.shutdown()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.prefix}"

    # ---- dispatch ---------------------------------------------------------------
    def _admission_class(self, method: str, endpoint: str,
                         handler, params: dict) -> str:
        """Cheap reads vs analyzer-bound work.  Async-POST *polls* (a
        known task id riding along) are reads — shedding them under load
        would strand every client of the 202 protocol."""
        if method == "GET":
            return CLASS_GET
        if endpoint in ASYNC_POST_ENDPOINTS:
            tid = handler.headers.get(USER_TASK_HEADER) \
                or params.get("user_task_id")
            return CLASS_GET if tid else CLASS_COMPUTE
        return CLASS_GET

    def _request_deadline(self, handler) -> Optional[float]:
        """Absolute monotonic deadline from the ``deadline-ms`` header (or
        the configured default); None = none."""
        raw = handler.headers.get(DEADLINE_HEADER)
        ms = int(raw) if raw is not None else self.default_deadline_ms
        if ms <= 0:
            return None
        return time.monotonic() + ms / 1000.0

    def _request_trace_id(self, handler) -> str:
        """The request's correlation id: a well-formed client-supplied
        ``X-Trace-Id`` wins (cross-service correlation), anything else is
        minted — so a hostile header can never grow the id space."""
        raw = (handler.headers.get(TRACE_HEADER) or "").strip()
        if raw and _TRACE_ID_OK.match(raw):
            return raw
        return self._trace_id_factory()

    def _note_unhandled_5xx(self) -> None:
        """Feed the zero-unhandled-5xx SLO: a 500 (or a 5xx carrying no
        backpressure guidance) is an operator-page, not a retry hint."""
        registry = getattr(self.cc, "registry", None)
        if registry is not None:
            registry.meter("http.unhandled.error").mark()

    def _dispatch(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        # one correlation id per request: every span and journal event
        # produced inside (including on async worker threads) carries it,
        # and GET /trace?id= reconstructs the request end-to-end.  The
        # critical-path clock opens here and closes when the response is
        # flushed: its consecutive marks partition the request wall
        # EXACTLY (docs/OBSERVABILITY.md "Reading a critical-path
        # breakdown")
        with critical_path.request_scope(), \
                trace_mod.trace_scope(self._request_trace_id(handler)):
            with self.admission.track():
                try:
                    self._dispatch_inner(handler, method)
                except RequestShedError as e:
                    self._send(handler, 429, {"errorMessage": str(e)},
                               headers={"Retry-After":
                                        str(e.retry_after_s)})
                except DeadlineExceededError as e:
                    # the client's own deadline passed: there is nobody
                    # left to retry fast, but Retry-After keeps automated
                    # clients honest
                    self._send(handler, 503, {"errorMessage": str(e)},
                               headers={"Retry-After":
                                        str(RETRY_AFTER_BUSY_S)})
                except AnalyzerSaturatedError as e:
                    self._send(handler, 503, {"errorMessage": str(e)},
                               headers={"Retry-After":
                                        str(e.retry_after_s)})
                except (ValueError, KeyError) as e:
                    self._log.warning("%s %s -> 400: %s", method,
                                      handler.path, e)
                    self._send(handler, 400, {"errorMessage": str(e)})
                except NotEnoughValidWindowsError as e:
                    self._log.info("%s %s -> 503: %s", method,
                                   handler.path, e)
                    self._send(
                        handler, 503, {"errorMessage": str(e)},
                        headers={"Retry-After":
                                 str(RETRY_AFTER_NOT_READY_S)})
                except Exception as e:
                    self._log.exception("%s %s -> 500", method,
                                        handler.path)
                    self._note_unhandled_5xx()
                    self._send(handler, 500, {"errorMessage": repr(e)})

    def _dispatch_inner(self, handler: BaseHTTPRequestHandler,
                        method: str) -> None:
        parsed = urlparse(handler.path)
        if method == "GET" and parsed.path.rstrip("/") in ("/ui", ""):
            return self._serve_ui(handler)
        # /health answers before auth, admission, and draining checks: a
        # load balancer's probe must never be queued, shed, or locked out
        if method == "GET" and parsed.path.rstrip("/") in (
                "/health", self.prefix + "/health"):
            critical_path.set_endpoint("health")
            return self._handle_health(handler)
        if not parsed.path.startswith(self.prefix + "/"):
            return self._send(handler, 404, {"errorMessage": "not found"})
        # the global in-flight ceiling: a storm becomes explicit 429s at
        # the door instead of invisible scheduler queueing (a handler
        # thread exists per connection — bound what they may carry)
        self.admission.check_global()
        endpoint = parsed.path[len(self.prefix) + 1:].strip("/").lower()
        registry = getattr(self.cc, "registry", None)
        # KNOWN endpoints only, so an URL scan cannot mint unbounded
        # metric names in the registry (unknown paths share one
        # "unknown" bucket; the request-duration timer below reuses
        # this same gate)
        known = (
            (method == "GET" and endpoint in GET_ENDPOINTS)
            or (method == "POST" and endpoint in ASYNC_POST_ENDPOINTS)
            or (method == "POST" and endpoint in SYNC_POST_ENDPOINTS)
        )
        if registry is not None:  # servlet request rates (§5.1)
            bucket = (endpoint or "root") if (known or not endpoint) \
                else "unknown"
            registry.meter(f"http.{method}.{bucket}").mark()  # cclint: disable=obs-dynamic-name -- bounded: method is GET/POST, bucket is drawn from the routing tables plus root/unknown
        params = {
            k: v[-1] for k, v in parse_qs(parsed.query).items()
        }
        if method == "POST" and self.max_body_bytes:
            # request bodies are unused by this API; a declared body past
            # the cap is rejected before anything reads it (413)
            length = int(handler.headers.get("Content-Length") or 0)
            if length > self.max_body_bytes:
                return self._send(handler, 413, {
                    "errorMessage": (
                        f"request body {length} bytes > cap "
                        f"{self.max_body_bytes} (webserver.request."
                        f"max.body.bytes)"
                    )
                })
        critical_path.set_endpoint(endpoint or "root")
        critical_path.mark("parse")  # routing + params + body cap
        if self.security is not None and not self._authenticated(handler):
            handler.send_response(401)
            handler.send_header("WWW-Authenticate", "Basic")
            handler.end_headers()
            return
        deadline = self._request_deadline(handler)
        cls = self._admission_class(method, endpoint, handler, params)
        critical_path.mark("auth")  # authentication + deadline header
        with admission_mod.deadline_scope(deadline):
            # an already-dead request sheds before admission: it must not
            # consume a slot another client could use
            admission_mod.check_deadline(f"{method} {endpoint}")
            with self.admission.admit(cls):
                critical_path.mark("admissionQueue")  # slot wait
                # request span, correlated with the async protocol's task
                # id via _respond_task's annotate (guard before the
                # f-string: the disabled path must not pay for formatting)
                if tracing.enabled():
                    req_span = tracing.span(
                        "http", sub=f"{method}.{endpoint or 'root'}"
                    )
                else:
                    req_span = tracing.NOOP
                t_req = time.perf_counter()
                try:
                    with req_span:
                        if method == "GET" and endpoint in GET_ENDPOINTS:
                            return self._handle_get(
                                handler, endpoint, params)
                        if method == "POST" \
                                and endpoint in ASYNC_POST_ENDPOINTS:
                            return self._handle_async_post(
                                handler, endpoint, params)
                        if method == "POST" \
                                and endpoint in SYNC_POST_ENDPOINTS:
                            return self._handle_sync_post(
                                handler, endpoint, params)
                finally:
                    if known and registry is not None:
                        registry.timer(f"http.{method}.{endpoint}").update(  # cclint: disable=obs-dynamic-name -- bounded: gated on known, endpoint is in the routing tables
                            time.perf_counter() - t_req
                        )
        self._send(handler, 404, {
            "errorMessage": f"unknown endpoint {method} {endpoint!r}"
        })

    def _handle_health(self, handler) -> None:
        """Liveness + readiness for load balancers (never queued, never
        shed, no auth): readiness = enough monitor windows for a model +
        analyzer breaker not open + not draining."""
        monitor_state: dict = {}
        windows = 0
        try:
            monitor_state = self.cc.load_monitor.state_summary()
            windows = int(monitor_state.get("numValidWindows") or 0)
        except Exception as e:  # a broken monitor is a NOT-ready, not a 500
            monitor_state = {"error": repr(e)}
        breaker = getattr(self.cc, "breaker", None)
        breaker_state = breaker.state if breaker is not None else None
        draining = self.admission.draining
        ready = (windows >= 1 and not draining
                 and breaker_state != "OPEN")
        body = {
            "liveness": "UP",
            "ready": ready,
            "monitorWindows": windows,
            "monitorState": monitor_state.get("state"),
            "breaker": breaker_state,
            "draining": draining,
            "admission": self.admission.state_summary(),
        }
        # an unready 503 carries Retry-After like every other
        # backpressure response (shed fairness: no 5xx without guidance)
        return self._send(
            handler, 200 if ready else 503, body,
            headers=(None if ready
                     else {"Retry-After": str(RETRY_AFTER_NOT_READY_S)}),
        )

    def _authenticated(self, handler) -> bool:
        """Support both the provider SPI (authenticate_request) and the
        legacy single-header authenticate."""
        fn = getattr(self.security, "authenticate_request", None)
        if fn is not None:
            return fn(handler.headers, handler.client_address)
        return self.security.authenticate(
            handler.headers.get("Authorization")
        )

    def _serve_ui(self, handler) -> None:
        """Serve the dashboard: webserver.ui.path when configured (a file, or
        a directory's index.html — e.g. the upstream Vue app's dist/),
        otherwise the built-in single-file dashboard (upstream serves the
        Vue UI's dist/ at /ui; SURVEY.md §2.9)."""
        import pathlib

        if self.ui_path:
            ui = pathlib.Path(self.ui_path)
            if ui.is_dir():
                ui = ui / "index.html"
        else:
            ui = pathlib.Path(__file__).with_name("ui.html")
        body = ui.read_bytes().replace(
            b"__API_PREFIX__", self.prefix.encode()
        )
        handler.send_response(200)
        handler.send_header("Content-Type", "text/html; charset=utf-8")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _send(self, handler, code: int, body: dict,
              headers: Optional[Dict[str, str]] = None) -> None:
        # everything since the previous mark was endpoint work
        critical_path.mark("handler")
        if self.access_log:
            self._log.info(
                "%s %s %d", handler.command, handler.path, code
            )
        data = json.dumps(body, default=str).encode()
        critical_path.mark("serialize")
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        if self.cors_enabled:
            handler.send_header("Access-Control-Allow-Origin",
                                self.cors_origin)
            # browsers only expose safelisted headers cross-origin: without
            # this the async 202 protocol's task id is unreadable from a
            # remote UI and its poll loop silently never starts
            handler.send_header("Access-Control-Expose-Headers",
                                "User-Task-ID")
        tid = trace_mod.current_trace_id()
        if tid:
            handler.send_header(TRACE_HEADER, tid)
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(data)
        critical_path.mark("flush")

    def _send_text(self, handler, code: int, body: str,
                   content_type: str) -> None:
        critical_path.mark("handler")
        if self.access_log:
            self._log.info("%s %s %d", handler.command, handler.path, code)
        data = body.encode()
        critical_path.mark("serialize")
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(data)))
        if self.cors_enabled:
            handler.send_header("Access-Control-Allow-Origin",
                                self.cors_origin)
        handler.end_headers()
        handler.wfile.write(data)
        critical_path.mark("flush")

    def _extra_metric_families(self):
        """Labeled families the flat registry can't express: per-action
        anomaly-handling outcome counters (upstream AnomalyDetectorState
        metrics; ``cc_anomaly_actions_total{action="FIX"}``) and the
        monitor's per-reason quarantine counters
        (``cc_monitor_quarantined_total{reason="non-finite"}``)."""
        families = []
        det = getattr(self.cc, "anomaly_detector", None)
        counts_fn = getattr(det, "action_counts", None)
        if counts_fn is not None:
            rows = [({"action": action}, float(n))
                    for action, n in sorted(counts_fn().items())]
            if rows:
                families.append((
                    "cc_anomaly_actions_total", "counter",
                    "Anomaly-handling outcomes by final action", rows,
                ))
        validator = getattr(
            getattr(self.cc, "load_monitor", None), "sample_validator", None
        )
        if validator is not None:
            rows = [({"reason": reason}, float(n))
                    for reason, n in sorted(validator.reason_totals()
                                            .items())]
            if rows:
                families.append((
                    "cc_monitor_quarantined_total", "counter",
                    "Metric samples quarantined by the validation stage, "
                    "by reject reason", rows,
                ))
        return families

    # ---- GET endpoints ----------------------------------------------------------
    def _handle_get(self, handler, endpoint: str, params: dict) -> None:
        if endpoint == "metrics":
            # Prometheus text exposition of the shared registry + the
            # span-derived phase timers (upstream: the JMX-exposed
            # Dropwizard registry; scrapers speak this format instead)
            from cruise_control_tpu_torch.telemetry.exposition import (
                CONTENT_TYPE,
                render_prometheus,
            )

            registry = getattr(self.cc, "registry", None)
            if registry is None:
                return self._send(handler, 503, {
                    "errorMessage": "no metric registry attached"
                })
            body = render_prometheus(
                registry, tracing.TELEMETRY,
                extra_families=self._extra_metric_families(),
            )
            return self._send_text(handler, 200, body, CONTENT_TYPE)
        if endpoint == "events":
            # decision-provenance journal (docs/OBSERVABILITY.md): the
            # structured what/why record — optimize/execute lifecycle with
            # goal summaries, executor batches + task deaths, detector
            # decisions.  `since` (unix seconds, exclusive) and `kind`
            # (exact or dotted-prefix family) filter; `limit` paginates
            # from the newest.
            from cruise_control_tpu_torch.telemetry import events as events_mod

            journal = self.event_journal or events_mod.JOURNAL
            if not journal.enabled:
                return self._send(handler, 503, {
                    "errorMessage": "event journal disabled "
                                    "(telemetry.events.enabled=false?)"
                })
            since = params.get("since")
            kind = params.get("kind")
            limit = int(params.get("limit", 500))
            matched = journal.recent(
                since=float(since) if since is not None else None,
                kind=kind or None,
            )
            evs = matched[-limit:] if limit >= 0 else matched
            return self._send(handler, 200, {
                "schema": events_mod.SCHEMA,
                "numMatched": len(matched),
                "numReturned": len(evs),
                "events": evs,
            })
        if endpoint == "slo":
            # the SLO observatory's gate table (cc-tpu-slo/1): objectives
            # vs measured over the journal window + registry, with
            # hysteresis state (docs/OBSERVABILITY.md "SLO observatory")
            if self.slo_engine is None:
                return self._send(handler, 503, {
                    "errorMessage": "no SLO engine attached "
                                    "(telemetry.slo.enabled=false?)"
                })
            return self._send(handler, 200, self.slo_engine.report())
        if endpoint == "trace":
            # end-to-end trace reconstruction: ?id= returns Chrome-trace
            # JSON (cc-tpu-trace/1) merging the id's retained span trees
            # with its journal records; without id, the trace index
            store = self.trace_store
            if store is None or not store.enabled:
                return self._send(handler, 503, {
                    "errorMessage": "trace store disabled "
                                    "(telemetry.trace.enabled=false?)"
                })
            tid = params.get("id")
            if not tid:
                return self._send(handler, 200, {"traces": store.index()})
            from cruise_control_tpu_torch.telemetry import events as events_mod

            journal = self.event_journal or events_mod.JOURNAL
            matched = [e for e in journal.recent()
                       if e.get("traceId") == tid]
            spans = store.spans(tid)
            if not spans and not matched:
                return self._send(handler, 404, {
                    "errorMessage": f"unknown trace id {tid!r} (evicted, "
                                    "or the request never ran here)"
                })
            return self._send(
                handler, 200, trace_mod.chrome_trace(tid, spans, matched)
            )
        if endpoint == "profile/kernels":
            # kernel observatory (docs/OBSERVABILITY.md "Reading a kernel
            # budget"): ?arm=true[&scans=N] arms a capture of the next N
            # drive-loop scan calls (202 + state; trigger an optimization
            # and poll), plain GETs serve the latest parsed
            # cc-tpu-kernel-budget/2 artifact (404 before the first
            # capture; 202 while armed / parsing — the SLO tick parses)
            from cruise_control_tpu_torch.telemetry import kernel_budget

            capture = kernel_budget.CAPTURE
            if not capture.enabled:
                return self._send(handler, 503, {
                    "errorMessage": "kernel observatory disabled "
                                    "(telemetry.kernel.enabled=false?)"
                })
            if _flag(params, "arm"):
                scans = params.get("scans")
                state = capture.arm(
                    scans=int(scans) if scans else None, reason="http")
                return self._send(handler, 202, {
                    "message": "capture armed: run an optimization and "
                               "poll GET /profile/kernels",
                    "capture": state,
                })
            artifact = capture.latest()
            if artifact is not None:
                return self._send(handler, 200, artifact)
            state = capture.state()
            if state["state"] != "IDLE" or state["pendingParses"] \
                    or state["activeParses"]:
                return self._send(handler, 202, {
                    "message": "capture in flight (armed, mid-parse, or "
                               "awaiting the SLO-tick parse) — poll again",
                    "capture": state,
                })
            return self._send(handler, 404, {
                "errorMessage": "no kernel capture parsed yet — arm one "
                                "with GET /profile/kernels?arm=true",
                "capture": state,
            })
        if endpoint == "profile/mesh":
            # mesh observatory (docs/OBSERVABILITY.md "Mesh observatory"):
            # the same 202-arm/poll ladder as /profile/kernels — one armed
            # capture feeds both artifacts.  ?audit=true runs the
            # replication audit inline (a cheap live-array metadata walk)
            from cruise_control_tpu_torch.telemetry import kernel_budget
            from cruise_control_tpu_torch.telemetry import mesh_budget

            mesh = mesh_budget.MESH
            if not mesh.enabled or not kernel_budget.CAPTURE.enabled:
                return self._send(handler, 503, {
                    "errorMessage": "mesh observatory disabled "
                                    "(telemetry.mesh.enabled=false or "
                                    "telemetry.kernel.enabled=false?)"
                })
            if _flag(params, "audit"):
                return self._send(handler, 200, mesh.audit())
            if _flag(params, "arm"):
                scans = params.get("scans")
                state = mesh.arm(
                    scans=int(scans) if scans else None, reason="http")
                return self._send(handler, 202, {
                    "message": "capture armed: run an optimization and "
                               "poll GET /profile/mesh",
                    "mesh": state,
                })
            artifact = mesh.latest()
            if artifact is not None:
                return self._send(handler, 200, artifact)
            state = mesh.state()
            cap = state["capture"]
            if cap["state"] != "IDLE" or cap["pendingParses"] \
                    or cap["activeParses"]:
                return self._send(handler, 202, {
                    "message": "capture in flight (armed, mid-parse, or "
                               "awaiting the SLO-tick parse) — poll again",
                    "mesh": state,
                })
            return self._send(handler, 404, {
                "errorMessage": "no mesh capture parsed yet — arm one "
                                "with GET /profile/mesh?arm=true",
                "mesh": state,
            })
        if endpoint == "profile/host":
            # host observatory (docs/OBSERVABILITY.md "Host
            # observatory"): ?arm=true[&samples=N] opens a capture over
            # the next N sampling ticks (202 + state; poll), plain GETs
            # serve the latest built cc-tpu-host-profile/1 artifact (404
            # before the first capture; 202 while armed / building — the
            # SLO tick builds)
            from cruise_control_tpu_torch.telemetry import host_profile

            profiler = host_profile.PROFILER
            if not profiler.enabled:
                return self._send(handler, 503, {
                    "errorMessage": "host observatory disabled "
                                    "(telemetry.host.enabled=false?)"
                })
            if _flag(params, "arm"):
                samples = params.get("samples")
                profiler.ensure_started()
                state = profiler.arm(
                    samples=int(samples) if samples else None,
                    reason="http")
                return self._send(handler, 202, {
                    "message": "capture armed: the sampler collects the "
                               "next ticks — poll GET /profile/host",
                    "capture": state,
                })
            artifact = profiler.latest()
            if artifact is not None:
                return self._send(handler, 200, artifact)
            state = profiler.state()
            if state["state"] != "IDLE" or state["pendingParses"] \
                    or state["activeParses"]:
                return self._send(handler, 202, {
                    "message": "capture in flight (armed, mid-build, or "
                               "awaiting the SLO-tick build) — poll again",
                    "capture": state,
                })
            return self._send(handler, 404, {
                "errorMessage": "no host capture built yet — arm one "
                                "with GET /profile/host?arm=true",
                "capture": state,
            })
        if endpoint == "diagnostics":
            # flight-recorder artifact: retained time series + the merged
            # anomaly journal (docs/OBSERVABILITY.md) — the crash-readable
            # "what happened in the last ten minutes" surface
            if self.flight_recorder is None:
                return self._send(handler, 503, {
                    "errorMessage": "no flight recorder attached "
                                    "(telemetry.recorder.enabled=false?)"
                })
            return self._send(handler, 200, self.flight_recorder.artifact())
        if endpoint == "state":
            # verbose embeds the per-move task arrays in
            # ExecutorState.recentExecutions (upstream: verbose substates)
            return self._send(
                handler, 200, self.cc.state(verbose=_flag(params, "verbose")))
        if endpoint == "load":
            return self._send(handler, 200, self._load_response())
        if endpoint == "partition_load":
            return self._send(handler, 200, self._partition_load_response(params))
        if endpoint == "proposals":
            # serve from the warm precomputed plan when fresh; degrade to
            # the last-good plan (stale=true + generation marker) when the
            # analyzer is saturated or the monitor window-starved
            result, meta = self.cc.serve_proposals(
                ignore_cache=_flag(params, "ignore_proposal_cache"),
                allow_stale=_flag(params, "allow_stale", default=True),
            )
            # time inside the facade (cache hit / single-flight wait /
            # compute) gets its own critical-path phase; the remaining
            # response shaping reads as "handler"
            critical_path.mark("facade")
            body = _optimizer_response(result, params)
            body.update(meta)
            return self._send(handler, 200, body)
        if endpoint == "kafka_cluster_state":
            return self._send(handler, 200, self._cluster_state_response())
        if endpoint == "user_tasks":
            wanted = params.get("user_task_ids")
            tasks = self.tasks.tasks()
            if wanted:
                ids = set(wanted.split(","))
                tasks = [t for t in tasks if t.task_id in ids]
            return self._send(
                handler, 200, {"userTasks": [t.to_json() for t in tasks]}
            )
        if endpoint == "review_board":
            return self._send(
                handler, 200, {"requestInfo": self.purgatory.review_board()}
            )

    def _load_response(self) -> dict:
        with self.cc.load_monitor.acquire_for_model_generation():
            state = self.cc.load_monitor.cluster_model()
        from cruise_control_tpu_torch.models.cluster_state import broker_load

        load = np.asarray(broker_load(state))
        ext = state.broker_ids or tuple(range(state.num_brokers))
        alive = np.asarray(state.broker_alive())
        rack = np.asarray(state.broker_rack)
        cap = np.asarray(state.broker_capacity)
        brokers = []
        for i in range(state.num_brokers):
            brokers.append({
                "Broker": int(ext[i]),
                "BrokerState": "ALIVE" if alive[i] else "DEAD",
                "Rack": int(rack[i]),
                "CpuPct": round(float(load[i, Resource.CPU]), 3),
                "NwInRate": round(float(load[i, Resource.NW_IN]), 3),
                "NwOutRate": round(float(load[i, Resource.NW_OUT]), 3),
                "DiskMB": round(float(load[i, Resource.DISK]), 3),
                "DiskCapacityMB": float(cap[i, Resource.DISK]),
                # per-resource capacities so clients can chart UTILIZATION
                # for every resource, not just disk (the UI's history view)
                "CpuCapacityPct": float(cap[i, Resource.CPU]),
                "NwInCapacity": float(cap[i, Resource.NW_IN]),
                "NwOutCapacity": float(cap[i, Resource.NW_OUT]),
            })
        return {"brokers": brokers}

    def _partition_load_response(self, params: dict) -> dict:
        with self.cc.load_monitor.acquire_for_model_generation():
            state = self.cc.load_monitor.cluster_model()
        resource = params.get("resource", "DISK").upper()
        r = Resource[resource]
        ll = np.asarray(state.leader_load)
        ext_p = state.partition_ids or tuple(range(state.num_partitions))
        ext_b = state.broker_ids or tuple(range(state.num_brokers))
        leader = np.asarray(state.leader_broker())
        order = np.argsort(-ll[:, r])
        n = int(params.get("entries", 20))
        records = []
        for p in order[:n]:
            records.append({
                "partition": int(ext_p[int(p)]),
                "leader": int(ext_b[int(leader[p])]),
                "cpu": round(float(ll[p, Resource.CPU]), 3),
                "networkInbound": round(float(ll[p, Resource.NW_IN]), 3),
                "networkOutbound": round(float(ll[p, Resource.NW_OUT]), 3),
                "disk": round(float(ll[p, Resource.DISK]), 3),
            })
        return {"records": records, "sortedBy": resource}

    def _cluster_state_response(self) -> dict:
        topo = self.cc.load_monitor.metadata.refresh()
        alive = topo.alive_brokers
        offline = topo.offline_replicas or {}
        partitions = []
        for p in sorted(topo.assignment):
            reps = topo.assignment[p]
            partitions.append({
                "partition": p,
                "topic": topo.partition_topic.get(p),
                "leader": topo.leaders.get(p),
                "replicas": list(reps),
                "in-sync": [
                    b for b in reps
                    if (alive is None or b in alive)
                    and b not in offline.get(p, ())
                ],
                "offline": list(offline.get(p, ())),
            })
        return {
            "KafkaBrokerState": {
                "IsController": {},
                "Brokers": sorted(topo.broker_rack),
                "AliveBrokers": sorted(alive) if alive is not None else None,
            },
            "KafkaPartitionState": {"partitions": partitions},
        }

    # ---- async POST endpoints ---------------------------------------------------
    def _handle_async_post(self, handler, endpoint: str, params: dict) -> None:
        # poll path: a request carrying a known task id returns its status
        tid = handler.headers.get(USER_TASK_HEADER) or params.get(
            "user_task_id"
        )
        if tid:
            task = self.tasks.get(tid)
            if task is None:
                return self._send(handler, 404, {
                    "errorMessage": f"unknown user task {tid}"
                })
            if task.endpoint != endpoint:
                return self._send(handler, 400, {
                    "errorMessage": (
                        f"task {tid} belongs to {task.endpoint}, "
                        f"not {endpoint}"
                    )
                })
            return self._respond_task(handler, task, params)

        if self.two_step:
            rid = params.get("review_id")
            if rid is None:
                info = self.purgatory.add(endpoint, params)
                return self._send(handler, 202, {
                    "reviewId": info.review_id,
                    "status": info.status,
                    "message": "two-step verification: approve via /review",
                })
            # execute exactly what the admin approved — the resubmission's
            # own params must not be able to smuggle in e.g. dryrun=false
            info = self.purgatory.take_approved(int(rid), endpoint)
            params = dict(info.params)
        else:
            info = None

        fn = self._operation(endpoint, params)
        try:
            task = self.tasks.submit(
                endpoint, lambda progress: fn(progress),
                deadline_monotonic=admission_mod.current_deadline(),
                trace_id=trace_mod.current_trace_id(),
            )
            # journal the operation ↔ User-Task-ID binding: operation
            # events run on the worker thread (task_scope), this records
            # who asked for what under which id
            events.emit("http.task_submitted", operation=endpoint.upper(),
                        task_id=task.task_id)
        except TooManyTasksError as e:
            if info is not None:
                # the approval must survive a transient capacity rejection
                self.purgatory.requeue(info.review_id)
            return self._send(handler, 429, {"errorMessage": str(e)},
                              headers={"Retry-After":
                                       str(RETRY_AFTER_BUSY_S)})
        return self._respond_task(handler, task, params)

    def _respond_task(self, handler, task, params: dict) -> None:
        # the request span learns its task id only here, after submission
        tracing.annotate("user_task_id", task.task_id)
        timeout_s = float(params.get("get_response_timeout_s", 0.0))
        if timeout_s:
            try:
                task.future.result(timeout=timeout_s)
            except BaseException:
                # the wait only decides 200-vs-202; the error branch below
                # reports the failure.  BaseException on purpose: a worker
                # unwound by a simulated ProcessCrash must still produce
                # an HTTP response, not kill the handler thread.
                pass
        if not task.future.done():
            return self._send(
                handler, 202, task.to_json(),
                headers={USER_TASK_HEADER: task.task_id},
            )
        err = task.future.exception()
        if err is not None:
            not_ready = isinstance(err, NotEnoughValidWindowsError)
            overload = isinstance(
                err, (DeadlineExceededError, AnalyzerSaturatedError,
                      RequestShedError)
            )
            headers = {USER_TASK_HEADER: task.task_id}
            if not_ready:
                headers["Retry-After"] = str(RETRY_AFTER_NOT_READY_S)
            elif overload:
                headers["Retry-After"] = str(
                    getattr(err, "retry_after_s", RETRY_AFTER_BUSY_S)
                )
            else:
                self._note_unhandled_5xx()
            return self._send(
                handler, 503 if (not_ready or overload) else 500,
                {"errorMessage": repr(err), "UserTaskId": task.task_id},
                headers=headers,
            )
        result = task.future.result()
        if hasattr(result, "violations_after"):
            body = _optimizer_response(result, params)
        elif hasattr(result, "to_json"):
            body = result.to_json()
        elif hasattr(result, "summary"):
            body = dict(result.summary())
        else:
            body = {"message": str(result)}
        body["UserTaskId"] = task.task_id
        return self._send(
            handler, 200, body, headers={USER_TASK_HEADER: task.task_id}
        )

    def _operation(self, endpoint: str, params: dict):
        cc = self.cc
        dryrun = _flag(params, "dryrun", default=True)
        goals = params.get("goals")
        goal_list = goals.split(",") if goals else None
        # `goals` config key: REST-supplied goal names are validated here,
        # at the request boundary — internal operations pin their own
        # subsets (demote, rebalance_disk, kafka_assigner) unrestricted
        allowed = getattr(cc, "allowed_goals", None)
        if goal_list and allowed is not None:
            bad = set(goal_list) - allowed
            if bad:
                raise ValueError(
                    f"goals not permitted by the `goals` config: "
                    f"{sorted(bad)}"
                )
        engine = params.get("engine")

        if endpoint == "rebalance":
            rebalance_disk = _flag(params, "rebalance_disk")
            kafka_assigner = _flag(params, "kafka_assigner")
            if _flag(params, "allow_cached") and not (
                    goal_list or rebalance_disk or kafka_assigner):
                # serve/execute the warm precomputed plan in milliseconds
                # (§3.5); the response carries cached/stale markers
                return lambda progress: cc.rebalance_cached(
                    dryrun=dryrun, progress=progress,
                )
            return lambda progress: cc.rebalance(
                goals=goal_list, dryrun=dryrun, engine=engine,
                progress=progress, rebalance_disk=rebalance_disk,
                kafka_assigner=kafka_assigner,
            )
        if endpoint in ("add_broker", "remove_broker", "demote_broker"):
            ids = _broker_ids(params)
            op = {
                "add_broker": cc.add_brokers,
                "remove_broker": cc.remove_brokers,
                "demote_broker": cc.demote_brokers,
            }[endpoint]
            if endpoint == "demote_broker":
                return lambda progress: op(
                    ids, dryrun=dryrun, progress=progress
                )
            return lambda progress: op(
                ids, dryrun=dryrun, engine=engine, progress=progress
            )
        if endpoint == "fix_offline_replicas":
            return lambda progress: cc.fix_offline_replicas(
                dryrun=dryrun, engine=engine, progress=progress
            )
        if endpoint == "topic_configuration":
            rf = int(params["replication_factor"])
            topic = params.get("topic")  # optional name regex (upstream)
            return lambda progress: cc.fix_topic_replication_factor(
                rf, dryrun=dryrun, progress=progress, topic_regex=topic
            )
        if endpoint == "rightsize":
            return lambda progress: cc.rightsize(progress=progress)
        if endpoint == "whatif":
            from cruise_control_tpu_torch.whatif.futures import parse_futures_param
            # `futures` is a JSON list of future specs in the query
            # string (request bodies are unused by this API); absent →
            # the facade evaluates its likely-futures set against the
            # model it builds.  Parsing happens HERE, at the request
            # boundary, so a malformed spec is a 400 — not a failed task
            raw = params.get("futures")
            futures = None if not raw else parse_futures_param(
                raw, max_futures=getattr(cc, "whatif_max_futures", 256),
            )
            use_cache = _flag(params, "use_cache", default=True)
            return lambda progress: cc.whatif(
                futures, progress=progress, use_cache=use_cache
            )
        raise ValueError(f"unhandled async endpoint {endpoint}")

    # ---- sync POST endpoints ----------------------------------------------------
    def _handle_sync_post(self, handler, endpoint: str, params: dict) -> None:
        if endpoint == "stop_proposal_execution":
            self.cc.stop_execution()
            return self._send(handler, 200, {"message": "stop requested"})
        if endpoint == "pause_sampling":
            self.cc.pause_sampling()
            return self._send(handler, 200, {"message": "sampling paused"})
        if endpoint == "resume_sampling":
            self.cc.resume_sampling()
            return self._send(handler, 200, {"message": "sampling resumed"})
        if endpoint == "admin":
            return self._send(handler, 200, self._admin(params))
        if endpoint == "review":
            approve = params.get("approve")
            discard = params.get("discard")
            reason = params.get("reason")
            out: List[dict] = []
            for rid in (approve or "").split(","):
                if rid:
                    out.append(self.purgatory.approve(int(rid), reason).to_json())
            for rid in (discard or "").split(","):
                if rid:
                    out.append(self.purgatory.discard(int(rid), reason).to_json())
            return self._send(handler, 200, {"requestInfo": out})
        if endpoint == "train":
            return self._send(handler, 200, self._train())

    def _admin(self, params: dict) -> dict:
        # import at use-site: detector.anomalies uses server.progress, so a
        # module-level import here would close an import cycle through the
        # two package __init__s
        from cruise_control_tpu_torch.detector.anomalies import AnomalyType

        changed = {}
        detector = self.cc.anomaly_detector
        enable = params.get("enable_self_healing_for")
        disable = params.get("disable_self_healing_for")
        if (enable or disable) and detector is None:
            raise ValueError("no anomaly detector attached")
        for name in (enable or "").split(","):
            if name:
                detector.notifier.set_self_healing(
                    AnomalyType[name.upper()], True
                )
                changed[name.upper()] = True
        for name in (disable or "").split(","):
            if name:
                detector.notifier.set_self_healing(
                    AnomalyType[name.upper()], False
                )
                changed[name.upper()] = False
        concurrency = params.get("concurrent_partition_movements_per_broker")
        if concurrency is not None:
            self.cc.executor.config.\
                num_concurrent_partition_movements_per_broker = int(concurrency)
            changed["concurrentPartitionMovementsPerBroker"] = int(concurrency)
        leader_conc = params.get("concurrent_leader_movements")
        if leader_conc is not None:
            self.cc.executor.config.num_concurrent_leader_movements = int(
                leader_conc
            )
            changed["concurrentLeaderMovements"] = int(leader_conc)
        return {"selfHealingEnabledChanged": changed}

    def _train(self) -> dict:
        """Refit the partition-CPU linear model from broker history (upstream
        TRAIN endpoint → LinearRegressionModelParameters)."""
        from cruise_control_tpu_torch.monitor.sampling import (
            LinearRegressionModelParameters,
        )

        agg = self.cc.load_monitor.broker_aggregator.aggregate()
        fitted = LinearRegressionModelParameters.fit(agg.values)
        if fitted is None:
            return {"trained": False, "message": "not enough training data"}
        processor = getattr(self.cc.load_monitor.sampler, "processor", None)
        if processor is None:
            return {"trained": False, "message": "sampler has no processor"}
        processor.params.cpu_weight_bytes_in = fitted.cpu_weight_bytes_in
        processor.params.cpu_weight_bytes_out = fitted.cpu_weight_bytes_out
        return {
            "trained": True,
            "cpuWeightBytesIn": processor.params.cpu_weight_bytes_in,
            "cpuWeightBytesOut": processor.params.cpu_weight_bytes_out,
        }


# ---------------------------------------------------------------------------------
def _flag(params: dict, name: str, default: bool = False) -> bool:
    v = params.get(name)
    if v is None:
        return default
    return v.lower() in ("true", "1", "yes")


def _broker_ids(params: dict) -> List[int]:
    raw = params.get("brokerid") or params.get("broker_id")
    if not raw:
        raise ValueError("brokerid parameter required")
    return [int(b) for b in raw.split(",")]


def _optimizer_response(result, params: dict) -> dict:
    body = dict(result.summary())
    if _flag(params, "verbose"):
        body["proposals"] = [p.to_json() for p in result.proposals]
    else:
        body["proposals"] = [p.to_json() for p in result.proposals[:20]]
    # cached-plan provenance (rebalance_cached): stale/generation markers
    body.update(getattr(result, "cache_meta", None) or {})
    return body

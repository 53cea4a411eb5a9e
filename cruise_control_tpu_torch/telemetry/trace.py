"""End-to-end trace correlation — one id from the HTTP request to the
device (``cc-tpu-trace/1``).

The span layer answers "what phases ran", the journal "what was decided"
— but until now nothing tied one request to *its* spans, *its* replan,
*its* device calls, and *its* executor batches.  This module closes the
loop:

* **One correlation id per request.**  The HTTP server mints (or accepts
  via the ``X-Trace-Id`` header) a trace id and enters
  :func:`trace_scope`, which sets BOTH thread-local scopes at once: the
  span layer stamps every span opened inside it (``SpanRecord.trace_id``)
  and the event journal stamps every record (``traceId``).  The async
  202 protocol re-enters the scope on the worker thread
  (``UserTaskManager.submit``), so a rebalance's facade spans, engine
  device spans, executor batch spans, and journal events all share the
  request's id across threads.
* **A bounded trace store.**  Completed ROOT spans carrying a trace id
  flow from the tracer's ``root_sink`` into :class:`TraceStore` — a
  bounded id → span-tree map (oldest trace evicted) serving
  ``GET /trace?id=``.
* **A Chrome-trace exporter.**  :func:`chrome_trace` merges the stored
  span trees (host phases + ``kind="device"`` slices on their own
  category) with the journal's trace-matched records (instant events) into
  the Trace Event Format every ``chrome://tracing`` / Perfetto build
  reads, so a single rebalance reconstructs on one timeline from the id
  alone.

Thread-safe: one lock around the store; the sink path does one dict
append per completed root span and nothing at all for spans without a
trace id.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from cruise_control_tpu_torch.telemetry import events, tracing
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("trace")

SCHEMA = "cc-tpu-trace/1"

_DEFAULT_MAX_TRACES = 64
_DEFAULT_SPANS_PER_TRACE = 512


class TraceStore:
    """Bounded trace-id → completed-root-span retention."""

    def __init__(self, enabled: bool = True,
                 max_traces: int = _DEFAULT_MAX_TRACES,
                 spans_per_trace: int = _DEFAULT_SPANS_PER_TRACE):
        self.enabled = enabled
        self.max_traces = max(1, int(max_traces))
        self.spans_per_trace = max(1, int(spans_per_trace))
        self._lock = threading.Lock()
        #: trace id → {"firstUnix": float, "spans": [span json trees]};
        #: insertion-ordered so eviction drops the oldest trace
        self._traces: "OrderedDict[str, dict]" = OrderedDict()

    def configure(self, enabled: Optional[bool] = None,
                  max_traces: Optional[int] = None,
                  spans_per_trace: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if max_traces is not None:
                self.max_traces = max(1, int(max_traces))
            if spans_per_trace is not None:
                self.spans_per_trace = max(1, int(spans_per_trace))
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()

    # ---- the tracer's root sink -------------------------------------------------
    def on_root(self, rec) -> None:
        """Receive one completed root SpanRecord (tracing.root_sink)."""
        if not self.enabled or rec.trace_id is None:
            return
        span = rec.to_json()
        with self._lock:
            ent = self._traces.get(rec.trace_id)
            if ent is None:
                ent = self._traces[rec.trace_id] = {
                    "firstUnix": span["startUnix"], "spans": [],
                }
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            if len(ent["spans"]) < self.spans_per_trace:
                ent["spans"].append(span)

    # ---- readers ----------------------------------------------------------------
    def spans(self, trace_id: str) -> List[dict]:
        with self._lock:
            ent = self._traces.get(trace_id)
            return list(ent["spans"]) if ent else []

    def index(self) -> List[dict]:
        """Per-trace summaries, oldest first (``GET /trace`` without id,
        and the flight-recorder merge)."""
        with self._lock:
            items = [(tid, ent["firstUnix"], list(ent["spans"]))
                     for tid, ent in self._traces.items()]
        return [
            {
                "traceId": tid,
                "firstUnix": first,
                "numRoots": len(spans),
                "roots": [s["name"] for s in spans],
            }
            for tid, first, spans in items
        ]


#: process-wide default (bootstrap reconfigures it from telemetry.trace.*)
STORE = TraceStore()


def install(store: Optional[TraceStore] = None) -> TraceStore:
    """Point the tracer's root sink at ``store`` (idempotent; the HTTP
    server and bootstrap both call this)."""
    store = store or STORE
    tracing.TELEMETRY.root_sink = store.on_root
    return store


def configure(enabled=None, max_traces=None, spans_per_trace=None) -> None:
    STORE.configure(enabled, max_traces, spans_per_trace)
    install(STORE)


@contextlib.contextmanager
def trace_scope(trace_id: Optional[str]):
    """Enter the correlation scope on this thread: spans AND journal
    events emitted inside carry ``trace_id``.  ``None`` is a no-op."""
    with tracing.TELEMETRY.trace_scope(trace_id):
        with events.JOURNAL.trace_scope(trace_id):
            yield


def current_trace_id() -> Optional[str]:
    return tracing.TELEMETRY.current_trace_id()


# ---- Chrome-trace / Perfetto export ---------------------------------------------
def _span_events(out: List[dict], span: dict, tid: int) -> None:
    out.append({
        "ph": "X",
        "name": span["name"],
        "cat": span.get("kind") or "host",
        "ts": round(span["startUnix"] * 1e6, 1),
        "dur": round(span["durationSec"] * 1e6, 1),
        "pid": 1,
        "tid": tid,
        "args": dict(span.get("attrs") or {}),
    })
    for child in span.get("children", ()):
        _span_events(out, child, tid)


def chrome_trace(trace_id: str, spans: List[dict],
                 journal_events: List[dict]) -> dict:
    """Merge span trees + journal records into one Trace Event Format
    document (the ``cc-tpu-trace/1`` artifact; loads in chrome://tracing
    and Perfetto).  Each root span tree gets its own ``tid`` track —
    request-handler thread, async worker, etc. reconstruct side by side —
    with ``kind="device"`` slices carrying ``cat="device"``; journal
    records become instant events on track 0."""
    trace_events: List[dict] = []
    for track, root in enumerate(
            sorted(spans, key=lambda s: s["startUnix"]), start=1):
        _span_events(trace_events, root, track)
    for rec in journal_events:
        args: Dict[str, object] = {"severity": rec.get("severity")}
        args.update(rec.get("payload") or {})
        trace_events.append({
            "ph": "i",
            "name": rec["kind"],
            "cat": "journal",
            "s": "g",
            "ts": round(float(rec["ts"]) * 1e6, 1),
            "pid": 1,
            "tid": 0,
            "args": args,
        })
    trace_events.sort(key=lambda e: e["ts"])
    return {
        "schema": SCHEMA,
        "traceId": trace_id,
        "generated_unix": round(time.time(), 3),
        "displayTimeUnit": "ms",
        "traceEvents": trace_events,
        "numSpanRoots": len(spans),
        "numJournalEvents": len(journal_events),
    }

"""Structured event journal — the decision-provenance record
(``cc-tpu-events/1``).

Upstream operators reconstruct a rebalance from *decision* records — the
per-goal proposal summaries in ``OptimizerResult``, the execution-task
state machine, and the self-healing log — not just from gauges.  The span
layer answers "what is happening" and the flight recorder "what happened
to the numbers"; this journal answers "**why**": which goal emitted a
proposal, which reject reasons were seen, what the executor actually did
with each batch, and what the detector decided about each anomaly.

Design mirrors :mod:`tracing`: one process-wide :class:`EventJournal`
singleton (``JOURNAL``) reconfigured once by bootstrap, with module-level
conveniences (``emit`` / ``enabled`` / ``recent``).  Producers guard any
dynamic formatting behind ``enabled()``; event *kinds* are static dotted
strings (``optimize.start``, ``executor.batch`` …) so journal cardinality
stays bounded — enforced by the ast check in ``tests/test_span_hygiene``.

Record schema (one JSON object per line, ``SCHEMA`` in every record):

    {"schema": "cc-tpu-events/1", "ts": <unix float>, "kind": "a.b",
     "severity": "INFO"|"WARNING"|"ERROR",
     "operation": "REBALANCE",      # optional: facade operation
     "taskId": "<User-Task-ID>",    # optional: async-protocol correlation
     "traceId": "<X-Trace-Id>",     # optional: end-to-end request trace
     "payload": {...}}              # optional: kind-specific details

Persistence: an append-only JSONL file with size rotation
(``path`` → ``path.1`` → … up to ``max_files``), plus a bounded in-memory
ring serving ``GET /events`` and the flight-recorder merge without file
reads.  A failed rebalance must be reconstructable from the FILE alone
(the diagnosability contract in ``tests/test_events.py``) — every emit
reaches disk before returning.  File lines carry the per-record CRC32
frame (:mod:`cruise_control_tpu_torch.utils.checksum`; ISSUE 13) — still one
valid JSON object per line, with a trailing ``crc`` member the ring
never sees.  :func:`load_records` reads a journal file back with the
same torn-tail-vs-mid-file discipline as the execution checkpoint: a
bad final line (a real crash mid-write) is dropped quietly, a bad
earlier line raises :class:`CorruptJournalError` carrying the trusted
prefix — an incident reconstruction must never silently skip damaged
evidence in the middle of the story.

Thread-safe: one lock around the ring + file; the User-Task-ID context is
thread-local (set by UserTaskManager around each async operation, so
every event emitted on that worker thread correlates automatically).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from cruise_control_tpu_torch.utils.checksum import scan_lines, stamp_line
from cruise_control_tpu_torch.utils.locks import InstrumentedLock
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("events")

SCHEMA = "cc-tpu-events/1"

_DEFAULT_MAX_BYTES = 16 * 1024 * 1024
_DEFAULT_MAX_FILES = 3
_DEFAULT_RING_SIZE = 2048

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")


class EventJournal:
    """Append-only, size-rotated JSONL journal + bounded in-memory ring."""

    def __init__(
        self,
        enabled: bool = False,
        path: Optional[str] = None,
        max_bytes: int = _DEFAULT_MAX_BYTES,
        max_files: int = _DEFAULT_MAX_FILES,
        ring_size: int = _DEFAULT_RING_SIZE,
        clock=None,
        exclude_kinds: frozenset = frozenset(),
    ):
        self.enabled = enabled
        #: kinds this journal refuses.  The scenario simulator swaps a
        #: virtual-clock journal in for the whole run; telemetry generated
        #: from REAL wall-clock observations (the sustained-contention
        #: detector, host-profile parses — both pumped by bootstrap SLO
        #: engines on host time) is meaningless in scenario time and
        #: nondeterministic, so the scenario journal drops those kinds at
        #: the door rather than racing every background emitter.
        self.exclude_kinds = frozenset(exclude_kinds)
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self.max_files = max(1, int(max_files))
        #: the ``ts`` source.  Production journals stamp wall time; the
        #: scenario simulator injects its virtual clock so ts-windowed
        #: readers (the SLO engine's sliding window) follow the scenario
        #: clock instead of the host's — a soak evaluating "the last 30
        #: minutes" means 30 *virtual* minutes.
        self.clock = clock or time.time
        self._lock = InstrumentedLock("journal.events")
        self._ring: deque = deque(maxlen=max(16, int(ring_size)))
        self._fh = None
        self._bytes_written = 0
        #: total records accepted since construction — the ring is bounded,
        #: so long-horizon growth accounting needs the unclipped count
        self.total_emitted = 0
        self._local = threading.local()

    # ---- configuration ----------------------------------------------------------
    def configure(
        self,
        enabled: Optional[bool] = None,
        path: Optional[str] = None,
        max_bytes: Optional[int] = None,
        max_files: Optional[int] = None,
        ring_size: Optional[int] = None,
    ) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if max_bytes is not None:
                self.max_bytes = max(4096, int(max_bytes))
            if max_files is not None:
                self.max_files = max(1, int(max_files))
            if ring_size is not None:
                self._ring = deque(self._ring, maxlen=max(16, int(ring_size)))
            if path is not None and path != self.path:
                self._close_file()
                self.path = path or None

    def reset(self) -> None:
        """Drop the ring and close the file (tests, bench phase resets)."""
        with self._lock:
            self._ring.clear()
            self._close_file()

    def close(self) -> None:
        with self._lock:
            self._close_file()

    # ---- User-Task-ID correlation (thread-local) --------------------------------
    @contextlib.contextmanager
    def task_scope(self, task_id: str, operation: Optional[str] = None):
        """Events emitted on this thread inside the scope carry ``taskId``
        (and ``operation`` as a fallback) without every producer having to
        thread the async-protocol id through its signature."""
        prev = getattr(self._local, "scope", None)
        self._local.scope = (task_id, operation)
        try:
            yield
        finally:
            self._local.scope = prev

    def current_task_id(self) -> Optional[str]:
        scope = getattr(self._local, "scope", None)
        return scope[0] if scope else None

    # ---- trace-id correlation (thread-local) ------------------------------------
    @contextlib.contextmanager
    def trace_scope(self, trace_id: Optional[str]):
        """Events emitted on this thread inside the scope carry ``traceId``
        — the end-to-end correlation id the HTTP layer mints per request
        (and re-enters on async worker threads), so one rebalance's journal
        records, spans, and executor batches all share one id.  ``None``
        is a no-op scope (callers never need to branch)."""
        prev = getattr(self._local, "trace", None)
        self._local.trace = trace_id if trace_id is not None else prev
        try:
            yield
        finally:
            self._local.trace = prev

    def current_trace_id(self) -> Optional[str]:
        return getattr(self._local, "trace", None)

    # ---- emission ---------------------------------------------------------------
    def emit(
        self,
        kind: str,
        severity: str = "INFO",
        operation: Optional[str] = None,
        task_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        **payload: Any,
    ) -> None:
        """Append one event.  No-op when disabled; never raises (a journal
        failure must not add a second failure to whatever is being
        journaled)."""
        if not self.enabled or kind in self.exclude_kinds:
            return
        scope = getattr(self._local, "scope", None)
        if task_id is None and scope:
            task_id = scope[0]
        if operation is None and scope:
            operation = scope[1]
        if trace_id is None:
            trace_id = getattr(self._local, "trace", None)
        rec: Dict[str, Any] = {
            "schema": SCHEMA,
            "ts": round(self.clock(), 3),
            "kind": kind,
            "severity": severity if severity in SEVERITIES else "INFO",
        }
        if operation:
            rec["operation"] = operation
        if task_id:
            rec["taskId"] = task_id
        if trace_id:
            rec["traceId"] = trace_id
        if payload:
            rec["payload"] = payload
        try:
            # CRC-framed for the file; the in-memory ring keeps the bare
            # record (readers, fingerprints and GET /events are unchanged)
            line = stamp_line(json.dumps(rec, default=str), compact=False)
        except Exception:  # pragma: no cover - defensive
            LOG.exception("event %s not serializable", kind)
            return
        with self._lock:
            self._ring.append(rec)
            self.total_emitted += 1
            if self.path:
                try:
                    self._write_line(line)  # cclint: disable=blocking-under-lock -- journal.events IS the file serializer (append order = ring order is the journal's invariant); the line is pre-rendered off-lock, only the ~µs append+flush runs under it
                except Exception:  # disk trouble must not kill the caller
                    LOG.exception("event journal write failed")
                    self._close_file()

    def _write_line(self, line: str) -> None:
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
            self._bytes_written = self._fh.tell()
        data = line + "\n"
        if self._bytes_written + len(data) > self.max_bytes:
            self._rotate()
        self._fh.write(data)
        self._fh.flush()
        self._bytes_written += len(data)

    def _rotate(self) -> None:
        """path → path.1 → … → path.(max_files-1); oldest dropped."""
        self._close_file()
        for i in range(self.max_files - 1, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            dst = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, dst)
        self._fh = open(self.path, "a")
        self._bytes_written = 0

    def _close_file(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:  # pragma: no cover - defensive
                pass
            self._fh = None
        self._bytes_written = 0

    # ---- readers ----------------------------------------------------------------
    def recent(
        self,
        since: Optional[float] = None,
        kind: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[dict]:
        """Ring snapshot, oldest first.  ``since``: only events with
        ``ts > since`` (incremental polling).  ``kind``: exact kind or a
        dotted-prefix family (``kind=executor`` matches ``executor.batch``).
        ``limit``: keep the newest N after filtering."""
        with self._lock:
            out = list(self._ring)
        if since is not None:
            out = [e for e in out if e["ts"] > since]
        if kind:
            prefix = kind + "."
            out = [
                e for e in out
                if e["kind"] == kind or e["kind"].startswith(prefix)
            ]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out


class CorruptJournalError(RuntimeError):
    """Mid-file corruption in a persisted event journal.  ``records``
    carries the trusted prefix (every good record before the damage) and
    ``line`` the non-empty-line index of the first bad record."""

    def __init__(self, path: str, line: int, records: List[dict]):
        super().__init__(
            f"event journal {path}: corrupt record at line {line} "
            f"({len(records)} trusted record(s) precede it)"
        )
        self.path = path
        self.line = line
        self.records = records


def load_records(path: str) -> List[dict]:
    """Read one persisted journal file back, verifying per-record CRCs
    (pre-CRC lines load as legacy).  A bad FINAL line — the torn write
    of a real crash — is dropped with a warning; a bad earlier line
    raises :class:`CorruptJournalError` (fail loudly, never silently
    skip damaged evidence mid-story)."""
    # binary read: bit rot may leave non-UTF-8 bytes — such a line must
    # classify as torn/corrupt, not crash the reader
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    records, bad, n_lines = scan_lines(lines)
    # the frame is transport, not content: hand back ring-shaped records
    records = [{k: v for k, v in r.items() if k != "crc"} for r in records]
    if bad:
        if bad == [n_lines - 1]:
            LOG.warning("event journal %s: dropping torn final record",
                        path)
        else:
            raise CorruptJournalError(path, bad[0], records[:bad[0]])
    return records


#: process-wide default (bootstrap reconfigures it from telemetry.events.*)
JOURNAL = EventJournal()


# module-level conveniences bound to the default instance -------------------------
def configure(enabled=None, path=None, max_bytes=None, max_files=None,
              ring_size=None) -> None:
    JOURNAL.configure(enabled, path, max_bytes, max_files, ring_size)


def enabled() -> bool:
    return JOURNAL.enabled


def emit(kind: str, severity: str = "INFO", operation: Optional[str] = None,
         task_id: Optional[str] = None, trace_id: Optional[str] = None,
         **payload: Any) -> None:
    JOURNAL.emit(kind, severity, operation, task_id, trace_id, **payload)


def recent(since: Optional[float] = None, kind: Optional[str] = None,
           limit: Optional[int] = None) -> List[dict]:
    return JOURNAL.recent(since, kind, limit)


def task_scope(task_id: str, operation: Optional[str] = None):
    return JOURNAL.task_scope(task_id, operation)


def trace_scope(trace_id: Optional[str]):
    return JOURNAL.trace_scope(trace_id)


def reset() -> None:
    JOURNAL.reset()

"""Structured tracing spans — the low-overhead timing spine every perf
claim hangs evidence on (round-5 VERDICT: the driver bench regressed
uninvestigated and ~2.4 s of north-star host time was untracked because
nothing in the request path attributed wall-clock to phases).

Design:

* **Thread-local span stacks.**  ``span("name")`` opens a child of the
  thread's innermost open span; closing computes the duration from
  ``time.perf_counter`` (monotonic) and attaches the record to its parent.
  Completed ROOT spans land in a bounded ring buffer
  (:func:`recent_roots` — surfaced via ``GET /state?verbose=true``).
* **Phase accumulator.**  Every span close also folds (path, duration)
  into a process-wide ``{path: (count, total_s)}`` table keyed by the
  '/'-joined ancestry, which :mod:`telemetry.profile` turns into the
  ``name -> {count, total_s, self_s}`` phase tree and the benchmark
  artifact.
* **Honest device attribution.**  ``device_span`` yields a handle whose
  ``block(x)`` synchronizes the card of every CUDA tensor in ``x``
  (``torch.cuda.synchronize``) so async launches cannot smear device
  time into whichever host phase happens to synchronize next.
* **Near-zero disabled path.**  When tracing is off, ``span()`` returns a
  shared no-op context manager before ANY allocation or string
  formatting — dynamic-name call sites pass the dynamic part via the
  ``sub=`` argument, which is only joined onto the name once the span is
  known to be live.

Thread-safe: stacks are thread-local; the ring buffer and accumulator
take one small lock per span CLOSE (opens are lock-free).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("telemetry")

_DEFAULT_RING_SIZE = 256


class SpanRecord:
    """One completed (or open) span.  Plain attributes, not a dataclass:
    span opens sit on request/search hot paths and ``__slots__`` keeps the
    per-span cost to one small object."""

    __slots__ = ("name", "path", "kind", "start_unix", "duration_s",
                 "attrs", "children", "trace_id", "_t0")

    def __init__(self, name: str, path: str, kind: str,
                 trace_id: Optional[str] = None):
        self.name = name
        self.path = path
        self.kind = kind                 # "host" | "device"
        self.start_unix = time.time()
        self.duration_s = 0.0
        self.attrs: Optional[Dict[str, Any]] = None
        self.children: List["SpanRecord"] = []
        #: end-to-end correlation id (the HTTP layer's X-Trace-Id scope);
        #: completed roots carrying one are offered to the trace store
        self.trace_id = trace_id
        self._t0 = time.perf_counter()

    def set(self, key: str, value: Any) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def to_json(self) -> dict:
        out = {
            "name": self.name,
            "startUnix": round(self.start_unix, 3),
            "durationSec": round(self.duration_s, 6),
        }
        if self.kind != "host":
            out["kind"] = self.kind
        if self.trace_id:
            out["traceId"] = self.trace_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out


class _NoopSpan:
    """Shared do-nothing stand-in for disabled tracing (one instance,
    no per-call allocation)."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, key: str, value: Any) -> None:
        pass

    def block(self, value):
        return value


NOOP = _NoopSpan()


class _LiveSpan:
    """Context manager driving one SpanRecord through the thread stack."""

    __slots__ = ("_tel", "_rec")

    def __init__(self, tel: "Telemetry", rec: SpanRecord):
        self._tel = tel
        self._rec = rec

    def __enter__(self) -> SpanRecord:
        return self._rec

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self._rec.set("error", exc_type.__name__)
        self._tel._close(self._rec)


class _DeviceSpan(_LiveSpan):
    """Device-call span: ``block(x)`` synchronizes inside the span so the
    measured duration covers the device work + transfer, not just the
    async dispatch."""

    __slots__ = ()

    def __enter__(self) -> "_DeviceSpan":
        return self

    def set(self, key: str, value: Any) -> None:
        self._rec.set(key, value)

    def block(self, value):
        import torch

        for dev in {t.device for t in _tensor_leaves(value) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        return value


def _tensor_leaves(value):
    """The tensors in ``value`` and in the tuples, lists and dicts it
    nests (what ``device_span.block`` waits for)."""
    import torch

    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensor_leaves(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensor_leaves(v)


class Telemetry:
    """Process-wide tracing state (constructor injection is overkill here:
    spans must meet across layers — HTTP handler, facade, engine — that
    never share a constructor path; the registry analog is the module
    singleton below, reconfigured once by bootstrap)."""

    def __init__(
        self,
        enabled: bool = False,
        ring_size: int = _DEFAULT_RING_SIZE,
        slow_span_log_s: float = 0.0,
    ):
        self.enabled = enabled
        self.ring_size = max(1, int(ring_size))
        self.slow_span_log_s = slow_span_log_s
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ring: List[SpanRecord] = []
        #: path -> [count, total_s] (profile.py derives self_s from the
        #: path hierarchy)
        self._agg: Dict[str, List[float]] = {}
        #: completed-ROOT-span sink for trace-id-carrying spans
        #: (telemetry/trace.TraceStore installs itself here); called
        #: outside the lock, exceptions swallowed — a broken sink must
        #: not take the span layer down with it
        self.root_sink = None

    # ---- configuration ----------------------------------------------------------
    def configure(
        self,
        enabled: Optional[bool] = None,
        ring_size: Optional[int] = None,
        slow_span_log_s: Optional[float] = None,
    ) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if ring_size is not None:
            # _finish() reads ring_size under the lock when trimming the
            # ring — the resize must not interleave with a trim
            with self._lock:
                self.ring_size = max(1, int(ring_size))
                del self._ring[: -self.ring_size]
        if slow_span_log_s is not None:
            self.slow_span_log_s = float(slow_span_log_s)

    def reset(self) -> None:
        """Drop completed spans + aggregates (tests, bench phase resets).
        Open spans on other threads keep their stacks."""
        with self._lock:
            self._ring.clear()
            self._agg.clear()

    # ---- trace-id correlation (thread-local) ------------------------------------
    @contextlib.contextmanager
    def trace_scope(self, trace_id: Optional[str]):
        """Spans opened on this thread inside the scope carry the trace id
        (and completed roots flow to the installed trace store).  ``None``
        keeps whatever scope is already active (no-op nesting)."""
        prev = getattr(self._local, "trace_id", None)
        self._local.trace_id = trace_id if trace_id is not None else prev
        try:
            yield
        finally:
            self._local.trace_id = prev

    def current_trace_id(self) -> Optional[str]:
        return getattr(self._local, "trace_id", None)

    # ---- span lifecycle ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, sub: Optional[str] = None, kind: str = "host"):
        """Open a span.  ``sub`` carries a dynamic name component that is
        only joined when tracing is live, so disabled call sites never pay
        for string formatting."""
        if not self.enabled:
            return NOOP
        if sub:
            name = f"{name}.{sub}"
        st = self._stack()
        path = f"{st[-1].path}/{name}" if st else name
        rec = SpanRecord(name, path, kind,
                         getattr(self._local, "trace_id", None))
        st.append(rec)
        return _LiveSpan(self, rec)

    def device_span(self, name: str, sub: Optional[str] = None):
        """Span for a device call; ``.block(x)`` synchronizes inside it so
        device vs host time is attributed honestly.  Disabled: the shared
        no-op (``block`` passes through without synchronizing)."""
        if not self.enabled:
            return NOOP
        if sub:
            name = f"{name}.{sub}"
        st = self._stack()
        path = f"{st[-1].path}/{name}" if st else name
        rec = SpanRecord(name, path, "device",
                         getattr(self._local, "trace_id", None))
        st.append(rec)
        return _DeviceSpan(self, rec)

    def annotate(self, key: str, value: Any) -> None:
        """Attach an attribute to the innermost open span (no-op when
        disabled or outside any span) — e.g. the User-Task-ID the HTTP
        layer only learns after task submission."""
        if not self.enabled:
            return
        st = getattr(self._local, "stack", None)
        if st:
            st[-1].set(key, value)

    def current_span(self) -> Optional[SpanRecord]:
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    def _close(self, rec: SpanRecord) -> None:
        rec.duration_s = time.perf_counter() - rec._t0
        st = self._stack()
        # tolerate a mid-span configure(enabled=False): close whatever is
        # open without corrupting the stack
        while st and st[-1] is not rec:
            st.pop()
        if st:
            st.pop()
        if st:
            st[-1].children.append(rec)
        with self._lock:
            ent = self._agg.get(rec.path)
            if ent is None:
                self._agg[rec.path] = [1, rec.duration_s]
            else:
                ent[0] += 1
                ent[1] += rec.duration_s
            if not st:  # root span completed
                self._ring.append(rec)
                del self._ring[: -self.ring_size]
        if not st and rec.trace_id is not None and self.root_sink is not None:
            try:
                self.root_sink(rec)
            except Exception:  # pragma: no cover - defensive
                LOG.exception("trace root sink failed")
        if self.slow_span_log_s and rec.duration_s >= self.slow_span_log_s:
            LOG.warning(
                "slow span %s: %.3fs (threshold %.3fs)",
                rec.path, rec.duration_s, self.slow_span_log_s,
            )

    # ---- readers ----------------------------------------------------------------
    def recent_roots(self, n: int = 32) -> List[dict]:
        with self._lock:
            roots = self._ring[-n:]
        return [r.to_json() for r in reversed(roots)]

    def aggregates(self) -> Dict[str, List[float]]:
        """{path: [count, total_s]} snapshot (profile.py's input)."""
        with self._lock:
            return {k: list(v) for k, v in self._agg.items()}


#: process-wide default (bootstrap reconfigures it from the telemetry.* keys)
TELEMETRY = Telemetry()


# module-level conveniences bound to the default instance -------------------------
def configure(enabled=None, ring_size=None, slow_span_log_s=None) -> None:
    TELEMETRY.configure(enabled, ring_size, slow_span_log_s)


def enabled() -> bool:
    return TELEMETRY.enabled


def span(name: str, sub: Optional[str] = None):
    return TELEMETRY.span(name, sub)


def device_span(name: str, sub: Optional[str] = None):
    return TELEMETRY.device_span(name, sub)


def annotate(key: str, value: Any) -> None:
    TELEMETRY.annotate(key, value)


def recent_roots(n: int = 32) -> List[dict]:
    return TELEMETRY.recent_roots(n)


def reset() -> None:
    TELEMETRY.reset()


def traced(name: str):
    """Decorator form: ``@traced("analyzer.finalize")``."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrap(*args, **kwargs):
            if not TELEMETRY.enabled:
                return fn(*args, **kwargs)
            with TELEMETRY.span(name):
                return fn(*args, **kwargs)

        return wrap

    return deco

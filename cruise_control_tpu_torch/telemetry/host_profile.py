"""Host observatory — the always-on sampling profiler (ISSUE 18; the
host-side twin of the kernel observatory's :mod:`kernel_budget` and the
mesh observatory's :mod:`mesh_budget`).

The device observatories answer "where did the accelerator's time go";
this module answers the complement: **where did the host's threads spend
theirs**.  A daemon thread walks :func:`sys._current_frames` every
``telemetry.host.sample.interval.ms`` and folds each thread's stack into
a semicolon-joined frame path, aggregated per **thread role** — the
stable operational identity of the thread (``http-worker``,
``executor-drive``, ``detector``, ``precompute``, ``slo-tick``, …)
rather than its ephemeral name.  Two stores receive every sample:

* the **window** — a bounded rolling aggregate (counts decay by halving
  when the window fills), feeding the ``cc_host_*`` exposition families
  and the flight recorder's ``hostProfile`` block, and
* an optional **capture** — :meth:`HostProfiler.arm` opens a window of
  the next N sampling ticks, after which the aggregate is queued for an
  off-thread build into a ``cc-tpu-host-profile/1`` artifact (folded
  lines render directly in any flame-graph tool).  The build rides the
  SLO observatory's maintenance tick via :meth:`parse_pending` — never a
  request thread — and journals ``profiler.host.parsed``, mirroring the
  kernel capture ladder (``GET /profile/host``: 404 → arm → 202 → 200).

Overhead discipline: the sampler is one ``sys._current_frames`` call +
a pure-python fold per thread per tick; at the default 50 ms interval
that is well under the 1% ceiling ``bench.py`` gates
(``host_profiler_overhead_pct``).  The profiler never unwinds C frames
and never touches the threads it observes — ``sys._current_frames``
returns a consistent point-in-time dict without stopping the world.

Determinism: the sim and the tests drive :meth:`HostProfiler.ingest`
with synthetic ``(thread_name, folded_stack)`` streams instead of the
wall-clock sampler, and :meth:`scoped` swaps in a virtual clock and a
deterministic capture-id factory, so journal fingerprints stay
bit-stable (the scenario/soak drivers never start the sampler thread).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger(__name__)

SCHEMA = "cc-tpu-host-profile/1"

# ---- thread-role mapping ---------------------------------------------------------
#: longest-prefix-wins map from thread NAME to operational ROLE.  The
#: ``Thread-`` entry catches ThreadingHTTPServer's per-request handler
#: threads (stdlib default names); ``user-task`` threads re-enter the
#: request deadline scope and drive proposal execution, so they read as
#: ``executor-drive`` — that is where heal wall-clock goes.
ROLE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("cc-http", "http-worker"),
    ("Thread-", "http-worker"),
    ("user-task", "executor-drive"),
    ("anomaly-detector", "detector"),
    ("proposal-precompute", "precompute"),
    ("cc-slo-engine", "slo-tick"),
    ("cc-flight-recorder", "recorder"),
    ("metric-fetcher-manager", "fetcher"),
    ("whatif-proactive", "proactive"),
    ("MainThread", "main"),
)

#: the sampler's own thread — excluded from every sample
SELF_THREAD_NAME = "cc-host-profiler"

_MAX_DEPTH = 48
_MAX_STACKS_PER_ROLE = 512
_WINDOW_MAX_SAMPLES = 4096
_MAX_PENDING_PARSES = 4
_TOP_STACKS = 25
_OVERFLOW_STACK = "(folded: overflow)"

_IDLE = "IDLE"
_ARMED = "ARMED"


def role_for(thread_name: str) -> str:
    """Map a thread name onto its operational role (``other`` when no
    prefix matches — new subsystems show up there until they are named)."""
    for prefix, role in ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            return role
    return "other"


def _short_file(filename: str) -> str:
    """``/…/cruise_control_tpu/server/http_server.py`` →
    ``server/http_server`` (package-relative, extensionless) so folded
    stacks are stable across checkouts and readable in flame graphs."""
    norm = filename.replace("\\", "/")
    if norm.endswith(".py"):
        norm = norm[:-3]
    marker = "/cruise_control_tpu/"
    idx = norm.rfind(marker)
    if idx >= 0:
        return norm[idx + len(marker):]
    return norm.rsplit("/", 1)[-1]


def fold_stack(frame, max_depth: int = _MAX_DEPTH) -> str:
    """Fold a live frame into root-first ``file:function;file:function``
    (the flame-graph folded format, minus the trailing count)."""
    parts: List[str] = []
    while frame is not None and len(parts) < max_depth:
        code = frame.f_code
        parts.append(f"{_short_file(code.co_filename)}:{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts) if parts else "(empty)"


class _StackAgg:
    """Bounded per-role folded-stack aggregate: {role: {stack: count}} +
    per-role sample counts and thread idents.  NOT thread-safe — callers
    hold the profiler lock."""

    def __init__(self) -> None:
        self.stacks: Dict[str, Dict[str, int]] = {}
        self.samples: Dict[str, int] = {}
        self.threads: Dict[str, set] = {}
        self.total = 0

    def record(self, role: str, folded: str, ident: Optional[int]) -> None:
        per = self.stacks.setdefault(role, {})
        if folded not in per and len(per) >= _MAX_STACKS_PER_ROLE:
            folded = _OVERFLOW_STACK  # bounded: the tail folds together
        per[folded] = per.get(folded, 0) + 1
        self.samples[role] = self.samples.get(role, 0) + 1
        if ident is not None:
            self.threads.setdefault(role, set()).add(ident)
        self.total += 1

    def decay(self) -> None:
        """Halve every count and drop zeros — the rolling-window trick
        that bounds memory AND keeps recent behavior dominant."""
        for role, per in list(self.stacks.items()):
            kept = {s: c // 2 for s, c in per.items() if c // 2 > 0}
            if kept:
                self.stacks[role] = kept
            else:
                del self.stacks[role]
        self.samples = {r: max(0, c // 2) for r, c in self.samples.items()}
        self.total = sum(
            sum(per.values()) for per in self.stacks.values())

    def summary(self, top: int = 5) -> dict:
        """The flight recorder's ``hostProfile.window`` block."""
        roles = {}
        for role in sorted(self.stacks):
            per = self.stacks[role]
            ranked = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))
            roles[role] = {
                "samples": self.samples.get(role, 0),
                "distinctStacks": len(per),
                "topStacks": [
                    {"stack": s, "count": c} for s, c in ranked[:top]
                ],
            }
        return {"totalSamples": self.total, "roles": roles}


class HostProfiler:
    """Always-on host sampling profiler + on-demand capture ladder.

    State machine (one capture at a time)::

        IDLE --arm()--> ARMED --N sampling ticks--> IDLE (+ pending build)

    The sampler daemon calls :meth:`sample_once` on the wall clock; tests
    and the sim call :meth:`ingest` with synthetic streams.  Artifact
    builds run in :meth:`parse_pending` on the SLO maintenance tick,
    mirroring :class:`~cruise_control_tpu_torch.telemetry.kernel_budget.CaptureManager`.
    """

    def __init__(self, enabled: bool = True, interval_ms: float = 50.0,
                 default_samples: int = 100,
                 clock: Optional[Callable[[], float]] = None,
                 id_factory: Optional[Callable[[], str]] = None):
        self.enabled = enabled
        self.interval_ms = max(1.0, float(interval_ms))
        self.default_samples = max(1, int(default_samples))
        self._clock = clock or time.time
        self._seq = 0
        self._id_factory = id_factory or self._next_id
        self._lock = threading.Lock()
        # always-on rolling window
        self._window = _StackAgg()
        self.lifetime_samples: Dict[str, int] = {}
        self.ticks = 0
        # capture state
        self._state = _IDLE
        self._capture_id: Optional[str] = None
        self._reason = ""
        self._samples_requested = 0
        self._samples_seen = 0
        self._started = 0.0
        self._capture: Optional[_StackAgg] = None
        #: capture aggregates waiting for an off-thread artifact build
        self._pending: List[Tuple[_StackAgg, dict]] = []
        self._parsing = 0
        self._latest: Optional[dict] = None
        self.captures = 0
        self.parse_failures = 0
        # sampler thread
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _next_id(self) -> str:
        self._seq += 1  # cclint: disable=lock-discipline -- only reachable via self._id_factory, whose call site (arm) holds self._lock
        return f"host-capture-{self._seq}"

    # ---- configuration ----------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  interval_ms: Optional[float] = None,
                  default_samples: Optional[int] = None,
                  clock: Optional[Callable[[], float]] = None,
                  id_factory: Optional[Callable[[], str]] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if interval_ms is not None:
                self.interval_ms = max(1.0, float(interval_ms))
            if default_samples is not None:
                self.default_samples = max(1, int(default_samples))
            if clock is not None:
                self._clock = clock
            if id_factory is not None:
                self._id_factory = id_factory

    def reset(self) -> None:
        """Drop all aggregates and capture state (tests).  The sampler
        thread, if running, keeps running — it samples into the fresh
        window."""
        with self._lock:
            self._window = _StackAgg()
            self.lifetime_samples = {}
            self.ticks = 0
            self._state = _IDLE
            self._capture_id = None
            self._capture = None
            self._pending = []
            self._latest = None
            self._seq = 0
            self.captures = 0
            self.parse_failures = 0

    @contextlib.contextmanager
    def scoped(self, clock: Optional[Callable[[], float]] = None,
               id_factory: Optional[Callable[[], str]] = None):
        """Deterministic clock / capture-id factory for one scenario run
        (journal fingerprints stay bit-stable), reset + restore on exit."""
        with self._lock:
            prev_clock, prev_factory = self._clock, self._id_factory
            if clock is not None:
                self._clock = clock
            if id_factory is not None:
                self._id_factory = id_factory
        try:
            yield self
        finally:
            self.reset()
            with self._lock:
                self._clock, self._id_factory = prev_clock, prev_factory

    # ---- the sampler ------------------------------------------------------------
    def ensure_started(self) -> bool:
        """Start the sampler daemon (idempotent; no-op when disabled).
        Returns True when the thread is running after the call."""
        with self._lock:
            if not self.enabled:
                return False
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=SELF_THREAD_NAME)
            self._thread.start()
            return True

    def stop(self, timeout_s: float = 2.0) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
            self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout_s)

    def _run(self) -> None:
        stop = self._stop
        while not stop.wait(self.interval_ms / 1000.0):
            try:
                self.sample_once()
            except Exception:  # the sampler must outlive any one bad tick
                LOG.exception("host-profile sampling tick failed")

    def sample_once(self) -> int:
        """One sampling tick over the live interpreter: fold every
        thread's current stack (sampler thread excluded).  Returns the
        number of thread stacks recorded."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        pairs: List[Tuple[str, str, Optional[int]]] = []
        for ident, frame in frames.items():
            name = names.get(ident, "other")
            if name == SELF_THREAD_NAME:
                continue
            pairs.append((name, fold_stack(frame), ident))
        del frames  # drop the frame references before aggregating
        self._ingest(pairs)
        return len(pairs)

    def ingest(self, samples: List[Tuple[str, str]]) -> None:
        """Synthetic frame-stream entry point (tests / fixtures): one
        tick's worth of ``(thread_name, folded_stack)`` pairs."""
        self._ingest([(name, folded, None) for name, folded in samples])

    def _ingest(self, pairs: List[Tuple[str, str, Optional[int]]]) -> None:
        done_meta: Optional[dict] = None
        done_agg: Optional[_StackAgg] = None
        with self._lock:
            if not self.enabled:
                return
            self.ticks += 1
            for name, folded, ident in pairs:
                role = role_for(name)
                self._window.record(role, folded, ident)
                self.lifetime_samples[role] = \
                    self.lifetime_samples.get(role, 0) + 1
            if self._window.total >= _WINDOW_MAX_SAMPLES:
                self._window.decay()
            if self._state == _ARMED and self._capture is not None:
                for name, folded, ident in pairs:
                    self._capture.record(role_for(name), folded, ident)
                self._samples_seen += 1
                if self._samples_seen >= self._samples_requested:
                    done_agg, self._capture = self._capture, None
                    done_meta = {
                        "id": self._capture_id,
                        "reason": self._reason,
                        "samplesRequested": self._samples_requested,
                        "samplesCollected": self._samples_seen,
                        "intervalMs": self.interval_ms,
                        "startedUnix": round(self._started, 3),
                        "wallS": round(
                            max(0.0, self._clock() - self._started), 3),
                    }
                    self._pending.append((done_agg, done_meta))
                    while len(self._pending) > _MAX_PENDING_PARSES:
                        _agg, dropped = self._pending.pop(0)
                        LOG.warning(
                            "host-profile parse queue full; dropped "
                            "capture %s", dropped.get("id"))
                    self._state = _IDLE
                    self._capture_id = None

    # ---- arming (the /profile/host ladder) --------------------------------------
    def arm(self, samples: Optional[int] = None,
            reason: str = "api") -> dict:
        """Open a capture over the next ``samples`` sampling ticks.
        Idempotent while a capture is in flight (current state returned
        either way)."""
        with self._lock:
            if self.enabled and self._state == _IDLE:
                self._state = _ARMED
                self._capture_id = self._id_factory()
                self._reason = reason
                self._samples_requested = max(
                    1, int(samples) if samples else self.default_samples)
                self._samples_seen = 0
                self._started = self._clock()
                self._capture = _StackAgg()
        return self.state()

    def state(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "state": self._state,
                "captureId": self._capture_id,
                "samplesRequested": self._samples_requested,
                "samplesCollected": self._samples_seen,
                "intervalMs": self.interval_ms,
                "samplerAlive": (self._thread is not None
                                 and self._thread.is_alive()),
                "pendingParses": len(self._pending),
                "activeParses": self._parsing,
                "captures": self.captures,
                "parseFailures": self.parse_failures,
                "windowSamples": self._window.total,
            }

    # ---- off-thread artifact build (SLO maintenance tick) ------------------------
    def parse_pending(self, max_parses: int = 1) -> int:
        """Build up to ``max_parses`` queued capture aggregates into
        artifacts.  Rides the SLO observatory's maintenance tick (like
        ``kernel_budget.CAPTURE.parse_pending``), never a request
        thread.  Returns the number built; never raises."""
        from cruise_control_tpu_torch.telemetry import events

        done = 0
        while done < max_parses:
            with self._lock:
                if not self._pending:
                    return done
                agg, meta = self._pending.pop(0)
                self._parsing += 1
            try:
                artifact = self._build_artifact(agg, meta)
                with self._lock:
                    self._latest = artifact
                    self.captures += 1
                events.emit(
                    "profiler.host.parsed",
                    captureId=meta["id"],
                    samples=meta["samplesCollected"],
                    stacks=artifact["totalSamples"],
                    roles=len(artifact["roles"]),
                    reason=meta["reason"],
                )
            except Exception:
                with self._lock:
                    self.parse_failures += 1
                LOG.exception("host-profile artifact build failed for "
                              "capture %s", meta.get("id"))
            finally:
                with self._lock:
                    self._parsing -= 1
            done += 1
        return done

    def _build_artifact(self, agg: _StackAgg, meta: dict) -> dict:
        roles = {}
        folded: List[str] = []
        for role in sorted(agg.stacks):
            per = agg.stacks[role]
            role_samples = agg.samples.get(role, 0)
            ranked = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))
            roles[role] = {
                "samples": role_samples,
                "threads": len(agg.threads.get(role, ())),
                "distinctStacks": len(per),
                "topStacks": [
                    {
                        "stack": s,
                        "count": c,
                        "share": round(c / role_samples, 4)
                        if role_samples else 0.0,
                    }
                    for s, c in ranked[:_TOP_STACKS]
                ],
            }
            # flame-graph folded lines, role as the root frame
            folded.extend(f"{role};{s} {c}" for s, c in ranked)
        return {
            "schema": SCHEMA,
            "generatedUnix": round(self._clock(), 3),
            "capture": dict(meta),
            "totalSamples": agg.total,
            "roles": roles,
            "folded": folded,
        }

    # ---- readers ----------------------------------------------------------------
    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._latest

    def summary(self) -> dict:
        """The ``/diagnostics`` + flight-recorder ``hostProfile`` block:
        capture-ladder state, the rolling window's top stacks per role,
        and the latest built artifact."""
        out = self.state()
        with self._lock:
            out["window"] = self._window.summary()
            out["latest"] = self._latest
        return out

    def families(self) -> List[tuple]:
        """``extra_families`` rows for the Prometheus exposition:
        lifetime samples per role (counter — window counts decay, these
        never do) + distinct window stacks per role."""
        with self._lock:
            lifetime = dict(self.lifetime_samples)
            window_stacks = {
                role: len(per) for role, per in self._window.stacks.items()
            }
        if not lifetime:
            return []
        return [
            ("cc_host_samples_total", "counter",
             "Host sampling-profiler thread samples per role (lifetime)",
             [({"role": r}, float(c))
              for r, c in sorted(lifetime.items())]),
            ("cc_host_stacks", "gauge",
             "Distinct folded stacks in the profiler's rolling window, "
             "per role",
             [({"role": r}, float(c))
              for r, c in sorted(window_stacks.items())]),
        ]

    def install_gauges(self, registry) -> None:
        registry.gauge("host.profile.samples",
                       lambda: float(sum(self.lifetime_samples.values())))
        registry.gauge("host.profile.parses.pending",
                       lambda: float(len(self._pending)))
        registry.gauge("host.profile.captures",
                       lambda: float(self.captures))


#: process-wide default (bootstrap reconfigures it from the
#: telemetry.host.* keys and starts the sampler; tests drive ingest())
PROFILER = HostProfiler()


# module-level conveniences bound to the default instance -------------------------
def configure(**kwargs) -> None:
    PROFILER.configure(**kwargs)


def ensure_started() -> bool:
    return PROFILER.ensure_started()


def arm(samples: Optional[int] = None, reason: str = "api") -> dict:
    return PROFILER.arm(samples=samples, reason=reason)


def parse_pending(max_parses: int = 1) -> int:
    return PROFILER.parse_pending(max_parses)


def latest() -> Optional[dict]:
    return PROFILER.latest()


def install_gauges(registry) -> None:
    PROFILER.install_gauges(registry)


def reset() -> None:
    PROFILER.reset()

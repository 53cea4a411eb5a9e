"""Flight recorder — retained time series + event journal for postmortems.

Upstream operators diagnose a sick cluster from *recorded history*
(Dropwizard time series + ``AnomalyDetectorState``), not a point-in-time
scrape.  ``GET /metrics`` answers "what is happening"; this module answers
"what happened in the last ten minutes": a background thread samples the
shared :class:`~cruise_control_tpu_torch.utils.metrics.MetricRegistry` into
bounded ring-buffer series, merges the anomaly-detector journal into the
timeline, and renders everything as one crash-readable JSON artifact —
served live on ``GET /diagnostics`` and dumped to disk when a self-healing
fix FAILS (the moment an operator will want exactly this file).

Sampling rules per registry family:

* gauge    → ``gauge:<name>`` (numeric results only; error strings skipped)
* counter  → ``rate:<name>`` (delta / dt, events per second)
* meter    → ``rate:<name>``
* timer    → ``p99:<name>`` + ``rate:<name>.count``
* extra cumulative sources (e.g. device-stats compile totals) → ``rate:``

The first sample only establishes counter baselines; rates appear from the
second sample on.  Memory is bounded: ``retention`` points per series in a
``deque(maxlen=...)``; a series that stops appearing simply stops growing.

Artifact schema (``SCHEMA``):

    {
      "schema": "cc-tpu-flight-recorder/1",
      "generated_unix": <float>,
      "interval_s": <float>,
      "retention": <int>,
      "series": {"<kind:name>": {"kind": ..., "points": [[unix, v], ...]}},
      "events": [<anomaly journal records, merged, time-ordered>],
      "journal": [<cc-tpu-events/1 decision records, when attached>],
      "traces": [<trace.TraceStore.index() summaries, when attached>],
      "deviceStats": {<device_stats.MONITOR.summary()>},
      "kernelBudget": {<kernel_budget.CAPTURE.summary()>, when attached},
      "meshBudget": {<mesh_budget.MESH.summary()>, when attached},
      "hostProfile": {<host_profile.PROFILER.summary()>, when attached},
      "lockContention": {<locks.CONTENTION.snapshot()>, when attached},
      "criticalPath": {<critical_path.STORE.snapshot()>, when attached},
      ...extra keys the dump path merges in ("dumpReason")
    }

Thread-safe: the sampler thread, ``GET /diagnostics`` handlers, and the
detector's dump-on-failure all synchronize on one lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from cruise_control_tpu_torch.utils.logging import get_logger
from cruise_control_tpu_torch.utils.metrics import MetricRegistry

LOG = get_logger("recorder")

SCHEMA = "cc-tpu-flight-recorder/1"

_DEFAULT_INTERVAL_S = 5.0
_DEFAULT_RETENTION = 720  # one hour at the default interval


class FlightRecorder:
    """Samples ``registry`` every ``interval_s`` into ring-buffer series.

    ``journal_source``: callable returning the anomaly journal (a list of
    dicts with a ``timeMs`` key) — merged time-ordered into the artifact.
    ``extra_sources``: callables returning ``{name: cumulative_value}``;
    sampled as rates like counters (device-stats compile totals ride this).
    ``dump_dir``: where :meth:`dump` writes incident artifacts (created on
    first use; ``None`` disables dumping).
    """

    def __init__(
        self,
        registry: MetricRegistry,
        interval_s: float = _DEFAULT_INTERVAL_S,
        retention: int = _DEFAULT_RETENTION,
        journal_source: Optional[Callable[[], List[dict]]] = None,
        extra_sources: Optional[
            Sequence[Callable[[], Dict[str, float]]]] = None,
        dump_dir: Optional[str] = None,
        device_stats_source: Optional[Callable[[], dict]] = None,
        events_source: Optional[Callable[[], List[dict]]] = None,
        traces_source: Optional[Callable[[], List[dict]]] = None,
        kernel_budget_source: Optional[Callable[[], dict]] = None,
        mesh_budget_source: Optional[Callable[[], dict]] = None,
        host_profile_source: Optional[Callable[[], dict]] = None,
        contention_source: Optional[Callable[[], dict]] = None,
        critical_path_source: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry
        self.interval_s = max(0.01, float(interval_s))
        self.retention = max(2, int(retention))
        self.journal_source = journal_source
        self.extra_sources = list(extra_sources or ())
        self.dump_dir = dump_dir
        self.device_stats_source = device_stats_source
        #: telemetry/events journal reader (cc-tpu-events/1 records) —
        #: merged into the artifact as `journal` so an incident dump
        #: carries the decision record alongside the numbers
        self.events_source = events_source
        #: telemetry/trace.TraceStore.index — per-trace summaries merged
        #: into the artifact as `traces` (an incident dump names the
        #: correlation ids an operator can pull via GET /trace?id=)
        self.traces_source = traces_source
        #: telemetry/kernel_budget.CAPTURE.summary — the measured device-
        #: kernel budget (latest parsed capture + capture state) merged as
        #: `kernelBudget`, beside deviceStats.deviceCost's estimates
        self.kernel_budget_source = kernel_budget_source
        #: telemetry/mesh_budget.MESH.summary — the mesh observatory's
        #: collective/transfer/gap decomposition + replication audit,
        #: merged as `meshBudget`
        self.mesh_budget_source = mesh_budget_source
        #: telemetry/host_profile.PROFILER.summary — the host sampling
        #: profiler's rolling window + latest capture, merged as
        #: `hostProfile` (where were the host threads when it broke)
        self.host_profile_source = host_profile_source
        #: utils/locks.CONTENTION.snapshot — per-named-lock wait/hold
        #: totals, merged as `lockContention`
        self.contention_source = contention_source
        #: telemetry/critical_path.STORE.snapshot — per-endpoint request
        #: phase decompositions, merged as `criticalPath`
        self.critical_path_source = critical_path_source
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._prev_cum: Dict[str, float] = {}
        self._prev_t: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- lifecycle --------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:  # a broken gauge must not kill sampling
                    LOG.exception("flight-recorder sample failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cc-flight-recorder")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None

    # ---- sampling ---------------------------------------------------------------
    def _record(self, key: str, t: float, value: float) -> None:
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = deque(maxlen=self.retention)
        ring.append((round(t, 3), value))

    def _rate(self, key: str, t: float, cum: float, dt: float) -> None:
        prev = self._prev_cum.get(key)
        self._prev_cum[key] = cum
        if prev is None or dt <= 0:
            return  # first sight establishes the baseline only
        self._record(f"rate:{key}", t, round((cum - prev) / dt, 6))

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sampling pass (the background loop calls this; tests and
        ``artifact()`` call it directly with a pinned ``now``)."""
        now = time.time() if now is None else now
        snap = self.registry.snapshot()
        extras = []
        for src in self.extra_sources:
            try:
                extras.append(src())
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder extra source failed")
        with self._lock:
            dt = (now - self._prev_t) if self._prev_t is not None else 0.0
            self._prev_t = now
            for name, v in snap["gauges"].items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue  # error strings are journal material, not points
                self._record(f"gauge:{name}", now, float(v))
            for name, c in snap["counters"].items():
                self._rate(name, now, float(c["count"]), dt)
            for name, m in snap["meters"].items():
                self._rate(name, now, float(m["count"]), dt)
            for name, t_ in snap["timers"].items():
                self._record(f"p99:{name}", now, float(t_["p99Sec"]))
                self._rate(f"{name}.count", now, float(t_["count"]), dt)
            for name, h in snap.get("histograms", {}).items():
                self._rate(f"{name}.count", now, float(h["count"]), dt)
            for cum_map in extras:
                for name, v in cum_map.items():
                    self._rate(name, now, float(v), dt)

    # ---- readers ----------------------------------------------------------------
    def series_snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                key: {"kind": key.split(":", 1)[0],
                      "points": [list(p) for p in ring]}
                for key, ring in sorted(self._series.items())
                if ring
            }

    def journal(self) -> List[dict]:
        if self.journal_source is None:
            return []
        try:
            events = list(self.journal_source())
        except Exception:  # pragma: no cover - defensive
            LOG.exception("flight-recorder journal source failed")
            return []
        return sorted(events, key=lambda e: e.get("timeMs", 0))

    def artifact(self, extra: Optional[dict] = None) -> dict:
        """The full ``cc-tpu-flight-recorder/1`` JSON artifact.  Takes one
        fresh sample first so the timeline always reaches "now"."""
        self.sample_once()
        out = {
            "schema": SCHEMA,
            "generated_unix": round(time.time(), 3),
            "interval_s": self.interval_s,
            "retention": self.retention,
            "series": self.series_snapshot(),
            "events": self.journal(),
        }
        if self.device_stats_source is not None:
            try:
                out["deviceStats"] = self.device_stats_source()
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder device-stats source failed")
        if self.events_source is not None:
            try:
                out["journal"] = list(self.events_source())
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder events source failed")
        if self.traces_source is not None:
            try:
                out["traces"] = list(self.traces_source())
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder traces source failed")
        if self.kernel_budget_source is not None:
            try:
                out["kernelBudget"] = self.kernel_budget_source()
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder kernel-budget source failed")
        if self.mesh_budget_source is not None:
            try:
                out["meshBudget"] = self.mesh_budget_source()
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder mesh-budget source failed")
        if self.host_profile_source is not None:
            try:
                out["hostProfile"] = self.host_profile_source()
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder host-profile source failed")
        if self.contention_source is not None:
            try:
                out["lockContention"] = self.contention_source()
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder contention source failed")
        if self.critical_path_source is not None:
            try:
                out["criticalPath"] = self.critical_path_source()
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder critical-path source failed")
        if extra:
            out.update(extra)
        return out

    def dump(self, reason: str) -> Optional[str]:
        """Write an incident artifact to ``dump_dir``; returns the path
        (None when dumping is disabled or the write fails — an incident
        dump must never add a second failure to the incident)."""
        if not self.dump_dir:
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flight-recorder-{int(time.time() * 1000)}.json",
            )
            art = self.artifact(extra={"dumpReason": reason})
            with open(path, "w") as f:
                json.dump(art, f, indent=1)
                f.write("\n")
        except Exception:
            LOG.exception("flight-recorder dump failed (reason=%s)", reason)
            return None
        LOG.warning("flight recorder dumped to %s (reason=%s)", path, reason)
        return path

"""SLO observatory — the fleet's service-level objectives, computed from
the journal and the metric registry (``cc-tpu-slo/1``).

Until now every SLO this system implicitly promised (heal-latency
percentiles, serve p99 under load, warm-replan duty cycle, zero unhandled
5xx, bounded growth) was hand-rolled per benchmark script or asserted
ad hoc in scenario tests.  This module makes them *first-class*: a
declarative registry of :class:`SloDef` entries, each computing one
measured value from the **event journal** (sliding window) plus the
**metric registry** snapshot, compared against an objective.

Two consumption modes, one definition:

* **Live** — :class:`SloEngine` evaluates periodically on a daemon
  thread, applies breach/recover **hysteresis** (N consecutive bad
  evaluations breach, M consecutive good recover — a single noisy window
  must not page anyone), journals ``slo.breach`` / ``slo.recovered``,
  fires ``on_breach`` hooks (bootstrap wires the flight-recorder dump —
  a breach self-captures its diagnostic context), and serves the current
  report on ``GET /slo``.
* **Offline / scenario** — :func:`evaluate_slos` is a pure function over
  a journal list (virtual clock, journal order), which
  ``sim.ScenarioResult.slo_report()`` and the future long-horizon soak
  consume — scenario gates stop re-deriving heal latency and duty cycle
  by hand.

Measurement sources degrade gracefully: each evaluator prefers the
registry (live timers/meters/gauges) and falls back to journal-derived
samples (``sim.http`` latencies, ``replan.end`` modes), returning
``None`` — NO_DATA, which never flips hysteresis state — when neither
side has evidence.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("slo")

SCHEMA = "cc-tpu-slo/1"

OK = "OK"
BREACHED = "BREACHED"
NO_DATA = "NO_DATA"

#: timeline fault kind → the anomaly type expected to heal it.  Faults
#: pair with fixes of their OWN type: a mild load perturbation the warm
#:  replanner absorbs silently must not charge its timestamp to the next
#: broker-failure heal (the mispairing a day-long soak makes obvious —
#: every leftover fault inflated a later fix by hours).  Serving-layer
#: chaos, operator events, and process crashes (healed by the recovery
#: path, not a detector fix) are not heal targets.
FAULT_ANOMALY_TYPES: Dict[str, str] = {
    "kill_broker": "BROKER_FAILURE",
    "rack_loss": "BROKER_FAILURE",
    "disk_failure": "DISK_FAILURE",
    "hot_partition_skew": "GOAL_VIOLATION",
    "perturb_broker_load": "GOAL_VIOLATION",
    "fail_partition": "GOAL_VIOLATION",
    # armed faults (kill_broker_mid_execution, flap_broker) pair via the
    # "kill_broker" marker the backend journals when the arm actually
    # FIRES — the arm-time marker may precede the death by hours (the
    # countdown only advances while an execution drives backend ticks)
}

#: kinds that start a heal-latency clock (kept for artifact consumers)
FAULT_KINDS = frozenset(FAULT_ANOMALY_TYPES)


# ---- journal-derived measurements ------------------------------------------------
def heal_latencies_ms(journal: Sequence[dict]) -> List[int]:
    """Heal-latency samples (virtual ms, journal order): one sample per
    ``detector.anomaly`` record with ``fixStarted`` — measured from the
    scripted fault that CAUSED the anomaly to the fix.

    Pairing is per anomaly type: a fix of type T consumes the LATEST
    unconsumed type-T fault marker at or before the type's first
    detection in the episode (earlier unconsumed type-T faults coalesced
    into the same anomaly — one rack loss is many broker deaths, one
    heal — or were absorbed without a detector fix, and are dropped).
    Absent fault markers (live deployments) the episode's first
    detection starts the clock.  Delayed fixes (cooldown / ongoing
    execution) charge their full wait either way."""
    samples: List[int] = []
    pending: Dict[str, List[int]] = {}
    first_seen: Dict[str, int] = {}
    for e in journal:
        kind = e.get("kind")
        p = e.get("payload", {})
        if kind == "sim.fault":
            t = p.get("virtualMs")
            atype = FAULT_ANOMALY_TYPES.get(p.get("fault", ""))
            if t is not None and atype is not None:
                pending.setdefault(atype, []).append(int(t))
        elif kind == "detector.anomaly":
            t = p.get("timeMs")
            if t is None:
                continue
            atype = p.get("anomalyType", "?")
            first_seen.setdefault(atype, int(t))
            if p.get("fixStarted"):
                start = first_seen.pop(atype, int(t))
                q = pending.get(atype)
                if q:
                    causes = [f for f in q if f <= start]
                    if causes:
                        start = causes[-1]
                        del q[:len(causes)]
                samples.append(max(0, int(t) - start))
            elif p.get("action") == "FIX_FAILED":
                # a failed fix CLOSES the episode: if the violation
                # persists the next detection re-seeds within one
                # detection interval, but a violation that self-resolved
                # (a hot spell reverting) must not leave a stale anchor
                # that charges the NEXT heal of this type with hours of
                # quiet (the mispairing a day-long soak exposed)
                first_seen.pop(atype, None)
    return samples


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (the Timer's convention); None when empty."""
    if not samples:
        return None
    s = sorted(samples)
    idx = min(int(q / 100.0 * len(s)), len(s) - 1)
    return float(s[idx])


def _http_latency_samples(journal: Sequence[dict], method: str,
                          cached: Optional[bool]) -> List[float]:
    """``sim.http`` latencyMs samples filtered by method and (for GETs)
    the response's cached marker; ``cached=None`` matches everything."""
    out = []
    for e in journal:
        if e.get("kind") != "sim.http":
            continue
        p = e.get("payload", {})
        if p.get("method") != method or p.get("latencyMs") is None:
            continue
        if cached is not None and bool(p.get("cached")) is not cached:
            continue
        if not (200 <= int(p.get("status") or 0) < 300):
            continue
        out.append(float(p["latencyMs"]))
    return out


def _timer_p99_ms(snapshot: Optional[dict], name: str) -> Optional[float]:
    if not snapshot:
        return None
    t = snapshot.get("timers", {}).get(name)
    if not t or not t.get("count"):
        return None
    return float(t["p99Sec"]) * 1000.0


def _meter_count(snapshot: Optional[dict], name: str) -> Optional[int]:
    if not snapshot:
        return None
    m = snapshot.get("meters", {}).get(name)
    return int(m["count"]) if m else None


# ---- the declarative registry ----------------------------------------------------
@dataclasses.dataclass
class SloInputs:
    """What every evaluator sees: the (windowed) journal slice, the
    registry snapshot (None in offline/scenario mode), and the horizon the
    slice covers (for per-minute rates)."""

    events: Sequence[dict]
    snapshot: Optional[dict]
    horizon_ms: float


@dataclasses.dataclass(frozen=True)
class SloDef:
    name: str
    description: str
    objective: float
    comparator: str          # "<=" or ">="
    unit: str
    evaluate: Callable[[SloInputs], Optional[float]]

    def ok(self, measured: Optional[float],
           objective: Optional[float] = None) -> Optional[bool]:
        if measured is None:
            return None
        target = self.objective if objective is None else objective
        if self.comparator == "<=":
            return measured <= target
        return measured >= target


def _heal_p(q: float):
    def ev(inp: SloInputs) -> Optional[float]:
        return percentile(heal_latencies_ms(inp.events), q)
    return ev


def _serve_cached_get_p99(inp: SloInputs) -> Optional[float]:
    live = _timer_p99_ms(inp.snapshot, "http.GET.proposals")
    if live is not None:
        return live
    return percentile(
        _http_latency_samples(inp.events, "GET", cached=True), 99)


def _serve_compute_p99(inp: SloInputs) -> Optional[float]:
    live = _timer_p99_ms(inp.snapshot, "http.POST.rebalance")
    if live is not None:
        return live
    samples = _http_latency_samples(inp.events, "POST", cached=None)
    samples += _http_latency_samples(inp.events, "GET", cached=False)
    return percentile(samples, 99)


def _warm_duty_cycle(inp: SloInputs) -> Optional[float]:
    warm = cold = 0
    for e in inp.events:
        if e.get("kind") != "replan.end":
            continue
        if e.get("payload", {}).get("mode") == "warm":
            warm += 1
        else:
            cold += 1
    total = warm + cold
    return (warm / total) if total else None


def _cache_hit_ratio(inp: SloInputs) -> Optional[float]:
    hit = _meter_count(inp.snapshot, "proposals.cache.hit")
    miss = _meter_count(inp.snapshot, "proposals.cache.miss")
    stale = _meter_count(inp.snapshot, "proposals.cache.stale")
    if hit is not None or miss is not None or stale is not None:
        total = (hit or 0) + (miss or 0) + (stale or 0)
        return (hit or 0) / total if total else None
    # journal fallback: served-from-cache ratio over scripted GETs
    served = cached = 0
    for e in inp.events:
        if e.get("kind") != "sim.http":
            continue
        p = e.get("payload", {})
        if p.get("method") != "GET" or p.get("endpoint") != "proposals":
            continue
        if not (200 <= int(p.get("status") or 0) < 300):
            continue
        served += 1
        if p.get("cached"):
            cached += 1
    return (cached / served) if served else None


def _unhandled_5xx(inp: SloInputs) -> Optional[float]:
    count = 0
    seen = False
    live = _meter_count(inp.snapshot, "http.unhandled.error")
    if inp.snapshot is not None:
        seen = True
        count += live or 0
    for e in inp.events:
        kind = e.get("kind")
        p = e.get("payload", {})
        if kind == "sim.http":
            seen = True
            if int(p.get("status") or 0) >= 500 \
                    and not p.get("retryAfter"):
                count += 1
        elif kind == "sim.http_storm":
            seen = True
            count += int(p.get("unhandled5xx") or 0)
    return float(count) if seen else None


def _sheds_missing_retry_after(inp: SloInputs) -> Optional[float]:
    count = 0
    seen = False
    for e in inp.events:
        kind = e.get("kind")
        p = e.get("payload", {})
        if kind == "sim.http":
            seen = True
            if int(p.get("status") or 0) in (429, 503) \
                    and not p.get("retryAfter"):
                count += 1
        elif kind == "sim.http_storm":
            seen = True
            count += int(p.get("shedMissingRetryAfter") or 0)
        elif kind == "http.request_shed":
            # live sheds all carry Retry-After by construction
            # (AdmissionController); their presence marks data as seen
            seen = True
    return float(count) if seen else None


def _journal_growth(inp: SloInputs) -> Optional[float]:
    if not inp.events or inp.horizon_ms <= 0:
        return None
    return len(inp.events) / (inp.horizon_ms / 60_000.0)


def _quarantine_ratio(inp: SloInputs) -> Optional[float]:
    """Quarantined fraction of ingested metric samples.  Live mode reads
    the validator's accepted/quarantined meters; journal mode sums the
    ``monitor.sample_quarantined`` batch payloads (which only cover
    batches that rejected something, so the scenario-mode ratio is the
    in-storm ratio — conservative, never understated)."""
    acc = _meter_count(inp.snapshot, "monitor.sample.accepted")
    quar = _meter_count(inp.snapshot, "monitor.sample.quarantined")
    if acc is not None or quar is not None:
        total = (acc or 0) + (quar or 0)
        return ((quar or 0) / total) if total else None
    a = q = 0
    seen = False
    for e in inp.events:
        if e.get("kind") != "monitor.sample_quarantined":
            continue
        seen = True
        p = e.get("payload", {})
        a += int(p.get("accepted") or 0)
        q += int(p.get("quarantined") or 0)
    return (q / (a + q)) if seen and (a + q) else None


def _live_buffer_mb(inp: SloInputs) -> Optional[float]:
    if not inp.snapshot:
        return None
    v = inp.snapshot.get("gauges", {}).get("jax.live.buffer.bytes")
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return None
    return float(v) / (1024.0 * 1024.0)


#: the SLO registry — the gate table ROADMAP item 5's soak consumes.
#: Objectives are defaults; telemetry.slo.objectives (or the per-call
#: overrides) re-target without touching code.
SLO_DEFS: List[SloDef] = [
    SloDef("heal.latency.p50.ms",
           "Median scripted-fault-to-fix latency (virtual clock)",
           600_000.0, "<=", "ms", _heal_p(50)),
    SloDef("heal.latency.p99.ms",
           "p99 scripted-fault-to-fix latency (virtual clock)",
           900_000.0, "<=", "ms", _heal_p(99)),
    SloDef("serve.cached_get.p99.ms",
           "Server-side cached GET /proposals p99",
           50.0, "<=", "ms", _serve_cached_get_p99),
    SloDef("serve.compute.p99.ms",
           "Compute-class serve p99 (POST /rebalance or cold GETs)",
           30_000.0, "<=", "ms", _serve_compute_p99),
    SloDef("replan.warm.duty.cycle",
           "Fraction of replans served warm (steady-state duty cycle)",
           0.5, ">=", "ratio", _warm_duty_cycle),
    SloDef("proposals.cache.hit.ratio",
           "Fraction of proposal serves answered from the warm cache",
           0.25, ">=", "ratio", _cache_hit_ratio),
    SloDef("http.unhandled.5xx",
           "Responses >=500 without backpressure guidance",
           0.0, "<=", "count", _unhandled_5xx),
    SloDef("http.shed.missing.retry.after",
           "Load sheds not carrying Retry-After (shed fairness)",
           0.0, "<=", "count", _sheds_missing_retry_after),
    SloDef("monitor.sample.quarantine.ratio",
           "Quarantined fraction of ingested metric samples",
           0.05, "<=", "ratio", _quarantine_ratio),
    SloDef("journal.growth.per.min",
           "Event-journal records per minute (bounded growth)",
           6_000.0, "<=", "events/min", _journal_growth),
    SloDef("memory.live.buffer.mb",
           "Live device-buffer footprint (bounded memory)",
           8_192.0, "<=", "MB", _live_buffer_mb),
]


def parse_objectives(raw: Optional[str]) -> Dict[str, float]:
    """``"name=value,name=value"`` → overrides dict (the
    telemetry.slo.objectives config key)."""
    out: Dict[str, float] = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, value = part.partition("=")
        out[name.strip()] = float(value)
    return out


# ---- reports --------------------------------------------------------------------
@dataclasses.dataclass
class SloStatus:
    name: str
    description: str
    objective: float
    comparator: str
    unit: str
    measured: Optional[float]
    ok: Optional[bool]
    state: str               # OK | BREACHED | NO_DATA

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "objective": self.objective,
            "comparator": self.comparator,
            "unit": self.unit,
            "measured": (
                round(self.measured, 4) if self.measured is not None
                else None
            ),
            "ok": self.ok,
            "state": self.state,
        }


@dataclasses.dataclass
class SloReport:
    rows: List[SloStatus]
    source: str
    window_ms: Optional[float]
    generated_unix: float

    def slo(self, name: str) -> SloStatus:
        for row in self.rows:
            if row.name == name:
                return row
        raise KeyError(name)

    def gate_table(self) -> Dict[str, Optional[bool]]:
        return {row.name: row.ok for row in self.rows}

    def all_ok(self) -> bool:
        """Every SLO with data holds (NO_DATA rows abstain)."""
        return all(row.ok is not False for row in self.rows)

    def to_artifact(self, extra: Optional[dict] = None) -> dict:
        rows = [row.to_json() for row in self.rows]
        out = {
            "schema": SCHEMA,
            "generated_unix": self.generated_unix,
            "source": self.source,
            "windowMs": self.window_ms,
            "slos": rows,
            "summary": {
                "total": len(rows),
                "ok": sum(1 for r in rows if r["ok"] is True),
                "breached": sum(1 for r in rows if r["ok"] is False),
                "noData": sum(1 for r in rows if r["ok"] is None),
                "allOk": self.all_ok(),
            },
        }
        if extra:
            out.update(extra)
        return out


def evaluate_slos(
    journal: Sequence[dict],
    snapshot: Optional[dict] = None,
    objectives: Optional[Dict[str, float]] = None,
    window_ms: Optional[float] = None,
    now: Optional[float] = None,
    source: str = "live",
    horizon_ms: Optional[float] = None,
) -> SloReport:
    """Pure one-shot evaluation of the whole registry.  ``window_ms``
    filters ``journal`` by wall ``ts`` (live mode); scenario callers pass
    the full journal with ``window_ms=None`` and the run's virtual
    duration as ``horizon_ms``."""
    objectives = objectives or {}
    now = time.time() if now is None else now
    if window_ms is not None:
        cutoff = now - window_ms / 1000.0
        journal = [e for e in journal if float(e.get("ts", 0)) > cutoff]
        horizon = window_ms if horizon_ms is None else horizon_ms
    else:
        horizon = horizon_ms if horizon_ms is not None else 0.0
    inputs = SloInputs(events=journal, snapshot=snapshot,
                       horizon_ms=float(horizon))
    rows: List[SloStatus] = []
    for d in SLO_DEFS:
        objective = objectives.get(d.name, d.objective)
        try:
            measured = d.evaluate(inputs)
        except Exception:  # a broken evaluator must not take /slo down
            LOG.exception("SLO evaluator %s failed", d.name)
            measured = None
        ok = d.ok(measured, objective)
        rows.append(SloStatus(
            name=d.name, description=d.description, objective=objective,
            comparator=d.comparator, unit=d.unit, measured=measured,
            ok=ok, state=(NO_DATA if ok is None
                          else (OK if ok else BREACHED)),
        ))
    return SloReport(rows=rows, source=source, window_ms=window_ms,
                     generated_unix=round(now, 3))


# ---- the live engine -------------------------------------------------------------
class SloEngine:
    """Periodic evaluation + hysteresis + breach events over the live
    journal ring and registry.

    ``breach_cycles`` consecutive violating evaluations transition a SLO
    to BREACHED (journaling ``slo.breach`` and firing ``on_breach``
    hooks); ``recover_cycles`` consecutive passing ones transition back
    (``slo.recovered``).  NO_DATA evaluations freeze the counters — the
    absence of traffic neither breaches nor recovers anything.

    ``maintenance_hooks`` run once per evaluation tick off the request
    path; bootstrap pumps :func:`device_cost.capture_pending` here so
    per-executable cost capture never rides a request thread.
    """

    def __init__(
        self,
        registry=None,
        events_reader: Optional[Callable[[], List[dict]]] = None,
        window_ms: float = 600_000.0,
        breach_cycles: int = 2,
        recover_cycles: int = 2,
        objectives: Optional[Dict[str, float]] = None,
        on_breach: Sequence[Callable[[str, SloStatus], None]] = (),
        maintenance_hooks: Sequence[Callable[[], object]] = (),
        clock: Optional[Callable[[], float]] = None,
    ):
        self.registry = registry
        self.events_reader = events_reader
        self.window_ms = float(window_ms)
        self.breach_cycles = max(1, int(breach_cycles))
        self.recover_cycles = max(1, int(recover_cycles))
        self.objectives = dict(objectives or {})
        self.on_breach = list(on_breach)
        self.maintenance_hooks = list(maintenance_hooks)
        self.clock = clock or time.time
        self._lock = threading.Lock()
        #: name -> {"state", "bad", "good", "breachedSince"}
        self._state: Dict[str, dict] = {}
        self._last_report: Optional[SloReport] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.evaluations = 0

    # ---- lifecycle --------------------------------------------------------------
    def start(self, interval_s: float = 30.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        interval = max(0.01, float(interval_s))

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.evaluate()
                except Exception:  # the loop must survive anything
                    LOG.exception("SLO evaluation failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cc-slo-engine")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None

    # ---- evaluation -------------------------------------------------------------
    def evaluate(self) -> SloReport:
        for hook in self.maintenance_hooks:
            try:
                hook()
            except Exception:  # pragma: no cover - defensive
                LOG.exception("SLO maintenance hook failed")
        journal = []
        if self.events_reader is not None:
            try:
                journal = list(self.events_reader())
            except Exception:  # pragma: no cover - defensive
                LOG.exception("SLO events reader failed")
        snapshot = self.registry.snapshot() \
            if self.registry is not None else None
        report = evaluate_slos(
            journal, snapshot, objectives=self.objectives,
            window_ms=self.window_ms, now=self.clock(), source="live",
        )
        breached: List[SloStatus] = []
        recovered: List[SloStatus] = []
        with self._lock:
            self.evaluations += 1
            for row in report.rows:
                st = self._state.setdefault(
                    row.name,
                    {"state": OK, "bad": 0, "good": 0,
                     "breachedSince": None},
                )
                if row.ok is None:
                    row.state = st["state"] if st["state"] == BREACHED \
                        else NO_DATA
                    continue
                if row.ok:
                    st["good"] += 1
                    st["bad"] = 0
                    if st["state"] == BREACHED \
                            and st["good"] >= self.recover_cycles:
                        st["state"] = OK
                        st["breachedSince"] = None
                        recovered.append(row)
                else:
                    st["bad"] += 1
                    st["good"] = 0
                    if st["state"] == OK \
                            and st["bad"] >= self.breach_cycles:
                        st["state"] = BREACHED
                        st["breachedSince"] = report.generated_unix
                        breached.append(row)
                row.state = st["state"]
            self._last_report = report
        for row in breached:
            events.emit(
                "slo.breach", severity="WARNING", slo=row.name,
                measured=row.measured, objective=row.objective,
                comparator=row.comparator, unit=row.unit,
                consecutive=self.breach_cycles,
            )
            for hook in self.on_breach:
                try:
                    hook(row.name, row)
                except Exception:  # a hook failure must not stop paging
                    LOG.exception("SLO on_breach hook failed")
        for row in recovered:
            events.emit(
                "slo.recovered", slo=row.name, measured=row.measured,
                objective=row.objective,
            )
        return report

    # ---- readers ----------------------------------------------------------------
    def report(self) -> dict:
        """The ``GET /slo`` payload: the latest evaluation's artifact
        (evaluating now if none has run yet) plus hysteresis state."""
        with self._lock:
            report = self._last_report
        if report is None:
            report = self.evaluate()
        with self._lock:
            state = {
                name: {"state": st["state"],
                       "breachedSince": st["breachedSince"]}
                for name, st in sorted(self._state.items())
            }
            evaluations = self.evaluations
        return report.to_artifact(extra={
            "hysteresis": {
                "breachCycles": self.breach_cycles,
                "recoverCycles": self.recover_cycles,
                "evaluations": evaluations,
                "perSlo": state,
            },
        })

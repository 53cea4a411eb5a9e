"""Long-horizon soak driver — a simulated production day, gated on SLOs
(``cc-tpu-soak/1``; ROADMAP item 5).

The scenario suite proves each fault class heals in isolation over
minutes of virtual clock.  The soak composes them: a seeded
:mod:`~cruise_control_tpu_torch.sim.fault_schedule` day (broker deaths, rack
loss, disk failures, crashes/restarts, flaps, metric gaps, hot spells,
load drift, analyzer outages, request storms) over the FULL stack at
1000-broker scale — diurnal workload, continuous HTTP traffic against
the real :class:`CruiseControlHttpServer`, detector-driven self-healing
warm-starting through the :class:`DeltaReplanner`
(``replan.heal.enabled``), crash-safe executor recovery — driven by
:func:`~cruise_control_tpu_torch.sim.simulator.run_scenario` on its virtual
clock.

Survival is asserted from the journal plus a small per-tick observer the
short scenarios never needed:

* a **rolling SLO engine** (the PR-11 :class:`SloEngine`, clocked on the
  VIRTUAL clock — its ts window follows scenario time because the
  scenario journal's ``ts`` is virtual) evaluates hysteresis-gated SLOs
  across the horizon and journals ``slo.breach``/``slo.recovered``;
* a **resource-leak detector**: thread count, the card's allocator
  (live allocations and allocated bytes; both read 0 on the CPU), RSS,
  journal/checkpoint file sizes sampled across the day with a linear
  trend fit — a leak shows as slope, not just endpoints;
* **placement invariants** after every heal (structural sanity) and a
  terminal **convergence** check (nothing offline, nothing on dead
  brokers, nothing catching up) once the quiet tail ends the day.

``python -m cruise_control_tpu_torch.sim.soak`` runs the smoke or the full day
(``sim.soak.*`` config keys) and writes the committed ``SOAK_r12.json``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from cruise_control_tpu_torch.sim.fault_schedule import (
    DISRUPTIVE_KINDS,
    FaultScheduleConfig,
    generate_timeline,
    schedule_summary,
)
from cruise_control_tpu_torch.sim.simulator import (
    MIN_MS,
    ScenarioResult,
    ScenarioSpec,
    run_scenario,
)
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.telemetry.slo import SloEngine
from cruise_control_tpu_torch.utils.device import resolve_device
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("soak")

SCHEMA = "cc-tpu-soak/1"

#: wall-clock-only read used for RSS sampling (no psutil in the image)
_PAGE = 4096


@dataclasses.dataclass
class SoakSpec:
    """One soak: scale + schedule + observer cadences + gate thresholds."""

    name: str = "soak_day"
    seed: int = 12
    # scale
    num_brokers: int = 1024
    num_racks: int = 16
    num_partitions: int = 4096
    num_topics: int = 8
    replication_factor: int = 2
    engine: str = "cuda"
    # horizon
    duration_ms: int = 24 * 60 * MIN_MS
    tick_ms: int = MIN_MS
    # workload
    mean_utilization: float = 0.25
    diurnal_amplitude: float = 0.08
    diurnal_period_ms: int = 24 * 60 * MIN_MS
    # control plane
    detection_interval_ms: int = 5 * MIN_MS
    fix_cooldown_ms: int = 2 * MIN_MS
    metric_anomaly_margin: float = 3.0
    metric_anomaly_min_windows: int = 5
    metric_anomaly_interval_ms: Optional[int] = 60 * MIN_MS
    replan_budget_ratio: float = 0.9
    replan_load_threshold: float = 0.05
    precompute_interval_ticks: int = 10
    breaker_failures: int = 3
    # serving
    http_get_concurrent: int = 8
    http_compute_concurrent: int = 2
    http_queue_size: int = 2
    # crash safety
    task_retry_attempts: int = 3
    watchdog_stuck_ticks: int = 30
    # journal retention under test
    journal_ring_size: int = 1 << 17
    journal_max_bytes: int = 4 * 1024 * 1024
    journal_max_files: int = 3
    # observer cadences (ticks)
    sample_interval_ticks: int = 5
    slo_interval_ticks: int = 15
    slo_window_ms: int = 60 * MIN_MS
    #: fault schedule (None = derived from the scale + seed above)
    schedule: Optional[FaultScheduleConfig] = None
    #: final-gate objective overrides (cc-tpu-slo/1 vocabulary).  The
    #: serve objectives are wall-clock measurements of real requests on
    #: whatever box runs the soak — relaxed like the slo_observatory
    #: scenario relaxes them; every virtual-clock and counting gate holds
    #: production-shaped values.
    objectives: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "heal.latency.p50.ms": 15.0 * MIN_MS,
        "heal.latency.p99.ms": 60.0 * MIN_MS,
        "serve.cached_get.p99.ms": 2_000.0,
        "serve.compute.p99.ms": 120_000.0,
        "replan.warm.duty.cycle": 0.8,
        "journal.growth.per.min": 1_000.0,
    })
    #: rolling (hysteresis) objectives: wall-latency SLOs are exempted so
    #: the smoke journal stays bit-reproducible on any host — a slow box
    #: must not add a nondeterministic slo.breach record
    rolling_serve_relax_ms: float = 1e9
    # leak-trend gates (fitted over the second half of the samples)
    max_thread_growth: int = 16
    max_thread_slope_per_hour: float = 4.0
    max_live_buffer_mb: float = 2048.0
    max_live_buffer_slope_mb_per_hour: float = 64.0
    max_rss_slope_mb_per_hour: float = 256.0

    def schedule_config(self) -> FaultScheduleConfig:
        if self.schedule is not None:
            return self.schedule
        return FaultScheduleConfig(
            seed=self.seed,
            duration_ms=self.duration_ms,
            num_brokers=self.num_brokers,
            num_racks=self.num_racks,
            num_partitions=self.num_partitions,
        )


def build_scenario_spec(spec: SoakSpec,
                        checkpoint_dir: Optional[str] = None,
                        journal_path: Optional[str] = None) -> ScenarioSpec:
    """The composed day as one ScenarioSpec the simulator can drive."""
    timeline = generate_timeline(spec.schedule_config())
    return ScenarioSpec(
        name=spec.name,
        description=(
            "Seeded long-horizon soak: composed fault schedule + "
            "continuous traffic over the full stack"
        ),
        timeline=timeline,
        seed=spec.seed,
        num_brokers=spec.num_brokers,
        num_racks=spec.num_racks,
        num_partitions=spec.num_partitions,
        num_topics=spec.num_topics,
        replication_factor=spec.replication_factor,
        duration_ms=spec.duration_ms,
        tick_ms=spec.tick_ms,
        mean_utilization=spec.mean_utilization,
        diurnal_amplitude=spec.diurnal_amplitude,
        diurnal_period_ms=spec.diurnal_period_ms,
        self_healing={
            "goal_violation": True, "broker_failure": True,
            "disk_failure": True, "maintenance_event": True,
        },
        detection_interval_ms=spec.detection_interval_ms,
        fix_cooldown_ms=spec.fix_cooldown_ms,
        engine=spec.engine,
        metric_anomaly_margin=spec.metric_anomaly_margin,
        metric_anomaly_min_windows=spec.metric_anomaly_min_windows,
        metric_anomaly_interval_ms=spec.metric_anomaly_interval_ms,
        checkpoint=True,
        task_retry_attempts=spec.task_retry_attempts,
        watchdog_stuck_ticks=spec.watchdog_stuck_ticks,
        serve_http=True,
        http_get_concurrent=spec.http_get_concurrent,
        http_compute_concurrent=spec.http_compute_concurrent,
        http_queue_size=spec.http_queue_size,
        precompute_interval_ticks=spec.precompute_interval_ticks,
        breaker_failures=spec.breaker_failures,
        replan_enabled=True,
        replan_budget_ratio=spec.replan_budget_ratio,
        replan_load_threshold=spec.replan_load_threshold,
        replan_heal=True,
        journal_ring_size=spec.journal_ring_size,
        journal_path=journal_path,
        journal_max_bytes=spec.journal_max_bytes,
        journal_max_files=spec.journal_max_files,
    )


# ---------------------------------------------------------------------------------
class _Observer:
    """The per-tick instrument: resource samples, rolling SLO engine on
    the virtual clock, placement invariants after each heal.  Read-only
    with respect to the system under test."""

    def __init__(self, spec: SoakSpec, journal_path: str, device="cuda"):
        self.spec = spec
        self.journal_path = journal_path
        #: the card whose allocator the leak gate reads (none on the CPU)
        self.device = resolve_device(device)
        self.samples: List[dict] = []
        self.placement_violations: List[dict] = []
        self.heal_checks = 0
        self.rolling_evaluations = 0
        self.now_ms = 0
        self._engine: Optional[SloEngine] = None
        self._exec_marker = None
        self._ckpt_high_water = 0

    # -- rolling SLO engine on the virtual clock ---------------------------------
    def _rolling_engine(self) -> SloEngine:
        if self._engine is None:
            objectives = dict(self.spec.objectives)
            # wall-latency SLOs never gate the rolling pass (see SoakSpec)
            objectives["serve.cached_get.p99.ms"] = \
                self.spec.rolling_serve_relax_ms
            objectives["serve.compute.p99.ms"] = \
                self.spec.rolling_serve_relax_ms
            self._engine = SloEngine(
                registry=None,
                events_reader=lambda: events.JOURNAL.recent(),
                window_ms=float(self.spec.slo_window_ms),
                objectives=objectives,
                clock=lambda: self.now_ms / 1000.0,
            )
        return self._engine

    # -- resource sampling --------------------------------------------------------
    def _journal_disk_bytes(self) -> int:
        total = 0
        for i in range(self.spec.journal_max_files + 1):
            p = (self.journal_path if i == 0
                 else f"{self.journal_path}.{i}")
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    @staticmethod
    def _rss_mb() -> Optional[float]:
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * _PAGE / (1024.0 * 1024.0)
        except (OSError, ValueError, IndexError):
            return None

    def _live_buffers(self):
        """(live allocations, allocated MiB) of the card's caching
        allocator; (0, 0.0) on the CPU, where the engines hold no card
        memory."""
        import torch

        if self.device.type != "cuda":
            return 0, 0.0
        stats = torch.cuda.memory_stats(self.device)
        return (int(stats.get("allocation.all.current", 0)),
                torch.cuda.memory_allocated(self.device) / 2**20)

    def _sample(self, sim, now_ms: int) -> None:
        live_arrays, live_mb = self._live_buffers()
        # the checkpoint truncates itself after every completed execution,
        # so the retention gate reads the journal's lifetime HIGH-WATER
        # mark (peak on-disk bytes mid-drive), carried across restarts
        ckpt = getattr(sim.executor, "journal", None)
        if ckpt is not None:
            self._ckpt_high_water = max(
                self._ckpt_high_water, ckpt.high_water_bytes
            )
        ckpt_bytes = self._ckpt_high_water
        self.samples.append({
            "virtualMs": now_ms,
            "threads": threading.active_count(),
            "liveArrays": live_arrays,
            "liveBufferMb": round(live_mb, 3),
            "rssMb": self._rss_mb(),
            "journalDiskBytes": self._journal_disk_bytes(),
            "journalTotalEvents": events.JOURNAL.total_emitted,
            "checkpointBytes": ckpt_bytes,
        })

    # -- placement invariants -----------------------------------------------------
    @staticmethod
    def placement_errors(backend, terminal: bool = False) -> List[str]:
        """Structural sanity that must hold after every heal; ``terminal``
        adds the end-of-day convergence conditions."""
        errors: List[str] = []
        for p, st in backend.partitions.items():
            reps = list(st.replicas)
            if not reps:
                errors.append(f"p{p}: no replicas")
                continue
            if len(reps) != len(set(reps)):
                errors.append(f"p{p}: duplicate replicas {reps}")
            if st.leader not in reps:
                errors.append(f"p{p}: leader {st.leader} not in {reps}")
            live = [b for b in reps if b not in backend.failed_brokers]
            if st.leader in backend.failed_brokers and live:
                errors.append(
                    f"p{p}: dead leader {st.leader} with live replicas"
                )
            if terminal:
                dead = [b for b in reps if b in backend.failed_brokers]
                if dead:
                    errors.append(f"p{p}: replicas on dead brokers {dead}")
                if st.catching_up:
                    errors.append(f"p{p}: still catching up "
                                  f"{sorted(st.catching_up)}")
        if terminal and backend.offline_replicas():
            errors.append(
                f"offline replicas remain: {backend.offline_replicas()}"
            )
        return errors

    def _check_heals(self, sim, now_ms: int) -> None:
        marker = (id(sim.executor), len(sim.executor.history))
        if marker == self._exec_marker:
            return
        self._exec_marker = marker
        if sim.executor.has_ongoing_execution:
            return
        self.heal_checks += 1
        for err in self.placement_errors(sim.backend)[:16]:
            self.placement_violations.append({
                "virtualMs": now_ms, "error": err,
            })

    # -- the hook -----------------------------------------------------------------
    def __call__(self, sim, now_ms: int) -> None:
        self.now_ms = now_ms
        tick = now_ms // max(1, self.spec.tick_ms)
        self._check_heals(sim, now_ms)
        if tick % self.spec.sample_interval_ticks == 0:
            self._sample(sim, now_ms)
        if sim.process_up and tick % self.spec.slo_interval_ticks == 0:
            self._rolling_engine().evaluate()
            self.rolling_evaluations += 1


@dataclasses.dataclass
class SoakResult:
    spec: SoakSpec
    scenario: ScenarioResult
    observer: _Observer
    schedule: dict
    wall_seconds: float
    journal_total_events: int
    journal_ring_clipped: bool
    terminal_errors: List[str]

    def fingerprint(self) -> str:
        return self.scenario.fingerprint()


def run_soak(spec: SoakSpec, wall_clock=time.monotonic,
             device="cuda") -> SoakResult:
    """Drive the whole day and return the journal-backed result.
    ``wall_clock`` only stamps the artifact's wallSeconds — everything
    the gates read runs on the scenario's virtual clock.  ``device`` is
    the card the cuda engine plans on (and whose allocator the leak gate
    reads); it raises when a card is asked for and none is present."""
    resolve_device(device)
    tmp = tempfile.mkdtemp(prefix=f"cc-soak-{spec.name}-")
    journal_path = os.path.join(tmp, "events.jsonl")
    sspec = build_scenario_spec(spec, journal_path=journal_path)
    observer = _Observer(spec, journal_path, device=device)
    terminal_errors: List[str] = []

    def on_tick(sim, now_ms):
        observer(sim, now_ms)
        if now_ms >= spec.duration_ms:  # the last tick: terminal state
            terminal_errors.extend(
                observer.placement_errors(sim.backend, terminal=True)
            )

    LOG.info("soak %s: %d brokers / %d partitions, %d scheduled events",
             spec.name, spec.num_brokers, spec.num_partitions,
             len(sspec.timeline))
    t0 = wall_clock()
    scenario = run_scenario(sspec, on_tick=on_tick, device=device)
    wall = wall_clock() - t0
    total = observer.samples[-1]["journalTotalEvents"] \
        if observer.samples else len(scenario.journal)
    total = max(total, len(scenario.journal))
    return SoakResult(
        spec=spec,
        scenario=scenario,
        observer=observer,
        schedule=schedule_summary(sspec.timeline, spec.schedule_config()),
        wall_seconds=round(wall, 2),
        journal_total_events=total,
        journal_ring_clipped=total > len(scenario.journal),
        terminal_errors=terminal_errors,
    )


# ---- analysis -------------------------------------------------------------------
def per_type_heals(journal) -> Dict[str, dict]:
    """Per-anomaly-type decision/heal accounting from the journal alone."""
    out: Dict[str, dict] = {}
    for e in journal:
        if e.get("kind") != "detector.anomaly":
            continue
        p = e.get("payload", {})
        t = p.get("anomalyType", "?")
        d = out.setdefault(t, {
            "decisions": 0, "fixesStarted": 0, "fixFailed": 0,
            "lastAction": None, "lastFixStarted": False,
        })
        d["decisions"] += 1
        d["lastAction"] = p.get("action")
        d["lastFixStarted"] = bool(p.get("fixStarted"))
        if p.get("fixStarted"):
            d["fixesStarted"] += 1
        if p.get("action") == "FIX_FAILED":
            d["fixFailed"] += 1
    return out


#: decisions that need no eventual fix to count as handled
_BENIGN_FINAL_ACTIONS = ("IGNORE", "CHECK")


def unhealed_types(journal) -> List[str]:
    """Anomaly types whose LAST decision wanted a fix that never started
    — the zero-unhealed-anomalies gate reads this."""
    out = []
    for t, d in sorted(per_type_heals(journal).items()):
        if d["lastFixStarted"]:
            continue
        if d["lastAction"] in _BENIGN_FINAL_ACTIONS:
            continue
        out.append(t)
    return out


def _trend(samples: List[dict], key: str) -> dict:
    """Linear fit (per virtual hour) over the second half of the samples
    — warmup ramps (compile caches, first-touch pools) stay out of the
    slope a leak gate reads.  ``samples < 4`` marks a series with too
    little data to fit (its gate abstains)."""
    import numpy as np

    pts = [(s["virtualMs"] / 3_600_000.0, s[key]) for s in samples
           if s.get(key) is not None]
    if len(pts) < 4:
        v = float(pts[-1][1]) if pts else 0.0
        return {"first": v, "last": v, "max": v, "slopePerHour": 0.0,
                "samples": len(pts)}
    tail = pts[len(pts) // 2:]
    xs = np.array([p[0] for p in tail], float)
    ys = np.array([p[1] for p in tail], float)
    slope = float(np.polyfit(xs, ys, 1)[0]) if float(np.ptp(xs)) > 0 \
        else 0.0
    return {
        "first": float(pts[0][1]),
        "last": float(pts[-1][1]),
        "max": float(max(p[1] for p in pts)),
        "slopePerHour": round(slope, 4),
        "samples": len(pts),
    }


def analyze(result: SoakResult) -> dict:
    """Everything the gate table needs, derived from the run."""
    spec = result.spec
    scenario = result.scenario
    report = scenario.slo_report(objectives=spec.objectives)
    slo_art = report.to_artifact()

    journal = scenario.journal
    breaches: Dict[str, int] = {}
    bad_http: List[dict] = []
    for e in journal:
        kind = e.get("kind")
        p = e.get("payload", {})
        if kind == "slo.breach":
            name = p.get("slo", "?")
            breaches[name] = breaches.get(name, 0) + 1
        elif kind == "sim.http":
            status = int(p.get("status") or 0)
            if (status >= 500 or status == 429) and not p.get("retryAfter"):
                bad_http.append({"virtualMs": p.get("virtualMs"),
                                 "endpoint": p.get("endpoint"),
                                 "status": status,
                                 "error": p.get("error")})
        elif kind == "sim.http_storm":
            if p.get("unhandled5xx") or p.get("shedMissingRetryAfter"):
                bad_http.append({"virtualMs": p.get("virtualMs"),
                                 "endpoint": p.get("endpoint"),
                                 "statusCounts": p.get("statusCounts")})

    heal_pcts = scenario.heal_latency_percentiles()
    samples = result.observer.samples
    trends = {
        "threads": _trend(samples, "threads"),
        "liveBufferMb": _trend(samples, "liveBufferMb"),
        "rssMb": _trend(samples, "rssMb"),
    }
    journal_cap = spec.journal_max_bytes * spec.journal_max_files + 65536
    journal_max = max((s["journalDiskBytes"] for s in samples), default=0)
    ckpt_max = max((s["checkpointBytes"] for s in samples), default=0)
    ckpt_cap = 4 * 1024 * 1024 + 262_144  # ExecutionJournal default + slack

    t = trends["threads"]
    threads_ok = t["samples"] < 4 or (
        (t["last"] - t["first"]) <= spec.max_thread_growth
        and t["slopePerHour"] <= spec.max_thread_slope_per_hour
    )
    lb = trends["liveBufferMb"]
    live_ok = lb["samples"] < 4 or (
        lb["max"] <= spec.max_live_buffer_mb
        and lb["slopePerHour"] <= spec.max_live_buffer_slope_mb_per_hour
    )
    rs = trends["rssMb"]
    rss_ok = rs["samples"] < 4 \
        or rs["slopePerHour"] <= spec.max_rss_slope_mb_per_hour

    heals = per_type_heals(journal)
    unhealed = unhealed_types(journal)
    warm = len(scenario.replans("warm"))
    cold = len(scenario.replans("cold"))

    gates = {
        "sloAllOk": report.all_ok(),
        "zeroUnhealedAnomalies": not unhealed
        and scenario.heal_outcome() in ("HEALED", "NO_ANOMALY"),
        "zeroUnhandled5xx": (report.slo("http.unhandled.5xx").measured
                             or 0.0) == 0.0,
        "shedsCarryRetryAfter": (
            report.slo("http.shed.missing.retry.after").measured or 0.0
        ) == 0.0,
        "placementInvariantsHold": not result.observer.placement_violations,
        "terminalConvergence": not result.terminal_errors,
        "journalDiskBounded": journal_max <= journal_cap,
        "checkpointDiskBounded": ckpt_max <= ckpt_cap,
        "threadsBounded": bool(threads_ok),
        "liveBuffersBounded": bool(live_ok),
        "rssBounded": bool(rss_ok),
        "distinctFaultClasses": result.schedule["distinctFaultClasses"],
    }
    return {
        "slo": slo_art,
        "rolling": {
            "evaluations": result.observer.rolling_evaluations,
            "windowMs": spec.slo_window_ms,
            "breaches": dict(sorted(breaches.items())),
        },
        "heals": {
            "outcome": scenario.heal_outcome(),
            "latencyMs": {str(k): v for k, v in heal_pcts.items()},
            "perType": dict(sorted(heals.items())),
            "unhealedTypes": unhealed,
            "fixesStarted": len(scenario.fixes_started()),
            "actionsExecuted": scenario.actions_executed(),
            "deadTasks": scenario.dead_tasks(),
            "recoveries": len(scenario.recoveries()),
            "replans": {"warm": warm, "cold": cold},
        },
        "resources": {
            "samples": len(samples),
            "trends": trends,
            "journal": {
                "totalEvents": result.journal_total_events,
                "ringEvents": len(journal),
                "ringClipped": result.journal_ring_clipped,
                "diskBytesMax": journal_max,
                "diskBytesCap": journal_cap,
            },
            "checkpoint": {
                "bytesMax": ckpt_max,
                "bytesCap": ckpt_cap,
            },
        },
        "invariants": {
            "placementViolations": result.observer.placement_violations[:8],
            "healChecks": result.observer.heal_checks,
            "terminalErrors": result.terminal_errors[:8],
            "badHttp": bad_http[:8],
        },
        "gates": gates,
    }


def make_soak_artifact(result: SoakResult, now: Optional[float] = None) -> dict:
    now = time.time() if now is None else now
    spec = result.spec
    a = analyze(result)
    gates = a["gates"]
    all_ok = all(
        v is True for k, v in gates.items() if k != "distinctFaultClasses"
    )
    return {
        "schema": SCHEMA,
        "generated_unix": round(now, 3),
        "name": spec.name,
        "seed": spec.seed,
        "scale": {
            "brokers": spec.num_brokers,
            "partitions": spec.num_partitions,
            "racks": spec.num_racks,
            "replicationFactor": spec.replication_factor,
            "engine": spec.engine,
        },
        "horizon": {
            "durationVirtualMs": result.scenario.duration_virtual_ms,
            "tickMs": spec.tick_ms,
            "ticks": result.scenario.ticks,
            "wallSeconds": result.wall_seconds,
        },
        "schedule": result.schedule,
        "slo": a["slo"],
        "rolling": a["rolling"],
        "heals": a["heals"],
        "resources": a["resources"],
        "invariants": a["invariants"],
        "gates": gates,
        "journalFingerprint": result.fingerprint(),
        "allOk": bool(all_ok),
    }


# ---- the named soaks ------------------------------------------------------------
def smoke_spec(seed: int = 7) -> SoakSpec:
    """The tier-1 smoke soak: ~36 virtual minutes at small scale, greedy
    engine, storm-free (concurrent storms are journal-order
    nondeterministic) — bit-stable fingerprint, a few wall-clock
    seconds."""
    duration = 36 * MIN_MS
    return SoakSpec(
        name="soak_smoke",
        seed=seed,
        num_brokers=48, num_racks=4, num_partitions=192, num_topics=4,
        engine="greedy",
        duration_ms=duration,
        mean_utilization=0.25,
        diurnal_amplitude=0.05,
        diurnal_period_ms=duration,
        detection_interval_ms=2 * MIN_MS,
        fix_cooldown_ms=MIN_MS,
        metric_anomaly_interval_ms=10 * MIN_MS,
        precompute_interval_ticks=4,
        journal_ring_size=1 << 14,
        journal_max_bytes=16_384,  # small enough that rotation REALLY runs
        journal_max_files=3,
        sample_interval_ticks=2,
        slo_interval_ticks=6,
        slo_window_ms=12 * MIN_MS,
        schedule=FaultScheduleConfig(
            seed=seed,
            duration_ms=duration,
            num_brokers=48, num_racks=4, num_partitions=192,
            broker_deaths=1, rack_losses=0, disk_failures=1,
            hot_skews=1, load_perturbations=1, metric_gaps=1,
            process_crashes=0, broker_flaps=0, analyzer_outages=0,
            execution_stalls=0, request_storms=0,
            settle_ms=6 * MIN_MS, quiet_tail_ms=10 * MIN_MS,
            min_spacing_ms=4 * MIN_MS, heal_ms=4 * MIN_MS,
            # one breach-grade drift: the smoke proves the warm HEAL path
            # (replan.heal.enabled) end to end, not just warm refreshes
            perturb_factors=(4.5,),
            http_poll_interval_ms=6 * MIN_MS,
        ),
    )


def day_spec(seed: int = 12) -> SoakSpec:
    """The full production day at 1000-broker scale on the cuda engine."""
    return SoakSpec(seed=seed)


def pileup_spec(seed: int = 9) -> SoakSpec:
    """Slow-tier pile-up soak (ISSUE 15 satellite): the relaxed-spacing
    schedule (``min_spacing_relaxed``) fires bounded concurrent
    multi-fault bursts — up to two disruptive faults one virtual minute
    apart — at smoke scale, so genuinely OVERLAPPING heals exercise the
    detector's priority queue, cooldown, and the executor's
    foreign/retry machinery at once.  Heal-latency objectives are
    widened: a burst's second heal legitimately queues behind the
    first."""
    duration = 60 * MIN_MS
    spec = smoke_spec(seed=seed)
    return dataclasses.replace(
        spec,
        name="soak_pileup",
        duration_ms=duration,
        diurnal_period_ms=duration,
        objectives={
            **spec.objectives,
            "heal.latency.p50.ms": 20.0 * MIN_MS,
            "heal.latency.p99.ms": 40.0 * MIN_MS,
        },
        schedule=dataclasses.replace(
            spec.schedule_config(),
            duration_ms=duration,
            min_spacing_relaxed=True,
            pileup_max_cluster=2,
            hot_skews=2,
            min_spacing_ms=8 * MIN_MS,
            quiet_tail_ms=16 * MIN_MS,
        ),
    )


SOAKS = {
    "soak_smoke": smoke_spec,
    "soak_day": day_spec,
    "soak_pileup": pileup_spec,
}


# ---- CLI ------------------------------------------------------------------------
def main(argv=None) -> int:
    """``python -m cruise_control_tpu_torch.sim.soak`` — run a named soak and
    (optionally) write the committed ``cc-tpu-soak/1`` artifact.  Scale
    and horizon default from the ``sim.soak.*`` config keys; exit code 1
    when any gate is red."""
    import argparse
    import json

    from cruise_control_tpu_torch.config.cruise_control_config import (
        CruiseControlConfig,
    )

    ap = argparse.ArgumentParser(
        prog="python -m cruise_control_tpu_torch.sim.soak",
        description="Long-horizon soak driver (SLO-gated survival)",
    )
    ap.add_argument("--soak", choices=sorted(SOAKS), default=None,
                    help="named soak (default: the sim.soak.profile key)")
    ap.add_argument("--seed", type=int, default=None,
                    help="schedule seed (default: the sim.soak.seed key)")
    ap.add_argument("--artifact", metavar="PATH", default=None,
                    help="write the cc-tpu-soak/1 artifact here")
    ap.add_argument("--with-smoke", action="store_true",
                    help="also run the smoke soak and embed its "
                         "fingerprint (the tier-1 determinism anchor)")
    ap.add_argument("--journal", metavar="PATH", default=None,
                    help="dump the run's event-journal ring as JSONL "
                         "(forensics; not part of the artifact)")
    ap.add_argument("--json", action="store_true",
                    help="print the artifact JSON to stdout")
    ap.add_argument("--device", default="cuda",
                    help="the card the engines run on (default "
                         "%(default)s; 'cpu' runs the kernels' plain twins)")
    args = ap.parse_args(argv)

    cfg = CruiseControlConfig()
    name = args.soak or cfg.get("sim.soak.profile")
    if args.seed is not None:
        spec = SOAKS[name](seed=args.seed)
    elif name == "soak_day":
        spec = SOAKS[name](seed=cfg.get_int("sim.soak.seed"))
    else:
        # the smoke's seed is pinned: its fingerprint is committed
        spec = SOAKS[name]()
    if name == "soak_day":
        # the day profile is config-sized (the smoke's shape is pinned:
        # its fingerprint is committed)
        spec = dataclasses.replace(
            spec,
            num_brokers=cfg.get_int("sim.soak.num.brokers"),
            num_partitions=cfg.get_int("sim.soak.num.partitions"),
            duration_ms=cfg.get_int("sim.soak.duration.minutes") * MIN_MS,
            diurnal_period_ms=(
                cfg.get_int("sim.soak.duration.minutes") * MIN_MS
            ),
            engine=cfg.get("sim.soak.engine"),
            slo_window_ms=cfg.get_int("sim.soak.slo.window.minutes")
            * MIN_MS,
        )

    result = run_soak(spec, device=args.device)
    art = make_soak_artifact(result)
    if args.journal:
        with open(args.journal, "w") as f:
            for rec in result.scenario.journal:
                f.write(json.dumps(rec, default=str) + "\n")
        print(f"journal written: {args.journal}")
    if args.with_smoke and spec.name != "soak_smoke":
        smoke = run_soak(smoke_spec(), device=args.device)
        smoke_art = make_soak_artifact(smoke)
        art["smoke"] = {
            "name": smoke.spec.name,
            "seed": smoke.spec.seed,
            "journalFingerprint": smoke.fingerprint(),
            "allOk": smoke_art["allOk"],
            "wallSeconds": smoke.wall_seconds,
        }
    gates = art["gates"]
    red = sorted(k for k, v in gates.items()
                 if k != "distinctFaultClasses" and v is not True)
    print(
        f"{spec.name}: {art['horizon']['ticks']} ticks "
        f"({art['horizon']['durationVirtualMs'] // 60000} virtual min) in "
        f"{art['horizon']['wallSeconds']}s wall — "
        f"{art['schedule']['distinctFaultClasses']} fault classes, "
        f"heal outcome {art['heals']['outcome']}, "
        f"{'ALL GATES GREEN' if art['allOk'] else f'RED: {red}'}"
    )
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"artifact written: {args.artifact}")
    if args.json:
        print(json.dumps(art, indent=1, sort_keys=True))
    return 0 if art["allOk"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

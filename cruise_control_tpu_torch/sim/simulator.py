"""The scenario driver: a virtual clock over the REAL control loop.

``run_scenario(spec)`` assembles the production stack — scripted cluster
backend, metrics reporter → topic → sampler → :class:`LoadMonitor`,
:class:`Executor`, :class:`CruiseControl` facade, and the full
:class:`AnomalyDetectorManager` via the same :func:`make_detector_manager`
bootstrap uses — then advances a virtual clock tick by tick:

    apply due timeline events → synthesize workload → report+ingest samples
    → run the detection cycle (which self-heals through the facade and
    executor, synchronously, exactly as the production scheduler thread
    would).

Nothing in the system under test is mocked; the only simulated parts are
the cluster itself and the clock.  Ground truth for every assertion is the
PR-3 **event journal**: the driver swaps in a dedicated
:class:`EventJournal` for the run, emits ``sim.scenario_start`` /
``sim.fault`` / ``sim.scenario_end`` markers carrying virtual timestamps,
and returns every record.  Same seed ⇒ same journal (modulo wall-clock
fields), which :func:`journal_fingerprint` makes testable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.precompute import (
    CircuitBreaker,
    ProposalPrecomputingExecutor,
)
from cruise_control_tpu_torch.bootstrap import _capacity_for
from cruise_control_tpu_torch.detector.anomalies import AnomalyType
from cruise_control_tpu_torch.detector.detectors import MaintenanceEventReader
from cruise_control_tpu_torch.detector.manager import make_detector_manager
from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
from cruise_control_tpu_torch.executor.journal import ExecutionJournal, ProcessCrash
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.models.generators import random_cluster
from cruise_control_tpu_torch.monitor.load_monitor import (
    BackendMetadataClient,
    LoadMonitor,
)
from cruise_control_tpu_torch.monitor.sampling import (
    MetricsReporterSampler,
    MetricsTopic,
    SimulatedMetricsReporter,
)
from cruise_control_tpu_torch.server.http_server import CruiseControlHttpServer
from cruise_control_tpu_torch.server.user_tasks import UserTaskManager
from cruise_control_tpu_torch.sim.backend import ScriptedClusterBackend
from cruise_control_tpu_torch.sim.timeline import Timeline, TimelineEvent
from cruise_control_tpu_torch.sim.workload import ScenarioWorkload
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.telemetry.events import EventJournal
from cruise_control_tpu_torch.utils.device import resolve_device
from cruise_control_tpu_torch.utils.logging import get_logger
from cruise_control_tpu_torch.utils.metrics import MetricRegistry

LOG = get_logger("sim")

MIN_MS = 60_000

#: default detection-goal subset (the production anomaly.detection.goals
#: default — hard goals only, so a legal initial cluster is quiet)
HARD_DETECTION_GOALS = (
    "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
    "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
)

#: journal fields that carry wall-clock (not virtual) time — stripped by
#: the determinism fingerprint, kept everywhere else.  latencyMs/elapsedS
#: ride the serving-chaos events (sim.http / sim.http_slow_client);
#: cacheAgeS rides proposals responses (all wall-clock).
_VOLATILE_KEYS = ("ts",)
_VOLATILE_PAYLOAD_KEYS = ("durationS", "latencyMs", "elapsedS", "cacheAgeS")


@dataclasses.dataclass
class ScenarioSpec:
    """One scripted fault timeline plus the cluster/config it runs on."""

    name: str
    description: str
    timeline: Timeline
    seed: int = 0
    # cluster shape (random_cluster knobs; rack-aware so the start is legal)
    num_brokers: int = 6
    num_racks: int = 3
    num_partitions: int = 36
    num_topics: int = 3
    replication_factor: int = 2
    # virtual clock
    duration_ms: int = 30 * MIN_MS
    tick_ms: int = MIN_MS
    # workload synthesis
    mean_utilization: float = 0.25
    diurnal_amplitude: float = 0.1
    diurnal_period_ms: int = 7_200_000
    drift_per_hour: float = 0.0
    # detector / notifier wiring (mirrors the bootstrap key surface)
    self_healing: Dict[str, bool] = dataclasses.field(default_factory=dict)
    detection_interval_ms: int = 2 * MIN_MS
    fix_cooldown_ms: int = 0
    broker_failure_alert_ms: int = 0
    broker_failure_heal_ms: int = 0
    detection_goals: Optional[Sequence[str]] = HARD_DETECTION_GOALS
    healing_goals: Optional[Sequence[str]] = None
    target_rf: Optional[int] = None
    # executor shape
    executor_task_timeout_ticks: int = 20
    executor_moves_per_broker: int = 5
    move_latency_ticks: int = 1
    # crash-safe execution knobs (ISSUE 7): write-ahead checkpoint +
    # retry with backoff + watchdog — off by default so pre-existing
    # scenario timelines keep their semantics
    checkpoint: bool = False
    task_retry_attempts: int = 0
    task_retry_backoff_base_ticks: int = 2
    task_retry_backoff_max_ticks: int = 16
    task_retry_jitter_ticks: int = 1
    dest_exclusion_threshold: int = 0
    watchdog_stuck_ticks: int = 0
    #: concurrent-controller safety (ISSUE 15): what planned tasks do when
    #: a foreign reassignment conflicts with them ("yield" | "abort")
    foreign_conflict_policy: str = "yield"
    foreign_yield_backoff_ticks: int = 4
    # serving-layer chaos knobs (ISSUE 8): a REAL CruiseControlHttpServer
    # in front of the facade, driven by http_request/request_storm/
    # slow_client timeline events — off by default
    serve_http: bool = False
    http_get_concurrent: int = 8
    http_compute_concurrent: int = 2
    http_queue_size: int = 4
    http_queue_timeout_ms: int = 500
    #: wall-clock per-connection read timeout (slow-loris reaping)
    http_read_timeout_ms: int = 5_000
    #: >0: run one synchronous proposal-precompute pass every N ticks
    #: (the daemon's loop, driven deterministically by the virtual clock)
    precompute_interval_ticks: int = 0
    #: >0: attach an analyzer CircuitBreaker with this failure threshold,
    #: clocked on VIRTUAL time so trip/reset timing is deterministic
    breaker_failures: int = 0
    breaker_reset_ms: int = 4 * MIN_MS
    # incremental re-optimization (delta replan): route the proposal
    # refreshes through replan.DeltaReplanner — generation bumps
    # warm-start from the previous plan instead of cold recomputing.
    # Off by default so pre-existing scenario journals keep their bits.
    replan_enabled: bool = False
    replan_budget_ratio: float = 0.5
    replan_load_threshold: float = 0.05
    #: route goal-violation self-heal rebalances through the replanner
    #: too (warm heal plans — ROADMAP item 4's closed loop); off by
    #: default so pre-existing scenario journals keep their bits
    replan_heal: bool = False
    #: the engine the facade optimizes with (self-heals AND proposals).
    #: Scenarios keep the greedy default; the 1000-broker soak runs "cuda".
    engine: str = "greedy"
    #: >0: arm the kernel observatory for this many scan calls.  The
    #: observatory is not ported yet (ROADMAP A10): run_scenario refuses
    #: any value but 0 before anything starts.
    kernel_capture_scans: int = 0
    # metric-anomaly finder tuning (the production metric.anomaly.* keys;
    # defaults mirror PercentileMetricAnomalyFinder's).  A full-stack
    # rebalance redistributes traffic, so at soak scale every broker's
    # own-history percentile breaches right after a heal — the soak widens
    # the margin and slows the detector instead of drowning the journal.
    metric_anomaly_margin: float = 1.5
    metric_anomaly_min_windows: int = 3
    metric_anomaly_interval_ms: Optional[int] = None
    # journal shape for the run: ring size and (for the long-horizon soak)
    # file-backed size rotation, so retention is exercised under load.
    # Scenarios stay in-memory with the historical ring.
    journal_ring_size: int = 1 << 15
    journal_path: Optional[str] = None
    journal_max_bytes: int = 16 * 1024 * 1024
    journal_max_files: int = 3
    # forecast-driven proactive control (ISSUE 16): a ProactiveScheduler
    # on the VIRTUAL clock fits the diurnal curve to observed ingress,
    # projects the peak, and — when the what-if verdict says a goal
    # breaks — rebalances BEFORE the breach.  Off by default so
    # pre-existing scenario journals keep their bits.
    proactive_enabled: bool = False
    proactive_horizon_ms: int = 60 * MIN_MS
    proactive_threshold: float = 1.1
    proactive_cooldown_ms: int = 30 * MIN_MS
    proactive_min_samples: int = 8
    # data-integrity knobs (ISSUE 13).  The engine-degradation cooldown
    # runs on the VIRTUAL clock; default outlives most scenarios so a
    # degraded run never probes the real cuda engine mid-scenario (a
    # probe would genuinely build the search's kernels).
    engine_degraded_cooldown_ms: int = 60 * MIN_MS
    quarantine_storm_min_samples: int = 4
    quarantine_storm_window_batches: int = 8

    def healing_enables(self) -> Dict[AnomalyType, bool]:
        return {
            AnomalyType[k.upper()]: bool(v)
            for k, v in self.self_healing.items()
        }


@dataclasses.dataclass
class ScenarioResult:
    """A finished run: the journal IS the ground truth — every helper below
    derives from it alone (the contract ``tests/test_scenarios.py`` keeps)."""

    spec: ScenarioSpec
    journal: List[dict]
    ticks: int
    duration_virtual_ms: int

    # ---- journal readers --------------------------------------------------------
    def events_of(self, kind: str) -> List[dict]:
        prefix = kind + "."
        return [e for e in self.journal
                if e["kind"] == kind or e["kind"].startswith(prefix)]

    def faults(self) -> List[dict]:
        return [e.get("payload", {}) for e in self.events_of("sim.fault")]

    def anomalies(self, anomaly_type: Optional[str] = None,
                  action: Optional[str] = None) -> List[dict]:
        out = []
        for e in self.events_of("detector.anomaly"):
            p = e.get("payload", {})
            if anomaly_type and p.get("anomalyType") != anomaly_type:
                continue
            if action and p.get("action") != action:
                continue
            out.append(p)
        return out

    def fixes_started(self, anomaly_type: Optional[str] = None) -> List[dict]:
        return [p for p in self.anomalies(anomaly_type) if p.get("fixStarted")]

    def executions(self) -> List[dict]:
        return [e.get("payload", {}) for e in self.events_of("execute.end")]

    def executor_ends(self) -> List[dict]:
        """``executor.end`` payloads: one per drive — facade executions
        AND checkpoint resumes (which never pass through the facade)."""
        return [e.get("payload", {}) for e in self.events_of("executor.end")]

    def actions_executed(self) -> int:
        return sum(int(p.get("completed", 0)) for p in self.executor_ends())

    def dead_tasks(self) -> int:
        return sum(int(p.get("dead", 0)) for p in self.executor_ends())

    def detection_latency_ms(
        self, anomaly_type: Optional[str] = None
    ) -> Optional[int]:
        """Virtual ms from the first scripted fault to the first detector
        decision (of the given type) — both read from the journal."""
        fault_ts = [p.get("virtualMs") for p in self.faults()
                    if p.get("virtualMs") is not None]
        det_ts = [p.get("timeMs") for p in self.anomalies(anomaly_type)
                  if p.get("timeMs") is not None]
        if not fault_ts or not det_ts:
            return None
        return max(0, min(det_ts) - min(fault_ts))

    def recoveries(self) -> List[dict]:
        """``execution.recovery.end`` payloads (checkpoint adoptions)."""
        return [e.get("payload", {})
                for e in self.events_of("execution.recovery.end")]

    def resume_summaries(self) -> List[dict]:
        """``executor.resume`` payloads: the reconciliation story — which
        partitions were already done and what was re-issued/re-planned."""
        return [e.get("payload", {})
                for e in self.events_of("executor.resume")]

    def http_responses(self, endpoint: Optional[str] = None) -> List[dict]:
        """``sim.http`` payloads (one per scripted request), optionally
        filtered by endpoint."""
        out = [e.get("payload", {}) for e in self.events_of("sim.http")]
        if endpoint is not None:
            out = [p for p in out if p.get("endpoint") == endpoint]
        return out

    def storms(self) -> List[dict]:
        """``sim.http_storm`` payloads: aggregated concurrent-client
        results."""
        return [e.get("payload", {})
                for e in self.events_of("sim.http_storm")]

    def breaker_transitions(self) -> List[dict]:
        """``analyzer.breaker`` payloads in journal order."""
        return [e.get("payload", {})
                for e in self.events_of("analyzer.breaker")]

    def replans(self, mode: Optional[str] = None) -> List[dict]:
        """``replan.end`` payloads (one per proposal computation routed
        through the delta replanner), optionally filtered by mode
        (``warm``/``cold``)."""
        out = [e.get("payload", {}) for e in self.events_of("replan.end")]
        if mode is not None:
            out = [p for p in out if p.get("mode") == mode]
        return out

    def replans_after_fault(self, fault_kind: str) -> List[dict]:
        """``replan.end`` payloads that appear in the journal AFTER the
        first scripted fault of the given kind (journal order — the
        assertion vocabulary for 'the refresh after the drift served
        warm')."""
        fault_idx = None
        out = []
        for i, e in enumerate(self.journal):
            if (
                fault_idx is None
                and e["kind"] == "sim.fault"
                and e.get("payload", {}).get("fault") == fault_kind
            ):
                fault_idx = i
            elif fault_idx is not None and e["kind"] == "replan.end":
                out.append(e.get("payload", {}))
        return out

    def heal_latency_percentiles(self, pcts=(50, 99)) -> Dict[int, int]:
        """Fault→fix latency percentiles (virtual ms, journal order) —
        the SLO engine's heal-latency samples over this run's journal.
        Empty dict when no fix ever started."""
        from cruise_control_tpu_torch.telemetry import slo as slo_mod

        samples = slo_mod.heal_latencies_ms(self.journal)
        if not samples:
            return {}
        return {
            int(q): int(slo_mod.percentile(samples, q)) for q in pcts
        }

    def slo_report(self, objectives=None):
        """Evaluate the whole SLO registry over this run's journal
        (virtual clock, journal order — no registry snapshot): the gate
        table ROADMAP item 5's soak consumes, and what scenario
        assertions use instead of re-deriving latencies by hand."""
        from cruise_control_tpu_torch.telemetry import slo as slo_mod

        return slo_mod.evaluate_slos(
            self.journal, snapshot=None, objectives=objectives,
            window_ms=None, source="scenario",
            horizon_ms=float(self.duration_virtual_ms),
        )

    def heal_outcome(self) -> str:
        """Classify the run from the journal alone: HEALED / FIX_FAILED /
        ALERT_ONLY / SUPPRESSED / UNHEALED / NO_ANOMALY.

        A successfully *resumed* checkpoint recovery counts as a started
        fix: the crash interrupted a self-healing execution mid-flight and
        the restarted process finished it — the crashed process never got
        to journal a fix outcome, but the recovery records tell the same
        story (journal order stands in for time: recovery events carry no
        virtual clock)."""
        decisions = []  # (journal_idx, detector decision payload)
        fix_marks = []  # journal_idx of fixes started + resumed recoveries
        for i, e in enumerate(self.journal):
            kind = e["kind"]
            if (kind == "detector.anomaly"
                    or kind.startswith("detector.anomaly.")):
                p = e.get("payload", {})
                decisions.append((i, p))
                if p.get("fixStarted"):
                    fix_marks.append(i)
            elif kind == "execution.recovery.end":
                p = e.get("payload", {})
                if p.get("outcome") == "resumed" and p.get("succeeded"):
                    fix_marks.append(i)
        if not decisions and not fix_marks:
            return "NO_ANOMALY"
        last_fix = max(fix_marks, default=None)
        if last_fix is not None:
            failed_after = any(
                p.get("action") == "FIX_FAILED"
                for i, p in decisions if i > last_fix
            )
            if not failed_after:
                return "HEALED"
        actions = {p.get("action") for _, p in decisions}
        if "FIX_FAILED" in actions:
            return "FIX_FAILED"
        if actions <= {"IGNORE"}:
            return "ALERT_ONLY"
        if actions <= {"IGNORE", "CHECK", "FIX_DELAYED_COOLDOWN",
                       "FIX_DELAYED_ONGOING_EXECUTION"}:
            return "SUPPRESSED"
        return "UNHEALED"

    def fingerprint(self) -> str:
        return journal_fingerprint(self.journal)


def journal_fingerprint(journal: Sequence[dict]) -> str:
    """SHA-256 over the journal with wall-clock fields stripped — equal
    across runs of the same seeded scenario (the determinism contract)."""
    h = hashlib.sha256()
    for rec in journal:
        r = {k: v for k, v in rec.items() if k not in _VOLATILE_KEYS}
        if "payload" in r:
            r["payload"] = {
                k: v for k, v in r["payload"].items()
                if k not in _VOLATILE_PAYLOAD_KEYS
            }
        h.update(json.dumps(r, sort_keys=True, default=str).encode())
        h.update(b"\n")
    return h.hexdigest()


# ---------------------------------------------------------------------------------
@contextlib.contextmanager
def _scenario_journal(ring_size: int = 1 << 15, path: Optional[str] = None,
                      max_bytes: int = 16 * 1024 * 1024, max_files: int = 3,
                      clock=None):
    """Swap a dedicated EventJournal in for the run, so scenario records
    never mix with (or leak into) the process-wide journal.  ``clock``
    injects the run's virtual clock as the ``ts`` source — ts-windowed
    readers (the SLO engine's sliding window) then follow the scenario
    clock, not the host's.  ``path`` adds file-backed size rotation (the
    soak's retention exercise); scenarios stay in-memory."""
    prev = events.JOURNAL
    events.JOURNAL = EventJournal(
        enabled=True, ring_size=ring_size, path=path,
        max_bytes=max_bytes, max_files=max_files, clock=clock,
        # real-wall-clock telemetry kinds are inadmissible in a
        # virtual-clock journal: a bootstrap SLO engine elsewhere in the
        # process (real clock, maintenance hooks) may pump the contention
        # detector / host-profile parser mid-run, and those emissions
        # would land HERE nondeterministically and break the pinned
        # scenario/soak fingerprints.  The sim drivers never pump either
        # on purpose (bootstrap comment: "never the sim").
        exclude_kinds=frozenset(
            {"contention.hot_lock", "profiler.host.parsed"}),
    )
    try:
        yield events.JOURNAL
    finally:
        events.JOURNAL.close()
        events.JOURNAL = prev


def _script_analyzer_outage(cc) -> None:
    """Swap the facade's engine factory for one that always fails — the
    scripted analyzer outage (the serving layer's chaos seam; the cluster
    seams stay the backend/workload as ever)."""

    class _FailingOptimizer:
        def optimize(self, state, options=None, **kwargs):
            raise RuntimeError("scripted analyzer outage")

    cc._make_engine = lambda engine, constraint=None: _FailingOptimizer()


def _restore_analyzer(cc) -> None:
    if "_make_engine" in cc.__dict__:
        del cc.__dict__["_make_engine"]


def _script_engine_failure(cc) -> None:
    """Swap the facade's engine factory for one whose cuda engine always
    raises (device OOM stand-in) while the greedy engine stays real — the
    seam the engine degradation ladder is chaos-tested through.  The
    class name and the message are the reference's, so the journal keeps
    its bytes."""

    class _FailingTpuOptimizer:
        def optimize(self, state, options=None, **kwargs):
            raise RuntimeError(
                "scripted TPU engine failure: RESOURCE_EXHAUSTED: out of "
                "memory while trying to allocate device buffers"
            )

    orig = type(cc)._make_engine

    def make(engine, constraint=None):
        if (engine or cc.default_engine) == "cuda":
            return _FailingTpuOptimizer()
        return orig(cc, engine, constraint)

    cc._make_engine = make


def _restore_engine(cc) -> None:
    if "_make_engine" in cc.__dict__:
        del cc.__dict__["_make_engine"]


class _Sim:
    """The assembled stack plus scripting state for one run.

    The *cluster* (backend, workload ground truth, maintenance stream) is
    built once and survives process crashes; the *control plane* (monitor
    → facade → executor → detector manager) is built by
    :meth:`_build_control_plane` and rebuilt from scratch on
    ``restart_process`` — a restarted process starts with empty metric
    windows and recovers only what the execution checkpoint persisted,
    exactly like a real redeploy."""

    def __init__(self, spec: ScenarioSpec, device="cuda"):
        self.spec = spec
        #: the card the facade's cuda and what-if engines run on; the
        #: sim's cluster states stay on the CPU
        self.device = device
        state = random_cluster(
            seed=spec.seed,
            num_brokers=spec.num_brokers,
            num_racks=spec.num_racks,
            num_topics=spec.num_topics,
            num_partitions=spec.num_partitions,
            replication_factor=spec.replication_factor,
            rack_aware=True,
        )
        self.workload = ScenarioWorkload(
            state,
            diurnal_amplitude=spec.diurnal_amplitude,
            diurnal_period_ms=spec.diurnal_period_ms,
            drift_per_hour=spec.drift_per_hour,
        )
        w = self.workload.model
        self.backend = ScriptedClusterBackend(
            {p: list(r) for p, r in w.assignment.items()},
            dict(w.leaders),
            brokers=set(range(spec.num_brokers)),
            broker_racks={
                b: int(state.broker_rack[b]) for b in range(spec.num_brokers)
            },
            move_latency_ticks=spec.move_latency_ticks,
        )
        #: armed kills/flaps journal the moment they FIRE, at the real
        #: virtual time (heal-latency pairing reads the firing, not the arm)
        self.backend.clock_ms = lambda: self.now_ms
        self._partition_topic = {
            p: f"topic_{int(state.partition_topic[p])}" for p in w.assignment
        }
        # capacities are sized ONCE from the pristine workload: a process
        # restart must not resize the cluster
        self._capacity_resolver = _capacity_for(
            w, spec.num_brokers, target_mean_util=spec.mean_utilization
        )
        self.maintenance = MaintenanceEventReader()
        #: execution checkpoint location; survives restarts (the path never
        #: enters the event journal, so fingerprints stay deterministic)
        self._checkpoint_path = (
            os.path.join(tempfile.mkdtemp(prefix="cc-sim-ckpt-"),
                         "execution.ckpt.jsonl")
            if spec.checkpoint else None
        )
        self.process_up = True
        #: metric-gap windows [(start_ms, end_ms)), virtual
        self.gaps: List[tuple] = []
        #: poisoned-metrics windows [(start_ms, end_ms, broker)), virtual
        self.poisons: List[tuple] = []
        #: the virtual clock, readable by injected clocks (the breaker)
        self.now_ms = 0
        #: scripted analyzer failure window (analyzer_outage event);
        #: survives restarts — the outage outlives the process
        self.analyzer_down = False
        #: scripted cuda-engine failure window (fail_engine event);
        #: survives restarts for the same reason
        self.engine_down = False
        #: deterministic User-Task-ID source (uuid4 would make every
        #: journal fingerprint unreproducible)
        self._task_seq = 0
        #: deterministic X-Trace-Id source, same contract: trace ids land
        #: on journal records, so they must be seed-stable.  Sim-level
        #: (not control-plane) so a process restart keeps counting.
        self._trace_seq = 0
        self.server: Optional[CruiseControlHttpServer] = None
        self.precompute: Optional[ProposalPrecomputingExecutor] = None
        #: the checkpoint as the CRASHED process last saw it — the stale
        #: view a zombie_controller_resume event resumes from
        self._zombie_checkpoint = None
        self._build_control_plane()

    def _executor_config(self) -> ExecutorConfig:
        spec = self.spec
        return ExecutorConfig(
            task_timeout_ticks=spec.executor_task_timeout_ticks,
            num_concurrent_partition_movements_per_broker=(
                spec.executor_moves_per_broker
            ),
            task_retry_max_attempts=spec.task_retry_attempts,
            task_retry_backoff_base_ticks=(
                spec.task_retry_backoff_base_ticks
            ),
            task_retry_backoff_max_ticks=spec.task_retry_backoff_max_ticks,
            task_retry_jitter_ticks=spec.task_retry_jitter_ticks,
            dest_exclusion_threshold=spec.dest_exclusion_threshold,
            watchdog_stuck_ticks=spec.watchdog_stuck_ticks,
            foreign_conflict_policy=spec.foreign_conflict_policy,
            foreign_yield_backoff_ticks=spec.foreign_yield_backoff_ticks,
        )

    def _build_control_plane(self) -> None:
        spec = self.spec
        metadata = BackendMetadataClient(
            self.backend,
            self.backend.broker_racks,  # shared: add_broker updates both
            partition_topic=self._partition_topic,
        )
        self.topic = MetricsTopic()
        self.reporter = SimulatedMetricsReporter(self.workload.model,
                                                 self.topic)
        # a private registry: scenario runs must not pollute the process
        # default the server / other tests read.  Shared by the monitor's
        # sample validator and the facade, so quarantine meters and the
        # SLO engine see one world.
        registry = MetricRegistry()
        from cruise_control_tpu_torch.monitor.sampling import (
            SampleValidationConfig,
            SampleValidator,
        )

        self.monitor = LoadMonitor(
            metadata,
            MetricsReporterSampler(self.topic),
            capacity_resolver=self._capacity_resolver,
            window_ms=spec.tick_ms,
            num_windows=5,
            sample_validator=SampleValidator(
                SampleValidationConfig(
                    storm_min_samples=spec.quarantine_storm_min_samples,
                    storm_window_batches=(
                        spec.quarantine_storm_window_batches
                    ),
                ),
                registry=registry,
            ),
        )
        journal = (
            ExecutionJournal(self._checkpoint_path)
            if self._checkpoint_path else None
        )
        self.executor = Executor(
            self.backend, self._executor_config(), journal=journal,
        )
        breaker = None
        if spec.breaker_failures > 0:
            # virtual-clock breaker: trip/reset timing is deterministic
            breaker = CircuitBreaker(
                failure_threshold=spec.breaker_failures,
                reset_s=spec.breaker_reset_ms / 1000.0,
                clock=lambda: self.now_ms / 1000.0,
            )
        from cruise_control_tpu_torch.analyzer.degradation import (
            EngineDegradation,
        )

        self.cc = CruiseControl(
            self.monitor, self.executor, engine=spec.engine,
            device=self.device, registry=registry, breaker=breaker,
            replan_heals=spec.replan_heal,
            # the cuda→greedy ladder on the VIRTUAL clock, so degradation
            # cooldowns are deterministic scenario facts
            engine_degradation=EngineDegradation(
                cooldown_s=spec.engine_degraded_cooldown_ms / 1000.0,
                clock=lambda: self.now_ms / 1000.0,
            ),
        )
        if spec.replan_enabled:
            from cruise_control_tpu_torch.replan import (
                DeltaReplanner,
                ReplanConfig,
            )

            # a restart rebuilds this cold (fresh monitor windows mean a
            # fresh snapshot anyway) — exactly like a real redeploy
            self.cc.replanner = DeltaReplanner(
                self.monitor,
                ReplanConfig(
                    dirty_partition_budget_ratio=spec.replan_budget_ratio,
                    dirty_load_rel_threshold=spec.replan_load_threshold,
                ),
            )
        if self.analyzer_down:
            _script_analyzer_outage(self.cc)
        if self.engine_down:
            _script_engine_failure(self.cc)
        from cruise_control_tpu_torch.detector.detectors import (
            PercentileMetricAnomalyFinder,
        )

        per_type_interval = {}
        if spec.metric_anomaly_interval_ms:
            per_type_interval[AnomalyType.METRIC_ANOMALY] = int(
                spec.metric_anomaly_interval_ms
            )
        self.manager = make_detector_manager(
            self.cc,
            backend=self.backend,
            notifier=SelfHealingNotifier(
                enabled=spec.healing_enables(),
                broker_failure_alert_threshold_ms=(
                    spec.broker_failure_alert_ms
                ),
                broker_failure_self_healing_threshold_ms=(
                    spec.broker_failure_heal_ms
                ),
            ),
            target_rf=spec.target_rf,
            maintenance_reader=self.maintenance,
            metric_finder=PercentileMetricAnomalyFinder(
                margin=spec.metric_anomaly_margin,
                min_windows=spec.metric_anomaly_min_windows,
            ),
            detection_goal_names=(
                list(spec.detection_goals) if spec.detection_goals else None
            ),
            self_healing_goal_names=(
                list(spec.healing_goals) if spec.healing_goals else None
            ),
            detection_interval_ms=spec.detection_interval_ms,
            fix_cooldown_ms=spec.fix_cooldown_ms,
            per_type_interval_ms=per_type_interval or None,
        )
        if spec.serve_http:
            # the REAL front door: one worker thread + a deterministic
            # task-id counter keep sequential-request journals
            # bit-reproducible (concurrent storms opt out of fingerprints)
            def next_task_id() -> str:
                self._task_seq += 1
                return f"sim-task-{self._task_seq}"

            def next_trace_id() -> str:
                self._trace_seq += 1
                return f"sim-trace-{self._trace_seq}"

            self.server = CruiseControlHttpServer(
                self.cc, port=0, access_log=False,
                user_task_manager=UserTaskManager(
                    max_workers=1, id_factory=next_task_id,
                ),
                trace_id_factory=next_trace_id,
                get_max_concurrent=spec.http_get_concurrent,
                compute_max_concurrent=spec.http_compute_concurrent,
                admission_queue_size=spec.http_queue_size,
                admission_queue_timeout_s=(
                    spec.http_queue_timeout_ms / 1000.0
                ),
                read_timeout_s=spec.http_read_timeout_ms / 1000.0,
                drain_timeout_s=2.0,
            )
            self.server.start()
        if spec.precompute_interval_ticks > 0:
            # built but never start()ed: run_scenario drives refresh_once
            # synchronously on the virtual clock
            self.precompute = ProposalPrecomputingExecutor(self.cc)
        self.proactive = None
        if spec.proactive_enabled:
            # built but never start()ed: run_scenario records samples and
            # calls maybe_trigger on the virtual clock, so forecast →
            # what-if → pre-peak rebalance is a deterministic journal fact
            from cruise_control_tpu_torch.whatif.proactive import (
                ProactiveScheduler,
            )

            self.proactive = ProactiveScheduler(
                self.cc,
                period_ms=spec.diurnal_period_ms,
                horizon_ms=spec.proactive_horizon_ms,
                threshold=spec.proactive_threshold,
                cooldown_ms=spec.proactive_cooldown_ms,
                min_samples=spec.proactive_min_samples,
                clock=lambda: self.now_ms,
            )

    def crash(self) -> None:
        """SIGKILL semantics: the front door vanishes with the process —
        no drain, no task-pool shutdown, connections just die."""
        self.process_up = False
        if self._checkpoint_path and os.path.exists(self._checkpoint_path):
            # snapshot the checkpoint exactly as the dying process left it:
            # a later zombie_controller_resume replays THIS stale view,
            # after the restarted process has moved the file (and the
            # cluster epoch) past it
            try:
                self._zombie_checkpoint = ExecutionJournal(
                    self._checkpoint_path
                ).load()
            except Exception:
                self._zombie_checkpoint = None
        self._halt_server()

    def zombie_resume(self) -> Dict[str, object]:
        """The dead process's stale incarnation thaws and re-resumes its
        checkpoint.  With the restarted process's conditional epoch claim
        already registered cluster-side, the zombie's CAS must be refused
        (StaleControllerEpochError + executor.fenced) before it mutates
        anything."""
        from cruise_control_tpu_torch.executor.backend import (
            StaleControllerEpochError,
        )

        ck = self._zombie_checkpoint
        if ck is None:
            return {"zombie": "no-checkpoint"}
        zombie = Executor(self.backend, self._executor_config(),
                          journal=None)
        try:
            res = zombie.resume(ck)
        except StaleControllerEpochError:
            return {"zombie": "fenced", "checkpointEpoch": ck.epoch}
        return {"zombie": "resumed", "completed": res.completed}

    def _halt_server(self) -> None:
        if self.server is not None and self.server._httpd is not None:
            self.server._httpd.shutdown()
            self.server._httpd.server_close()
            self.server._httpd = None

    def stop_serving(self) -> None:
        """End-of-scenario teardown (graceful, unlike crash)."""
        if self.server is not None:
            if self.server._httpd is not None:
                self.server.stop()
            self.server = None

    def restart(self) -> None:
        """The 'new process': fresh monitor windows, fresh detector state,
        fresh executor — then the facade's checkpoint recovery path, which
        resumes whatever the dead process left in flight."""
        self._halt_server()
        self._build_control_plane()
        self.cc.recover_execution()
        self.process_up = True

    def in_gap(self, now_ms: int) -> bool:
        return any(start <= now_ms < end for start, end in self.gaps)

    # ---- data-integrity chaos (ISSUE 13) ----------------------------------------
    def emit_poisoned_metrics(self, time_ms: int, now_ms: int) -> None:
        """Produce the byzantine records an active ``corrupt_metrics``
        window scripts: a NaN BROKER_CPU_UTIL for the poisoned broker
        (produced AFTER the honest records, so the processor's
        last-wins dict adopts it — exactly the unchecked-reporter bug
        class) plus a record for a broker metadata has never seen."""
        from cruise_control_tpu_torch.monitor.sampling import (
            CruiseControlMetric,
            RawMetricType,
        )

        for start, end, broker in self.poisons:
            if not (start <= now_ms < end):
                continue
            unknown = self.spec.num_brokers + 41
            self.topic.produce([
                CruiseControlMetric(
                    RawMetricType.BROKER_CPU_UTIL, time_ms, broker,
                    float("nan"),
                ),
                CruiseControlMetric(
                    RawMetricType.BROKER_CPU_UTIL, time_ms, unknown, 55.0,
                ),
            ])

    def corrupt_checkpoint_file(self, line: int) -> Optional[int]:
        """Flip one byte (XOR 0x01) in the middle of non-empty line
        ``line`` of the execution checkpoint; returns the damaged line
        index, or None when the file is too short to have a mid-file
        line (corruption must stay off the torn-tail path)."""
        path = self._checkpoint_path
        if path is None or not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            raw = f.read().split(b"\n")
        nonempty = [i for i, seg in enumerate(raw) if seg.strip()]
        if len(nonempty) < 2:
            return None
        # clip to the penultimate non-empty line: the FINAL line is the
        # torn-tail case, which load() tolerates by design
        target = nonempty[min(max(0, line), len(nonempty) - 2)]
        seg = bytearray(raw[target])
        seg[len(seg) // 2] ^= 0x01
        raw[target] = bytes(seg)
        with open(path, "wb") as f:
            f.write(b"\n".join(raw))
        return nonempty.index(target)

    # ---- HTTP drivers (serving-layer chaos) -------------------------------------
    def _request(self, method: str, endpoint: str, params: Dict[str, str],
                 deadline_ms: Optional[int] = None,
                 timeout_s: float = 60.0) -> dict:
        """One real HTTP request; returns {status, retryAfter, body} with
        status 0 when the process/server is unreachable (crashed)."""
        import urllib.error
        import urllib.parse
        import urllib.request

        if self.server is None:
            raise RuntimeError("scenario spec must set serve_http=True")
        params = dict(params)
        if method == "POST" and endpoint not in ("stop_proposal_execution",
                                                 "pause_sampling",
                                                 "resume_sampling", "admin",
                                                 "review", "train"):
            # long-poll: the virtual clock must not advance while an async
            # operation is mid-flight — the tick blocks on the result
            params.setdefault("get_response_timeout_s", "55")
        if endpoint == "health":
            url = f"http://127.0.0.1:{self.server.port}/health"
        else:
            url = f"{self.server.url}/{endpoint}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = {}
        if deadline_ms is not None:
            headers["deadline-ms"] = str(deadline_ms)
        req = urllib.request.Request(
            url, method=method, headers=headers,
            data=b"" if method == "POST" else None,
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                raw = resp.read()
                status, hdrs = resp.status, dict(resp.headers)
        except urllib.error.HTTPError as e:
            raw = e.read()
            status, hdrs = e.code, dict(e.headers)
        except (urllib.error.URLError, ConnectionError, OSError):
            return {"status": 0, "retryAfter": None, "body": {}}
        try:
            body = json.loads(raw) if raw else {}
        except ValueError:
            body = {}
        return {
            "status": status,
            "retryAfter": hdrs.get("Retry-After"),
            "body": body,
        }

    def _slow_client_probe(self, hold_s: float) -> dict:
        """Open a connection, trickle a partial request, and report
        whether the server reaped it within the wall-clock bound."""
        import socket

        if self.server is None:
            raise RuntimeError("scenario spec must set serve_http=True")
        t0 = time.monotonic()
        closed = False
        with socket.create_connection(
            ("127.0.0.1", self.server.port), timeout=hold_s + 5
        ) as sock:
            sock.sendall(b"GET " + self.server.prefix.encode()
                         + b"/state HTTP/1.1\r\nHost: sim\r\n")
            # never finish the headers; the read timeout must reap us
            deadline = time.monotonic() + hold_s + 3
            sock.settimeout(0.25)
            while time.monotonic() < deadline:
                try:
                    if sock.recv(4096) == b"":
                        closed = True
                        break
                except TimeoutError:
                    continue
                except (ConnectionError, OSError):
                    closed = True
                    break
        return {
            "closed": closed,
            "elapsedS": round(time.monotonic() - t0, 3),
        }


def _apply_event(sim: _Sim, ev: TimelineEvent, now_ms: int) -> None:
    """Apply one timeline event and journal it with its virtual time."""
    detail: Dict[str, object] = {}
    if ev.kind == "kill_broker":
        sim.backend.kill_broker(ev.arg("broker"))
    elif ev.kind == "restore_broker":
        sim.backend.restore_broker(ev.arg("broker"))
    elif ev.kind == "kill_broker_mid_execution":
        sim.backend.arm_kill_mid_execution(
            ev.arg("broker"), ev.arg("after_ticks")
        )
    elif ev.kind == "rack_loss":
        detail["brokers"] = sim.backend.kill_rack(ev.arg("rack"))
    elif ev.kind == "disk_failure":
        sim.backend.fail_disk(ev.arg("broker"), ev.arg("dirs"))
    elif ev.kind == "restore_disk":
        sim.backend.restore_disk(ev.arg("broker"))
    elif ev.kind == "hot_partition_skew":
        parts = ev.arg("partitions")
        if parts is None:
            leader = ev.arg("leader")
            parts = sorted(
                p for p, st in sim.backend.partitions.items()
                if st.leader == leader
            )
        detail["partitions"] = list(parts)
        sim.workload.apply_skew(parts, ev.arg("factor"))
    elif ev.kind == "perturb_broker_load":
        broker = ev.arg("broker")
        parts = sorted(
            p for p, st in sim.backend.partitions.items()
            if broker in st.replicas
        )
        detail["partitions"] = list(parts)
        sim.workload.apply_skew(parts, ev.arg("factor"))
    elif ev.kind == "add_broker":
        sim.backend.add_broker(ev.arg("broker"), ev.arg("rack"))
    elif ev.kind == "maintenance_event":
        sim.maintenance.submit(ev.arg("event_type"), ev.arg("brokers"))
    elif ev.kind == "metric_gap":
        sim.gaps.append((ev.at_ms, ev.at_ms + ev.arg("duration_ms")))
    elif ev.kind == "stall_execution":
        sim.backend.stall_next_batches(ev.arg("ticks"),
                                       ev.arg("batches", 1))
    elif ev.kind == "fail_partition":
        sim.backend.fail_partitions.add(ev.arg("partition"))
    elif ev.kind == "crash_process":
        sim.backend.arm_crash_mid_execution(ev.arg("after_ticks"))
    elif ev.kind == "flap_broker":
        sim.backend.arm_flap_mid_execution(
            ev.arg("broker"), ev.arg("down_ticks"), ev.arg("up_ticks"),
            ev.arg("cycles"),
        )
    elif ev.kind == "analyzer_outage":
        sim.analyzer_down = True
        _script_analyzer_outage(sim.cc)
    elif ev.kind == "restore_analyzer":
        sim.analyzer_down = False
        _restore_analyzer(sim.cc)
    elif ev.kind == "corrupt_metrics":
        sim.poisons.append(
            (ev.at_ms, ev.at_ms + ev.arg("duration_ms"), ev.arg("broker"))
        )
    elif ev.kind == "corrupt_checkpoint":
        corrupted = sim.corrupt_checkpoint_file(ev.arg("line", 1))
        detail["corruptedLine"] = corrupted
    elif ev.kind == "fail_engine":
        sim.engine_down = True
        _script_engine_failure(sim.cc)
    elif ev.kind == "restore_engine":
        sim.engine_down = False
        _restore_engine(sim.cc)
    elif ev.kind == "foreign_reassignment":
        after = ev.arg("after_ticks")
        if after is not None:
            sim.backend.arm_foreign_reassignment(
                ev.arg("partition"), ev.arg("conflict", False), after,
            )
        else:
            detail["applied"] = sim.backend.foreign_reassign(
                ev.arg("partition"), ev.arg("conflict", False),
            )
    elif ev.kind == "zombie_controller_resume":
        detail.update(sim.zombie_resume())
    elif ev.kind == "create_topic":
        n = ev.arg("partitions")
        rf = ev.arg("replication_factor", 2)
        topic = ev.arg("topic")
        # ids come from the topic map, which never forgets: a DELETED
        # partition's id must not be recycled (the monitor's aggregate
        # history is keyed by id)
        next_p = max(sim._partition_topic, default=-1) + 1
        alive = sorted(sim.backend.alive_brokers())
        assignment = {}
        leaders = {}
        for i in range(n):
            p = next_p + i
            reps = [alive[(i + j) % len(alive)]
                    for j in range(min(rf, len(alive)))]
            assignment[p] = reps
            leaders[p] = reps[0]
            # shared dict: the metadata client sees the new topic at once
            sim._partition_topic[p] = topic
        sim.backend.create_partitions(assignment, leaders)
        sim.workload.add_partitions(n)
        detail["partitions"] = sorted(assignment)
    elif ev.kind == "delete_topic":
        topic = ev.arg("topic")
        parts = sorted(
            p for p, t in sim._partition_topic.items()
            if t == topic and p in sim.backend.partitions
        )
        detail["partitions"] = parts
        after = ev.arg("after_ticks")
        if after is not None:
            sim.backend.arm_delete_partitions(parts, after)
        else:
            sim.backend.delete_partitions(parts)
    elif ev.kind == "http_request":
        events.emit("sim.fault", fault=ev.kind, virtualMs=now_ms,
                    atMs=ev.at_ms, args=dict(ev.args))
        _apply_http_request(sim, ev, now_ms)
        return
    elif ev.kind == "request_storm":
        events.emit("sim.fault", fault=ev.kind, virtualMs=now_ms,
                    atMs=ev.at_ms, args=dict(ev.args))
        _apply_request_storm(sim, ev, now_ms)
        return
    elif ev.kind == "slow_client":
        probe = sim._slow_client_probe(ev.arg("hold_s"))
        events.emit("sim.fault", fault=ev.kind, virtualMs=now_ms,
                    atMs=ev.at_ms, args=dict(ev.args))
        events.emit("sim.http_slow_client", virtualMs=now_ms, **probe)
        return
    elif ev.kind == "restart_process":
        # the fault marker goes first so the journal reads operator-style:
        # restart → recovery.start → executor.resume → recovery.end
        events.emit(
            "sim.fault", fault=ev.kind, virtualMs=now_ms, atMs=ev.at_ms,
            args=dict(ev.args), wasDown=not sim.process_up,
        )
        if not sim.process_up:
            sim.restart()
        return
    else:  # constructors validate kinds; this guards future drift
        raise ValueError(f"unhandled timeline event kind {ev.kind!r}")
    events.emit(
        "sim.fault", fault=ev.kind, virtualMs=now_ms, atMs=ev.at_ms,
        args=dict(ev.args), **detail,
    )


def _apply_http_request(sim: _Sim, ev: TimelineEvent, now_ms: int) -> None:
    """One synchronous request; the response becomes a ``sim.http``
    journal event.  A 500 carrying the armed ProcessCrash means the
    control plane died mid-request — the sim marks the process down
    exactly as it does for a crash inside the detection cycle."""
    if not sim.process_up:
        res = {"status": 0, "retryAfter": None, "body": {}}
    else:
        t0 = time.monotonic()
        res = sim._request(
            ev.arg("method", "GET"), ev.arg("endpoint"),
            dict(ev.arg("params", ())),
            deadline_ms=ev.arg("deadline_ms"),
        )
        res["latencyMs"] = round((time.monotonic() - t0) * 1000, 3)
    body = res.pop("body", {}) or {}
    err = body.get("errorMessage")
    events.emit(
        "sim.http", virtualMs=now_ms,
        endpoint=ev.arg("endpoint"), method=ev.arg("method", "GET"),
        status=res["status"], retryAfter=res.get("retryAfter"),
        cached=body.get("cached"), stale=body.get("stale"),
        ready=body.get("ready"),
        latencyMs=res.get("latencyMs"),
        error=(str(err)[:120] if err else None),
    )
    if res["status"] == 500 and err and "ProcessCrash" in str(err):
        sim.crash()
        events.emit("sim.crash", severity="ERROR", virtualMs=now_ms)


def _apply_request_storm(sim: _Sim, ev: TimelineEvent, now_ms: int) -> None:
    """N concurrent clients; ONE aggregated journal event (per-request
    ordering under concurrency is nondeterministic by nature)."""
    from concurrent.futures import ThreadPoolExecutor

    n = ev.arg("n")
    method = ev.arg("method", "GET")
    endpoint = ev.arg("endpoint")
    params = dict(ev.arg("params", ()))

    def one(_: int) -> dict:
        return sim._request(method, endpoint, dict(params))

    if sim.process_up:
        with ThreadPoolExecutor(max_workers=n) as pool:
            results = list(pool.map(one, range(n)))
    else:
        # the storm hits a crashed process: every connection dies at the
        # socket, which is the CRASH's signature (sim.crash is on the
        # record), not a serving-layer 5xx — counted as unreachable
        results = [{"status": 0, "retryAfter": None} for _ in range(n)]
    status_counts: Dict[str, int] = {}
    shed_with_retry = shed_without_retry = server_errors = ok = 0
    unreachable = 0
    for r in results:
        status_counts[str(r["status"])] = \
            status_counts.get(str(r["status"]), 0) + 1
        if r["status"] in (429, 503):
            if r.get("retryAfter"):
                shed_with_retry += 1
            else:
                shed_without_retry += 1
        elif r["status"] == 0:
            unreachable += 1
        elif r["status"] >= 500:
            server_errors += 1
        elif 200 <= r["status"] < 300:
            ok += 1
    events.emit(
        "sim.http_storm", virtualMs=now_ms, endpoint=endpoint,
        method=method, clients=n,
        statusCounts={k: status_counts[k] for k in sorted(status_counts)},
        admitted=ok, shedWithRetryAfter=shed_with_retry,
        shedMissingRetryAfter=shed_without_retry,
        unhandled5xx=server_errors, unreachable=unreachable,
    )


def run_scenario(spec: ScenarioSpec, on_tick=None,
                 device="cuda") -> ScenarioResult:
    """Drive one scenario to completion and return the journal-backed
    result.  Deterministic: same spec (incl. seed) ⇒ same fingerprint.

    ``on_tick(sim, now_ms)`` runs at the end of every tick (the soak
    driver's seam: resource sampling, rolling SLO evaluation, placement
    invariants) — it must not mutate the system under test.  The journal's
    ``ts`` field follows the VIRTUAL clock for the whole run (it is
    volatile for fingerprints either way), so ts-windowed readers see
    scenario time.  ``device`` is the card the facade's cuda and what-if
    engines run on ("cpu" runs them on their kernels' plain twins); it
    raises when a card is asked for and none is present."""
    resolve_device(device)
    if spec.kernel_capture_scans > 0:
        raise NotImplementedError(
            f"kernel_capture_scans={spec.kernel_capture_scans}: the kernel "
            "observatory is not ported yet (ROADMAP A10)"
        )
    spec.timeline.reset()
    clock_ms = [0.0]
    with _scenario_journal(
        ring_size=spec.journal_ring_size, path=spec.journal_path,
        max_bytes=spec.journal_max_bytes, max_files=spec.journal_max_files,
        clock=lambda: clock_ms[0] / 1000.0,
    ) as journal:
        sim = _Sim(spec, device=device)
        events.emit(
            "sim.scenario_start", name=spec.name, seed=spec.seed,
            brokers=spec.num_brokers, partitions=spec.num_partitions,
            racks=spec.num_racks, rf=spec.replication_factor,
            durationMs=spec.duration_ms, tickMs=spec.tick_ms,
            description=spec.description,
        )
        LOG.info("scenario %s starting: %d brokers / %d partitions, %d "
                 "events", spec.name, spec.num_brokers, spec.num_partitions,
                 len(spec.timeline))
        now = 0
        ticks = 0
        while now < spec.duration_ms:
            now += spec.tick_ms
            ticks += 1
            sim.now_ms = now  # injected clocks (the breaker) read this
            clock_ms[0] = float(now)  # the journal's ts source
            for ev in spec.timeline.pop_due(now):
                _apply_event(sim, ev, now)
            sim.workload.advance(now)
            sim.workload.sync_topology(sim.backend)
            if sim.process_up:
                if not sim.in_gap(now):
                    report_ms = now - spec.tick_ms // 2
                    sim.reporter.report(time_ms=report_ms)
                    # byzantine-input windows poison the topic AFTER the
                    # honest report, exactly like a misbehaving reporter
                    sim.emit_poisoned_metrics(report_ms, now)
                sim.monitor.run_sampling_iteration(now)
                if sim.proactive is not None:
                    # forecast-driven proactive control, virtual-clocked:
                    # sample the synthesizer's ground-truth total rate,
                    # refit the diurnal model, maybe pre-empt the peak
                    sim.proactive.record(
                        now, sim.workload.observed_total_rate()
                    )
                    sim.proactive.maybe_trigger(now)
                try:
                    sim.manager.run_detection_cycle(now)
                except ProcessCrash:
                    # the armed crash fired inside the executor drive loop:
                    # the whole control plane is gone; only the cluster
                    # (backend) and the frozen checkpoint survive
                    sim.crash()
                    events.emit("sim.crash", severity="ERROR",
                                virtualMs=now)
                if (sim.process_up and sim.precompute is not None
                        and ticks % spec.precompute_interval_ticks == 0):
                    # the precompute daemon's loop, on the virtual clock
                    sim.precompute.refresh_once()
            else:
                # the process is down but the cluster lives on: in-flight
                # reassignments keep progressing, brokers keep flapping
                sim.backend.tick()
            if on_tick is not None:
                on_tick(sim, now)
        sim.stop_serving()  # graceful drain (journaled) before the end mark
        events.emit(
            "sim.scenario_end", name=spec.name, virtualMs=now, ticks=ticks,
            actionCounts=sim.manager.action_counts(),
        )
        records = journal.recent()
    return ScenarioResult(
        spec=spec, journal=records, ticks=ticks, duration_virtual_ms=now,
    )

"""The six anomaly detectors (upstream ``detector/*Detector.java`` +
finder SPIs; SURVEY.md §2.8, call stack §3.4).

Each detector is a pure ``detect(now_ms) -> List[Anomaly]`` pass over the
live system (metadata / model / broker metrics / maintenance stream); the
:class:`AnomalyDetectorManager` schedules them and routes results through the
notifier.  Tick-driven, no hidden threads — a production scheduler thread
drives the manager, tests drive it directly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    BrokerFailures,
    DiskFailures,
    ForeignReassignments,
    GoalViolations,
    MaintenanceEvent,
    MetricAnomaly,
    TopicAnomaly,
)
from cruise_control_tpu_torch.monitor.load_monitor import NotEnoughValidWindowsError


class GoalViolationDetector:
    """Checks each self-healing goal's violation predicate on a fresh model
    (upstream ``GoalViolationDetector``: optimize-on-clone; here the goals
    expose ``violations()`` directly, so no clone mutation is needed)."""

    def __init__(self, cruise_control, goal_names: Optional[Sequence[str]] = None,
                 fix_goal_names: Optional[Sequence[str]] = None,
                 threshold_multiplier: float = 1.0):
        self.cc = cruise_control
        self.goal_names = list(goal_names) if goal_names else None
        #: self.healing.goals: goal subset the FIX runs with (None = the
        #: instance's full default stack)
        self.fix_goal_names = list(fix_goal_names) if fix_goal_names else None
        #: goal.violation.distribution.threshold.multiplier (upstream
        #: AnomalyDetectorConfig): detection tolerates this much more
        #: imbalance than the optimizer targets, so a cluster freshly
        #: balanced to threshold T doesn't re-trigger on drift noise
        self.threshold_multiplier = float(threshold_multiplier)

    def _detection_constraint(self):
        constraint = self.cc.constraint
        m = self.threshold_multiplier
        if m == 1.0:
            return constraint
        # thresholds are 1+gap ratios: the multiplier widens the gap
        return dataclasses.replace(
            constraint,
            balance_threshold={
                r: 1.0 + (v - 1.0) * m
                for r, v in constraint.balance_threshold.items()
            },
            replica_balance_threshold=(
                1.0 + (constraint.replica_balance_threshold - 1.0) * m
            ),
            leader_replica_balance_threshold=(
                1.0 + (constraint.leader_replica_balance_threshold - 1.0) * m
            ),
            topic_replica_balance_threshold=(
                1.0 + (constraint.topic_replica_balance_threshold - 1.0) * m
            ),
        )

    def detect(self, now_ms: int) -> List[Anomaly]:
        try:
            with self.cc.load_monitor.acquire_for_model_generation():
                state = self.cc.load_monitor.cluster_model()
        except NotEnoughValidWindowsError:
            return []  # not enough data yet; upstream skips the round too
        ctx = AnalyzerContext(state)
        goals = make_goals(self.goal_names, self._detection_constraint())
        violated = {
            g.name: v for g in goals if (v := g.violations(ctx)) > 0
        }
        if not violated:
            return []
        return [GoalViolations(now_ms, violated,
                               fix_goal_names=self.fix_goal_names)]


class BrokerFailureDetector:
    """Metadata-diff detection of vanished brokers with first-seen times
    persisted to a local file, so the alert→self-heal escalation survives
    restarts (upstream ``BrokerFailureDetector``, §3.4 note)."""

    def __init__(self, cruise_control, persist_path: Optional[str] = None):
        self.cc = cruise_control
        self.persist_path = persist_path
        self._first_seen: Dict[int, int] = {}
        if persist_path and os.path.exists(persist_path):
            with open(persist_path) as f:
                self._first_seen = {int(k): int(v) for k, v in json.load(f).items()}

    def _persist(self) -> None:
        if self.persist_path:
            tmp = self.persist_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._first_seen, f)
            os.replace(tmp, self.persist_path)

    def detect(self, now_ms: int) -> List[Anomaly]:
        topo = self.cc.load_monitor.metadata.refresh()
        # only brokers that still HOST replicas need healing: an evacuated
        # dead broker is inert, and re-reporting it would re-trigger a full
        # self-healing rebalance every cycle
        hosting = {b for reps in topo.assignment.values() for b in reps}
        alive = topo.alive_brokers if topo.alive_brokers is not None else hosting
        failed = hosting - set(alive)
        changed = False
        for b in failed:
            if b not in self._first_seen:
                self._first_seen[b] = now_ms
                changed = True
        for b in list(self._first_seen):
            if b not in failed:  # came back
                del self._first_seen[b]
                changed = True
        if changed:
            self._persist()
        if not self._first_seen:
            return []
        return [BrokerFailures(now_ms, dict(self._first_seen))]


class DiskFailureDetector:
    """Offline log dirs on alive brokers (upstream ``DiskFailureDetector``
    via AdminClient describeLogDirs; here the backend's optional
    ``offline_log_dirs()`` capability)."""

    def __init__(self, cruise_control, backend, min_offline_dirs: int = 1):
        self.cc = cruise_control
        self.backend = backend
        #: disk.failure.min.offline.dirs: brokers below this offline-dir
        #: count are tolerated (a single flapping mount on a wide JBOD
        #: layout needn't trigger a cluster-wide evacuation)
        self.min_offline_dirs = max(1, int(min_offline_dirs))

    def detect(self, now_ms: int) -> List[Anomaly]:
        probe = getattr(self.backend, "offline_log_dirs", None)
        if probe is None:
            return []
        offline: Dict[int, List[str]] = {
            b: dirs for b, dirs in probe().items()
            if len(dirs) >= self.min_offline_dirs
        }
        if not offline:
            return []
        return [DiskFailures(now_ms, offline)]


class ForeignReassignmentDetector:
    """Persistent reassignment activity not owned by OUR executor
    (ISSUE 15): each detection cycle diffs the backend's ongoing
    reassignments against the executor's in-flight/adopted set; a
    partition that stays foreign for ``min_consecutive_cycles``
    consecutive cycles surfaces a FOREIGN_REASSIGNMENT anomaly
    (alert-only by default — see :class:`ForeignReassignments`).
    Transient foreign activity (a quick manual move that drains within a
    cycle or two) is tolerated silently, exactly like the executor's own
    mid-flight reconciliation tolerates disjoint foreign moves."""

    def __init__(self, cruise_control, backend,
                 min_consecutive_cycles: int = 3):
        self.cc = cruise_control
        self.backend = backend
        #: foreign.reassignment.detection.min.cycles: consecutive cycles a
        #: foreign reassignment must persist before it pages
        self.min_consecutive_cycles = max(1, int(min_consecutive_cycles))
        self._streak: Dict[int, int] = {}

    def _owned_partitions(self) -> set:
        ex = self.cc.executor
        owned = set(ex.adopted_at_startup)
        planner = ex.planner
        if ex.has_ongoing_execution and planner is not None:
            owned.update(t.proposal.partition for t in planner.replica_tasks)
        return owned

    def detect(self, now_ms: int) -> List[Anomaly]:
        probe = getattr(self.backend, "ongoing_reassignments", None)
        if probe is None:
            return []
        foreign = set(probe()) - self._owned_partitions()
        for p in list(self._streak):
            if p not in foreign:
                del self._streak[p]
        for p in foreign:
            self._streak[p] = self._streak.get(p, 0) + 1
        persistent = {
            p: n for p, n in self._streak.items()
            if n >= self.min_consecutive_cycles
        }
        if not persistent:
            return []
        return [ForeignReassignments(now_ms, sorted(persistent),
                                     max(persistent.values()))]


class PercentileMetricAnomalyFinder:
    """Percentile-based finder (upstream ``KafkaMetricAnomalyFinder`` SPI):
    a broker metric is anomalous when its latest value exceeds the
    ``upper_percentile`` of that broker's own history by ``margin``×."""

    def __init__(self, upper_percentile: float = 95.0, margin: float = 1.5,
                 min_windows: int = 3, lower_percentile: float = 0.0):
        self.upper_percentile = upper_percentile
        self.margin = margin
        self.min_windows = min_windows
        #: metric.anomaly.percentile.lower.threshold: when > 0, a metric
        #: COLLAPSING below this percentile of its own history (by the same
        #: margin) is anomalous too — a broker gone quiet is as suspicious
        #: as a broker gone hot (upstream finder checks both sides).  0
        #: keeps the historical upper-side-only behavior.
        self.lower_percentile = lower_percentile

    def find(self, now_ms: int, values: np.ndarray, metric_names: Sequence[str],
             ) -> List[MetricAnomaly]:
        """``values[B, W, M]`` — per-broker windowed history, newest last."""
        out: List[MetricAnomaly] = []
        B, W, M = values.shape
        if W < self.min_windows:
            return out
        history, latest = values[:, :-1, :], values[:, -1, :]
        thresh = np.percentile(history, self.upper_percentile, axis=1)  # [B, M]
        bad = latest > np.maximum(thresh * self.margin, 1e-9)
        for b, m in zip(*np.nonzero(bad)):
            out.append(MetricAnomaly(
                now_ms, int(b), metric_names[int(m)],
                float(latest[b, m]), float(thresh[b, m] * self.margin),
            ))
        if self.lower_percentile > 0:
            lo = np.percentile(history, self.lower_percentile, axis=1)
            floor = lo / self.margin
            sag = (latest < floor) & (floor > 1e-9)
            for b, m in zip(*np.nonzero(sag)):
                out.append(MetricAnomaly(
                    now_ms, int(b), metric_names[int(m)],
                    float(latest[b, m]), float(floor[b, m]),
                ))
        return out


class MetricAnomalyDetector:
    """Feeds the broker aggregator's windowed history through a finder SPI
    (upstream ``MetricAnomalyDetector``).  Also surfaces the monitor's
    quarantine-storm findings (ISSUE 13): a broker whose samples are
    *persistently* rejected by the validation stage is itself anomalous —
    the data went dark even though the broker keeps reporting — reported
    alert-only as ``sample.quarantine.ratio`` (no safe automatic fix)."""

    def __init__(self, cruise_control, finder: Optional[PercentileMetricAnomalyFinder] = None):
        self.cc = cruise_control
        self.finder = finder or PercentileMetricAnomalyFinder()

    def detect(self, now_ms: int) -> List[Anomaly]:
        out: List[Anomaly] = []
        agg = self.cc.load_monitor.broker_aggregator.aggregate()
        if agg.values.size:
            names = [
                m.name for m in
                self.cc.load_monitor.broker_aggregator
                    .metric_def.all_metrics()
            ]
            out.extend(self.finder.find(now_ms, agg.values, names))
        validator = getattr(self.cc.load_monitor, "sample_validator", None)
        if validator is not None:
            for broker, ratio, threshold in validator.storm_findings():
                out.append(MetricAnomaly(
                    now_ms, int(broker), "sample.quarantine.ratio",
                    float(ratio), float(threshold),
                ))
        return out


class TopicReplicationFactorAnomalyFinder:
    """Partitions whose live RF is below the target (upstream
    ``TopicReplicationFactorAnomalyFinder``)."""

    def __init__(self, target_rf: int, min_bad_partitions: int = 1):
        self.target_rf = target_rf
        #: topic.anomaly.min.bad.partitions: tolerance before an RF-repair
        #: fires — a single under-replicated partition mid-churn needn't
        #: trigger a cluster-wide RF pass
        self.min_bad_partitions = max(1, int(min_bad_partitions))

    def find(self, now_ms: int, topo) -> List[TopicAnomaly]:
        bad = [
            p for p, reps in topo.assignment.items()
            if len(set(reps)) < self.target_rf
        ]
        if len(bad) < self.min_bad_partitions:
            return []
        return [TopicAnomaly(now_ms, self.target_rf, sorted(bad))]


class TopicAnomalyDetector:
    def __init__(self, cruise_control, target_rf: int,
                 min_bad_partitions: int = 1):
        self.cc = cruise_control
        self.finder = TopicReplicationFactorAnomalyFinder(
            target_rf, min_bad_partitions
        )

    def detect(self, now_ms: int) -> List[Anomaly]:
        topo = self.cc.load_monitor.metadata.refresh()
        return list(self.finder.find(now_ms, topo))


class MaintenanceEventReader:
    """SPI: source of operator maintenance events (upstream reads a Kafka
    topic; the in-process default is an appendable queue)."""

    def __init__(self):
        self._queue: List[dict] = []

    def submit(self, event_type: str, brokers: Optional[Sequence[int]] = None,
               ) -> None:
        self._queue.append({"type": event_type, "brokers": list(brokers or [])})

    def read(self) -> List[dict]:
        out, self._queue = self._queue, []
        return out


class MaintenanceEventDetector:
    def __init__(self, cruise_control, reader: Optional[MaintenanceEventReader] = None):
        self.cc = cruise_control
        self.reader = reader or MaintenanceEventReader()

    def detect(self, now_ms: int) -> List[Anomaly]:
        return [
            MaintenanceEvent(now_ms, e["type"], e.get("brokers"))
            for e in self.reader.read()
        ]

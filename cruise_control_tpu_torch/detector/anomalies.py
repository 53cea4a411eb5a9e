"""Anomaly vocabulary (upstream ``detector/`` anomaly classes +
``cruise-control-core`` ``detector/Anomaly.java`` base; SURVEY.md §2.8, §5.3).

Every anomaly knows how to ``fix()`` itself by re-entering the same facade
runnables the REST layer uses (upstream call stack §3.4: anomaly →
RebalanceRunnable / RemoveBrokersRunnable / FixOfflineReplicasRunnable →
KafkaCruiseControl → GoalOptimizer → Executor).
"""

from __future__ import annotations

import enum
import itertools
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.server.progress import OperationProgress


class AnomalyType(enum.Enum):
    GOAL_VIOLATION = "GOAL_VIOLATION"
    BROKER_FAILURE = "BROKER_FAILURE"
    DISK_FAILURE = "DISK_FAILURE"
    METRIC_ANOMALY = "METRIC_ANOMALY"
    TOPIC_ANOMALY = "TOPIC_ANOMALY"
    MAINTENANCE_EVENT = "MAINTENANCE_EVENT"
    FOREIGN_REASSIGNMENT = "FOREIGN_REASSIGNMENT"


_ids = itertools.count()


class Anomaly:
    """Base anomaly: detection metadata + an optional self-healing fix."""

    anomaly_type: AnomalyType

    def __init__(self, detected_ms: int, description: str):
        self.anomaly_id = f"anomaly-{next(_ids)}"
        self.detected_ms = detected_ms
        self.description = description
        self.fix_result = None

    @property
    def fixable(self) -> bool:
        return True

    def fix(self, cruise_control, progress: Optional[OperationProgress] = None):
        """Apply the self-healing operation through the facade.  Returns the
        OptimizerResult (or None when unfixable)."""
        raise NotImplementedError

    def to_json(self) -> dict:
        return {
            "anomalyId": self.anomaly_id,
            "type": self.anomaly_type.value,
            "detectedMs": self.detected_ms,
            "description": self.description,
            "fixable": self.fixable,
        }


class GoalViolations(Anomaly):
    """One or more optimization goals are violated on the live cluster
    (upstream ``GoalViolations``)."""

    anomaly_type = AnomalyType.GOAL_VIOLATION

    def __init__(self, detected_ms: int, violated_goals: Dict[str, int],
                 fixable_goals: Optional[Sequence[str]] = None,
                 fix_goal_names: Optional[Sequence[str]] = None):
        super().__init__(
            detected_ms,
            f"goals violated: {sorted(violated_goals)}",
        )
        self.violated_goals = violated_goals
        self.fixable_goals = list(fixable_goals or violated_goals)
        #: self.healing.goals config: goal subset the fix rebalance uses
        #: (None = the instance's default stack)
        self.fix_goal_names = list(fix_goal_names) if fix_goal_names else None

    def fix(self, cruise_control, progress=None):
        self.fix_result = cruise_control.rebalance(
            goals=self.fix_goal_names, dryrun=False, progress=progress
        )
        return self.fix_result


class BrokerFailures(Anomaly):
    """Brokers that disappeared from the cluster (upstream
    ``BrokerFailures``); fixed by removing them (evacuating their replicas)."""

    anomaly_type = AnomalyType.BROKER_FAILURE

    def __init__(self, detected_ms: int, failed_brokers: Dict[int, int]):
        super().__init__(
            detected_ms,
            f"failed brokers: {sorted(failed_brokers)}",
        )
        #: broker id → first-seen failure time ms
        self.failed_brokers = dict(failed_brokers)

    def fix(self, cruise_control, progress=None):
        # upstream: BrokerFailures → RemoveBrokersRunnable
        self.fix_result = cruise_control.remove_brokers(
            sorted(self.failed_brokers), dryrun=False, progress=progress
        )
        return self.fix_result


class DiskFailures(Anomaly):
    """Offline log dirs on otherwise-alive brokers (upstream
    ``DiskFailures``); fixed by moving replicas off the dead disks."""

    anomaly_type = AnomalyType.DISK_FAILURE

    def __init__(self, detected_ms: int, failed_disks: Dict[int, List[str]]):
        super().__init__(
            detected_ms,
            f"failed disks: { {b: sorted(d) for b, d in failed_disks.items()} }",
        )
        self.failed_disks = {b: list(d) for b, d in failed_disks.items()}

    def fix(self, cruise_control, progress=None):
        self.fix_result = cruise_control.fix_offline_replicas(
            dryrun=False, progress=progress
        )
        return self.fix_result


class MetricAnomaly(Anomaly):
    """A broker metric deviating from its own history (upstream
    ``KafkaMetricAnomaly``).  Alert-only: there is no safe automatic fix."""

    anomaly_type = AnomalyType.METRIC_ANOMALY

    def __init__(self, detected_ms: int, broker_id: int, metric: str,
                 current: float, threshold: float):
        super().__init__(
            detected_ms,
            f"broker {broker_id} metric {metric}={current:.3f} "
            f"beyond {threshold:.3f}",
        )
        self.broker_id = broker_id
        self.metric = metric
        self.current = current
        self.threshold = threshold

    @property
    def fixable(self) -> bool:
        return False

    def fix(self, cruise_control, progress=None):
        return None


class ForeignReassignments(Anomaly):
    """Persistent reassignment activity that is NOT ours: another
    controller (a second cruise-control instance, a raw
    kafka-reassign-partitions run, an operator script) keeps moving
    replicas on the cluster we manage.  Alert-only: the safe reaction to
    a concurrent writer is to surface it and let the executor's fencing
    and per-task yield machinery handle the overlap — auto-"fixing" by
    cancelling someone else's moves would start a reassignment war."""

    anomaly_type = AnomalyType.FOREIGN_REASSIGNMENT

    def __init__(self, detected_ms: int, partitions: Sequence[int],
                 persisted_cycles: int):
        super().__init__(
            detected_ms,
            f"foreign reassignments on {len(list(partitions))} partition(s) "
            f"persisting {persisted_cycles} detection cycle(s): "
            f"{sorted(partitions)[:20]}",
        )
        self.partitions = sorted(partitions)
        self.persisted_cycles = persisted_cycles

    @property
    def fixable(self) -> bool:
        return False

    def fix(self, cruise_control, progress=None):
        return None


class TopicAnomaly(Anomaly):
    """Partitions whose replication factor deviates from the desired value
    (upstream ``TopicReplicationFactorAnomaly``)."""

    anomaly_type = AnomalyType.TOPIC_ANOMALY

    def __init__(self, detected_ms: int, target_rf: int,
                 bad_partitions: Sequence[int]):
        super().__init__(
            detected_ms,
            f"{len(bad_partitions)} partitions below RF {target_rf}",
        )
        self.target_rf = target_rf
        self.bad_partitions = list(bad_partitions)

    def fix(self, cruise_control, progress=None):
        self.fix_result = cruise_control.fix_topic_replication_factor(
            self.target_rf, dryrun=False, progress=progress
        )
        return self.fix_result


class MaintenanceEvent(Anomaly):
    """An operator-scheduled maintenance action consumed from the maintenance
    stream (upstream ``MaintenanceEvent`` + ``MaintenanceEventReader`` SPI)."""

    anomaly_type = AnomalyType.MAINTENANCE_EVENT

    #: event type → facade operation
    TYPES = ("REBALANCE", "ADD_BROKER", "REMOVE_BROKER", "DEMOTE_BROKER",
             "FIX_OFFLINE_REPLICAS")

    def __init__(self, detected_ms: int, event_type: str,
                 brokers: Optional[Sequence[int]] = None):
        if event_type not in self.TYPES:
            raise ValueError(f"unknown maintenance event type {event_type!r}")
        super().__init__(
            detected_ms, f"maintenance {event_type} brokers={list(brokers or [])}"
        )
        self.event_type = event_type
        self.brokers = list(brokers or [])

    def fix(self, cruise_control, progress=None):
        cc = cruise_control
        if self.event_type == "REBALANCE":
            self.fix_result = cc.rebalance(dryrun=False, progress=progress)
        elif self.event_type == "ADD_BROKER":
            self.fix_result = cc.add_brokers(
                self.brokers, dryrun=False, progress=progress)
        elif self.event_type == "REMOVE_BROKER":
            self.fix_result = cc.remove_brokers(
                self.brokers, dryrun=False, progress=progress)
        elif self.event_type == "DEMOTE_BROKER":
            self.fix_result = cc.demote_brokers(
                self.brokers, dryrun=False, progress=progress)
        elif self.event_type == "FIX_OFFLINE_REPLICAS":
            self.fix_result = cc.fix_offline_replicas(
                dryrun=False, progress=progress)
        return self.fix_result

"""Anomaly detection / self-healing (upstream ``detector/``; SURVEY.md §2.8)."""

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    MaintenanceEvent,
    MetricAnomaly,
    TopicAnomaly,
)
from cruise_control_tpu_torch.detector.detectors import (
    BrokerFailureDetector,
    DiskFailureDetector,
    GoalViolationDetector,
    MaintenanceEventDetector,
    MaintenanceEventReader,
    MetricAnomalyDetector,
    PercentileMetricAnomalyFinder,
    TopicAnomalyDetector,
    TopicReplicationFactorAnomalyFinder,
)
from cruise_control_tpu_torch.detector.manager import (
    AnomalyDetectorManager,
    make_detector_manager,
)
from cruise_control_tpu_torch.detector.notifier import (
    AnomalyNotificationResult,
    AnomalyNotifier,
    NoopNotifier,
    SelfHealingNotifier,
)

__all__ = [
    "Anomaly", "AnomalyType", "BrokerFailures", "DiskFailures",
    "GoalViolations", "MaintenanceEvent", "MetricAnomaly", "TopicAnomaly",
    "BrokerFailureDetector", "DiskFailureDetector", "GoalViolationDetector",
    "MaintenanceEventDetector", "MaintenanceEventReader",
    "MetricAnomalyDetector", "PercentileMetricAnomalyFinder",
    "TopicAnomalyDetector", "TopicReplicationFactorAnomalyFinder",
    "AnomalyDetectorManager", "make_detector_manager",
    "AnomalyNotificationResult", "AnomalyNotifier", "NoopNotifier",
    "SelfHealingNotifier",
]

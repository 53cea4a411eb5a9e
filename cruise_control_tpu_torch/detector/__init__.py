"""Anomaly detection / self-healing (upstream ``detector/``; SURVEY.md §2.8).

Only the anomaly vocabulary (:mod:`anomalies`) is ported so far — the REST
server's ``POST /admin`` names anomaly types.  The detectors, the manager
and the notifiers are not ported yet (ROADMAP.md A6)."""

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

__all__ = [
    "Anomaly", "AnomalyType", "BrokerFailures", "DiskFailures",
    "GoalViolations", "MaintenanceEvent", "MetricAnomaly", "TopicAnomaly",
]

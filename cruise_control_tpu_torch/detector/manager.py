"""AnomalyDetectorManager — schedules detectors, routes anomalies through the
notifier, executes self-healing fixes (upstream
``detector/AnomalyDetectorManager.java`` + ``AnomalyDetectorState``;
SURVEY.md §2.8, call stack §3.4).

Tick-driven: ``run_detection_cycle(now_ms)`` runs every detector whose
interval elapsed, then drains the anomaly queue.  A production deployment
drives it from a scheduler thread (``start()``/``stop()``); tests call it
directly for determinism.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType

#: Upstream anomaly priority (AnomalyType.priority): operator maintenance
#: events beat autonomous healing; failures beat balance housekeeping.
ANOMALY_PRIORITY = {
    AnomalyType.MAINTENANCE_EVENT: 0,
    AnomalyType.BROKER_FAILURE: 1,
    AnomalyType.DISK_FAILURE: 2,
    AnomalyType.METRIC_ANOMALY: 3,
    AnomalyType.GOAL_VIOLATION: 4,
    AnomalyType.TOPIC_ANOMALY: 5,
    AnomalyType.FOREIGN_REASSIGNMENT: 6,
}
from cruise_control_tpu_torch.detector.notifier import (
    AnomalyNotificationResult,
    AnomalyNotifier,
    SelfHealingNotifier,
)
from cruise_control_tpu_torch.executor.executor import OngoingExecutionError
from cruise_control_tpu_torch.server.progress import OperationProgress
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("detector")


class AnomalyDetectorManager:
    def __init__(
        self,
        cruise_control,
        detectors: Optional[Dict[AnomalyType, object]] = None,
        notifier: Optional[AnomalyNotifier] = None,
        detection_interval_ms: int = 300_000,
        fix_cooldown_ms: int = 600_000,
        history_size: int = 100,
        per_type_interval_ms: Optional[Dict[AnomalyType, int]] = None,
        flight_recorder=None,
    ):
        self.cc = cruise_control
        self.detectors = dict(detectors or {})
        self.notifier = notifier or SelfHealingNotifier()
        self.detection_interval_ms = detection_interval_ms
        #: per-detector interval overrides (upstream
        #: <type>.detection.interval.ms keys); fall back to the default
        self.per_type_interval_ms = dict(per_type_interval_ms or {})
        self.fix_cooldown_ms = fix_cooldown_ms
        #: telemetry.recorder hook: dump a flight-recorder artifact the
        #: moment a self-healing fix FAILS (bootstrap wires it)
        self.flight_recorder = flight_recorder
        self._last_run_ms: Dict[AnomalyType, int] = {}
        self._last_fix_ms: Optional[int] = None
        #: bounded event journal (upstream AnomalyDetectorState history) —
        #: the maxlen keeps a long-running server from leaking; readers go
        #: through journal() under the lock (deque iteration during a
        #: concurrent append from the scheduler thread raises)
        self._history: deque = deque(maxlen=max(1, int(history_size)))
        self._history_lock = threading.Lock()
        self._by_action: Dict[str, int] = {r.value: 0 for r in AnomalyNotificationResult}
        #: anomalies whose FIX was delayed (cooldown/ongoing execution) —
        #: retried next cycle.  Needed for maintenance events, which are
        #: consumed destructively from their stream and would otherwise be
        #: silently lost; harmless for re-detectable anomaly types.
        self._pending_fixes: deque = deque()  # cclint: disable=bounded-resource -- drained in full every detection cycle; bounded by the per-cycle anomaly count, and dropping a pending maintenance fix would silently lose an operator request
        #: set by facade.recover_execution: the next detection cycle
        #: treats the recovered execution as the last fix (cooldown),
        #: using THAT cycle's clock — recovery itself has no access to the
        #: detector's time base (virtual under the scenario simulator)
        self._recovery_pending = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        cruise_control.anomaly_detector = self

    def note_recovery(self) -> None:
        """A checkpointed execution was just resumed at startup: start
        the self-healing cooldown at the next cycle so the detector does
        not double-fire a fix on top of (or immediately after) the
        recovered execution."""
        with self._history_lock:
            self._recovery_pending = True

    # ---- detection cycle --------------------------------------------------------
    def run_detection_cycle(self, now_ms: int) -> List[Anomaly]:
        """Run due detectors, then handle retries + fresh anomalies in
        priority order.  Returns anomalies handled."""
        with self._history_lock:
            recovery_pending = self._recovery_pending
            if recovery_pending:
                self._recovery_pending = False
                self._last_fix_ms = now_ms
        if recovery_pending:
            events.emit("detector.recovery_cooldown", timeMs=now_ms,
                        cooldownMs=self.fix_cooldown_ms)
        queue: List[Anomaly]
        queue, self._pending_fixes = list(self._pending_fixes), deque()  # cclint: disable=bounded-resource -- the swap-in replacement for the per-cycle pending set; same justification as its __init__ twin
        for atype, det in self.detectors.items():
            last = self._last_run_ms.get(atype)
            interval = self.per_type_interval_ms.get(
                atype, self.detection_interval_ms
            )
            if last is not None and now_ms - last < interval:
                continue
            self._last_run_ms[atype] = now_ms
            try:
                found = det.detect(now_ms)
                if found:
                    LOG.info("%s detected %d anomaly(ies): %s", atype.value,
                             len(found), [a.description for a in found])
                queue.extend(found)
            except Exception as e:  # a broken detector must not kill the loop
                LOG.exception("%s detector failed", atype.value)
                events.emit(
                    "detector.detect_failed", severity="ERROR",
                    detector=atype.value, error=repr(e),
                )
                with self._history_lock:
                    self._history.append({
                        "detector": atype.value,
                        "action": "DETECT_FAILED",
                        "error": repr(e),
                        "timeMs": now_ms,
                    })
        queue.sort(key=lambda a: (ANOMALY_PRIORITY[a.anomaly_type],
                                  a.detected_ms))
        for anomaly in queue:
            self._handle(anomaly, now_ms)
        return queue

    def _handle(self, anomaly: Anomaly, now_ms: int) -> None:
        action = self.notifier.on_anomaly(anomaly, now_ms)
        record = {
            "anomaly": anomaly.to_json(),
            "action": action.value,
            "timeMs": now_ms,
            "fixStarted": False,
        }
        if action == AnomalyNotificationResult.FIX:
            in_cooldown = (
                self._last_fix_ms is not None
                and now_ms - self._last_fix_ms < self.fix_cooldown_ms
            )
            if in_cooldown:
                record["action"] = "FIX_DELAYED_COOLDOWN"
                self._pending_fixes.append(anomaly)
            elif self.cc.executor.has_ongoing_execution:
                record["action"] = "FIX_DELAYED_ONGOING_EXECUTION"
                self._pending_fixes.append(anomaly)
            else:
                progress = OperationProgress(
                    f"SELF_HEAL_{anomaly.anomaly_type.value}"
                )
                try:
                    LOG.info("self-healing fix starting: %s",
                             anomaly.description)
                    anomaly.fix(self.cc, progress)
                    record["fixStarted"] = True
                    # _last_fix_ms is read by state_summary() on HTTP
                    # worker threads — same lock as the journal
                    with self._history_lock:
                        self._last_fix_ms = now_ms
                    LOG.info("self-healing fix finished: %s",
                             anomaly.anomaly_type.value)
                except OngoingExecutionError:
                    record["action"] = "FIX_DELAYED_ONGOING_EXECUTION"
                    self._pending_fixes.append(anomaly)
                except Exception as e:  # fix failures must not kill the loop
                    LOG.exception("self-healing fix failed: %s",
                                  anomaly.description)
                    record["action"] = "FIX_FAILED"
                    record["error"] = repr(e)
        final = record["action"]
        # anomaly → decision → fix outcome, one journal record per anomaly
        events.emit(
            "detector.anomaly",
            severity="ERROR" if final == "FIX_FAILED" else "INFO",
            anomalyType=anomaly.anomaly_type.value,
            description=anomaly.description,
            action=final,
            fixStarted=record["fixStarted"],
            # the cycle's clock (virtual under the scenario simulator) —
            # detection-latency assertions read the journal alone
            timeMs=now_ms,
            error=record.get("error"),
        )
        with self._history_lock:
            self._by_action[final] = self._by_action.get(final, 0) + 1
            self._history.append(record)
        # proposal-cache invalidation (ISSUE 8): an anomaly means the model
        # the warm precomputed plan was computed against no longer
        # describes the cluster — the plan is marked stale (kept as the
        # degraded-serving fallback, never served as fresh again)
        notify = getattr(self.cc, "note_anomaly", None)
        if notify is not None:
            notify(anomaly)
        if final == "FIX_FAILED" and self.flight_recorder is not None:
            # the crash-readable artifact, written at the exact moment an
            # operator will want it; must never add a second failure
            try:
                self.flight_recorder.dump(
                    f"FIX_FAILED:{anomaly.anomaly_type.value}"
                )
            except Exception:  # pragma: no cover - defensive
                LOG.exception("flight-recorder dump on FIX_FAILED failed")

    # ---- background scheduling --------------------------------------------------
    def start(self, tick_s: float = 1.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(tick_s):
                self.run_detection_cycle(int(time.time() * 1000))

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="anomaly-detector")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None

    # ---- observability (upstream AnomalyDetectorState) --------------------------
    def journal(self) -> List[dict]:
        """The full bounded event journal, oldest first (the flight
        recorder merges this into its timeline; /state shows the tail)."""
        with self._history_lock:
            return list(self._history)

    def action_counts(self) -> Dict[str, int]:
        """Cumulative per-action outcome counters
        (``cc_anomaly_actions_total{action=...}`` on GET /metrics)."""
        with self._history_lock:
            return dict(self._by_action)

    def state_summary(self) -> dict:
        with self._history_lock:
            last_fix_ms = self._last_fix_ms
        return {
            "selfHealingEnabled": {
                t.value: on
                for t, on in self.notifier.self_healing_enabled().items()
            },
            "recentAnomalies": self.journal()[-10:],
            "metrics": self.action_counts(),
            "lastFixMs": last_fix_ms,
            "detectors": [t.value for t in self.detectors],
        }


def make_detector_manager(
    cruise_control,
    backend=None,
    target_rf: Optional[int] = None,
    maintenance_reader=None,
    broker_failure_persist_path: Optional[str] = None,
    notifier: Optional[AnomalyNotifier] = None,
    detection_goal_names=None,
    self_healing_goal_names=None,
    metric_finder=None,
    goal_violation_threshold_multiplier: float = 1.0,
    topic_anomaly_min_bad_partitions: int = 1,
    disk_failure_min_offline_dirs: int = 1,
    foreign_reassignment_min_cycles: int = 3,
    **kwargs,
) -> AnomalyDetectorManager:
    """Assemble the full upstream detector set for a facade instance."""
    from cruise_control_tpu_torch.detector.detectors import (
        BrokerFailureDetector,
        DiskFailureDetector,
        ForeignReassignmentDetector,
        GoalViolationDetector,
        MaintenanceEventDetector,
        MetricAnomalyDetector,
        TopicAnomalyDetector,
    )

    detectors: Dict[AnomalyType, object] = {
        AnomalyType.GOAL_VIOLATION: GoalViolationDetector(
            cruise_control, goal_names=detection_goal_names,
            fix_goal_names=self_healing_goal_names,
            threshold_multiplier=goal_violation_threshold_multiplier,
        ),
        AnomalyType.BROKER_FAILURE: BrokerFailureDetector(
            cruise_control, broker_failure_persist_path
        ),
        AnomalyType.METRIC_ANOMALY: MetricAnomalyDetector(
            cruise_control, finder=metric_finder
        ),
        AnomalyType.MAINTENANCE_EVENT: MaintenanceEventDetector(
            cruise_control, maintenance_reader
        ),
    }
    if backend is not None:
        detectors[AnomalyType.DISK_FAILURE] = DiskFailureDetector(
            cruise_control, backend,
            min_offline_dirs=disk_failure_min_offline_dirs,
        )
        detectors[AnomalyType.FOREIGN_REASSIGNMENT] = (
            ForeignReassignmentDetector(
                cruise_control, backend,
                min_consecutive_cycles=foreign_reassignment_min_cycles,
            )
        )
    if target_rf is not None:
        detectors[AnomalyType.TOPIC_ANOMALY] = TopicAnomalyDetector(
            cruise_control, target_rf,
            min_bad_partitions=topic_anomaly_min_bad_partitions,
        )
    return AnomalyDetectorManager(
        cruise_control, detectors, notifier=notifier, **kwargs
    )

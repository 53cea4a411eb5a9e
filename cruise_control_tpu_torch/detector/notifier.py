"""AnomalyNotifier SPI + SelfHealingNotifier (upstream
``detector/notifier/AnomalyNotifier.java`` / ``SelfHealingNotifier.java``;
SURVEY.md §2.8, §5.3).

The notifier decides what happens to each detected anomaly: IGNORE (log
only), CHECK (re-evaluate later — the broker-failure alert→fix escalation
window), or FIX (self-heal through the anomaly's facade runnable).
"""

from __future__ import annotations

import enum
from collections import deque
from typing import Callable, Dict, Optional

from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType, BrokerFailures


class AnomalyNotificationResult(enum.Enum):
    IGNORE = "IGNORE"
    CHECK = "CHECK"
    FIX = "FIX"


class AnomalyNotifier:
    """SPI: map an anomaly to an action.  ``alert()`` is the operator hook."""

    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> AnomalyNotificationResult:
        raise NotImplementedError

    def alert(self, anomaly: Anomaly, auto_fix_triggered: bool, now_ms: int) -> None:
        pass

    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return {t: False for t in AnomalyType}


class NoopNotifier(AnomalyNotifier):
    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> AnomalyNotificationResult:
        return AnomalyNotificationResult.IGNORE


class SelfHealingNotifier(AnomalyNotifier):
    """Upstream defaults: broker failures escalate alert→self-heal on time
    thresholds measured from the broker's *first-seen* failure time (which the
    detector persists across restarts); every other anomaly type fixes
    immediately when its self-healing switch is on."""

    def __init__(
        self,
        enabled: Optional[Dict[AnomalyType, bool]] = None,
        broker_failure_alert_threshold_ms: int = 900_000,        # 15 min
        broker_failure_self_healing_threshold_ms: int = 1_800_000,  # 30 min
        alert_handler: Optional[Callable[[Anomaly, bool], None]] = None,
    ):
        self._enabled = {t: False for t in AnomalyType}
        self._enabled.update(enabled or {})
        self.alert_threshold_ms = broker_failure_alert_threshold_ms
        self.self_healing_threshold_ms = broker_failure_self_healing_threshold_ms
        self.alert_handler = alert_handler
        self.alerts: deque = deque(maxlen=1000)
        #: (type, description, autoFix) of the last alert — a persistent
        #: anomaly re-detected every cycle pages the operator once, not every
        #: 5 minutes, until its shape changes or it escalates
        self._last_alert_key = None

    def set_self_healing(self, anomaly_type: AnomalyType, on: bool) -> None:
        self._enabled[anomaly_type] = on

    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return dict(self._enabled)

    def alert(self, anomaly: Anomaly, auto_fix_triggered: bool, now_ms: int) -> None:
        key = (anomaly.anomaly_type, anomaly.description, auto_fix_triggered)
        if key == self._last_alert_key:
            return
        self._last_alert_key = key
        from cruise_control_tpu_torch.utils.logging import get_logger

        get_logger("detector").warning(
            "ALERT %s: %s (auto-fix %s)", anomaly.anomaly_type.value,
            anomaly.description,
            "triggered" if auto_fix_triggered else "not triggered",
        )
        self.alerts.append({
            "anomalyId": anomaly.anomaly_id,
            "type": anomaly.anomaly_type.value,
            "autoFixTriggered": auto_fix_triggered,
            "timeMs": now_ms,
            "description": anomaly.description,
        })
        if self.alert_handler is not None:
            self.alert_handler(anomaly, auto_fix_triggered)

    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> AnomalyNotificationResult:
        t = anomaly.anomaly_type
        healing = self._enabled.get(t, False)
        if isinstance(anomaly, BrokerFailures):
            earliest = min(anomaly.failed_brokers.values())
            if now_ms < earliest + self.alert_threshold_ms:
                return AnomalyNotificationResult.CHECK  # not even alert-worthy yet
            if not healing or now_ms < earliest + self.self_healing_threshold_ms:
                self.alert(anomaly, False, now_ms)
                return (
                    AnomalyNotificationResult.CHECK
                    if healing
                    else AnomalyNotificationResult.IGNORE
                )
            self.alert(anomaly, True, now_ms)
            return AnomalyNotificationResult.FIX
        if not anomaly.fixable or not healing:
            self.alert(anomaly, False, now_ms)
            return AnomalyNotificationResult.IGNORE
        self.alert(anomaly, True, now_ms)
        return AnomalyNotificationResult.FIX

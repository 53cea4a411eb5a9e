"""The port's detectors and notifier, one at a time, against the
reference's (``tests/test_detector.py``: the goal-violation and
broker-failure detectors, the self-healing notifier's escalation, the
percentile metric finder).  The port's outcomes equal the reference's."""

import numpy as np

from torch_detector_cases import MIN, anomalies, namespace, on_both

REF, PORT = namespace("cruise_control_tpu"), namespace(
    "cruise_control_tpu_torch")


def test_goal_violation_detects_violations_on_skewed_cluster(tmp_path):
    def scenario(D, stack, _):
        cc, _, _ = stack()
        found = D.GoalViolationDetector(cc).detect(now_ms=0)
        assert len(found) == 1 and found[0].violated_goals
        return anomalies(found), sorted(found[0].violated_goals)

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_goal_violation_clean_after_rebalance(tmp_path):
    def scenario(D, stack, _):
        cc, _, _ = stack()
        cc.rebalance(dryrun=False)
        found = D.GoalViolationDetector(cc).detect(now_ms=0)
        for a in found:
            for name in a.violated_goals:
                assert "Capacity" not in name and "RackAware" not in name
        return anomalies(found)

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_broker_failure_first_seen_persisted_across_restart(tmp_path):
    def scenario(D, stack, path):
        path.mkdir(parents=True)
        cc, backend, _ = stack()
        f = str(path / "failed_brokers.json")
        det = D.BrokerFailureDetector(cc, f)
        assert det.detect(now_ms=1000) == []
        backend.failed_brokers.add(2)
        (anomaly,) = det.detect(now_ms=2000)
        assert anomaly.failed_brokers == {2: 2000}
        (anomaly2,) = D.BrokerFailureDetector(cc, f).detect(now_ms=9000)
        assert anomaly2.failed_brokers == {2: 2000}
        return anomalies([anomaly, anomaly2]), open(f).read()

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_broker_failure_recovered_broker_cleared(tmp_path):
    def scenario(D, stack, path):
        path.mkdir(parents=True)
        cc, backend, _ = stack()
        det = D.BrokerFailureDetector(cc, str(path / "f.json"))
        backend.failed_brokers.add(2)
        found = det.detect(now_ms=2000)
        backend.failed_brokers.clear()
        assert det.detect(now_ms=3000) == []
        return anomalies(found)

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def notifier_outcomes(D, case):
    """A notifier ``case`` on package ``D`` → (results, alerts)."""
    R = D.AnomalyNotificationResult
    if case == "escalation":
        n = D.healing_notifier(alert_ms=10 * MIN, heal_ms=30 * MIN,
                               broker_failure=True)
        a = D.BrokerFailures(0, {1: 0})
        out = [n.on_anomaly(a, 5 * MIN)]
        assert out[-1] == R.CHECK and not n.alerts
        out.append(n.on_anomaly(a, 15 * MIN))
        assert out[-1] == R.CHECK and not n.alerts[-1]["autoFixTriggered"]
        out.append(n.on_anomaly(a, 31 * MIN))
        assert out[-1] == R.FIX and n.alerts[-1]["autoFixTriggered"]
    elif case == "disabled":
        n = D.healing_notifier(broker_failure=False)
        out = [n.on_anomaly(D.BrokerFailures(0, {1: 0}), 10 * MIN)]
        assert out == [R.IGNORE]
    else:
        n = D.healing_notifier(metric_anomaly=True)
        a = D.MetricAnomaly(0, broker_id=1, metric="CPU", current=9.0,
                            threshold=1.0)
        out = [n.on_anomaly(a, 0)]
        assert out == [R.IGNORE] and n.alerts
    return [r.value for r in out], [
        {k: v for k, v in al.items() if k != "anomalyId"}
        for al in n.alerts]


def test_notifier_broker_failure_escalation():
    assert notifier_outcomes(PORT, "escalation") == notifier_outcomes(
        REF, "escalation")


def test_notifier_healing_disabled_never_fixes():
    assert notifier_outcomes(PORT, "disabled") == notifier_outcomes(
        REF, "disabled")


def test_notifier_unfixable_anomaly_alerts_only():
    assert notifier_outcomes(PORT, "unfixable") == notifier_outcomes(
        REF, "unfixable")


def finder_outcomes(D):
    vals = np.ones((2, 6, 1))
    vals[1, -1, 0] = 10.0  # broker 1 spikes in the newest window
    out = D.PercentileMetricAnomalyFinder(
        upper_percentile=95, margin=1.5).find(0, vals, ["CPU"])
    assert [a.broker_id for a in out] == [1] and out[0].metric == "CPU"
    return anomalies(out), [(a.current, a.threshold) for a in out]


def test_percentile_finder_flags_spike_against_own_history():
    assert finder_outcomes(PORT) == finder_outcomes(REF)


def test_percentile_finder_insufficient_history_silent():
    for D in (REF, PORT):
        finder = D.PercentileMetricAnomalyFinder(min_windows=3)
        assert finder.find(0, np.ones((2, 2, 1)), ["CPU"]) == []

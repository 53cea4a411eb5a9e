"""The port's topic-anomaly fix, facade state and detector tuning knobs
against the reference's (``tests/test_detector.py``: ``TestTopicAnomaly``,
``TestStateIntegration``, ``TestDetectorTuningKnobs``).  Each scenario runs
on the reference's stack and on the port's greedy stack, and the port's
outcome equals the reference's; the knobs wired from the config registry
by each package's bootstrap land on the same detectors with the same
values."""

import numpy as np

from torch_bootstrap_cases import PKGS, booted
from torch_detector_cases import (
    ALL,
    anomalies,
    namespace,
    on_both,
    placement,
)


def test_rf_fix_raises_replication_factor(tmp_path):
    ref, port = on_both(ALL["rf_fix_raises_replication_factor"], tmp_path)
    assert port == ref


def test_rf_fix_is_rack_aware_when_possible(tmp_path):
    def scenario(D, stack, _):
        cc, backend, _ = stack(rf=1)
        result = cc.fix_topic_replication_factor(2, dryrun=False)
        assert result.execution is not None
        rack = {b: b % 2 for b in range(4)}  # the stack's broker racks
        multi_rack = sum(1 for st in backend.partitions.values()
                         if len({rack[b] for b in st.replicas}) > 1)
        assert multi_rack == len(backend.partitions)
        return placement(backend)

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_facade_state_includes_detector(tmp_path):
    def scenario(D, stack, _):
        cc, backend, _ = stack()
        D.make_detector_manager(cc, backend=backend)
        st = cc.state()["AnomalyDetectorState"]
        assert set(st["selfHealingEnabled"]) == {t.value
                                                 for t in D.AnomalyType}
        return st

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_goal_violation_threshold_multiplier_widens_tolerance(tmp_path):
    def scenario(D, stack, _):
        cc, _, _ = stack()
        (strict,) = D.GoalViolationDetector(cc).detect(now_ms=0)
        loose = D.GoalViolationDetector(
            cc, threshold_multiplier=1000.0).detect(now_ms=0)
        loose_goals = set(loose[0].violated_goals) if loose else set()
        assert set(strict.violated_goals) - loose_goals
        assert not any("Distribution" in g for g in loose_goals)
        return sorted(strict.violated_goals), sorted(loose_goals)

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_metric_finder_lower_percentile_flags_collapse():
    def outcome(D):
        vals = np.full((2, 6, 1), 10.0)
        vals[1, -1, 0] = 0.5  # broker 1 goes quiet in the newest window
        assert D.PercentileMetricAnomalyFinder().find(
            0, vals, ["NW_IN"]) == []
        (a,) = D.PercentileMetricAnomalyFinder(lower_percentile=5.0).find(
            0, vals, ["NW_IN"])
        assert a.broker_id == 1 and a.current == 0.5
        return anomalies([a]), a.threshold

    assert outcome(namespace("cruise_control_tpu_torch")) == outcome(
        namespace("cruise_control_tpu"))


def test_topic_anomaly_min_bad_partitions_tolerance(tmp_path):
    def scenario(D, stack, _):
        cc, _, _ = stack(rf=1)
        topo = cc.load_monitor.metadata.refresh()
        bad = len(topo.assignment)  # every partition below RF 2
        Finder = D.detectors.TopicReplicationFactorAnomalyFinder
        assert Finder(2, min_bad_partitions=bad + 1).find(0, topo) == []
        firing = Finder(2, min_bad_partitions=bad).find(0, topo)
        assert firing
        return anomalies(firing)

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_disk_failure_min_offline_dirs_tolerance(tmp_path):
    def scenario(D, stack, _):
        cc, backend, _ = stack()
        backend.offline_dirs = {1: ["/d1"], 2: ["/d1", "/d2"]}
        (tolerant,) = D.DiskFailureDetector(
            cc, backend, min_offline_dirs=2).detect(now_ms=0)
        assert set(tolerant.failed_disks) == {2}
        (default,) = D.DiskFailureDetector(cc, backend).detect(now_ms=0)
        assert set(default.failed_disks) == {1, 2}
        return anomalies([tolerant, default])

    ref, port = on_both(scenario, tmp_path)
    assert port == ref


def test_knobs_wired_from_config():
    def knobs(pkg):
        with booted(pkg, {
            "goal.violation.distribution.threshold.multiplier": 2.5,
            "metric.anomaly.percentile.lower.threshold": 10.0,
            "topic.anomaly.min.bad.partitions": 3,
            "disk.failure.min.offline.dirs": 2,
            "self.healing.target.topic.replication.factor": 2,
            "webserver.http.port": 0,
            "use.tpu.optimizer": False,
            "telemetry.recorder.enabled": False,
        }) as app:
            T = namespace(pkg).AnomalyType
            dets = app.detector_manager.detectors
            return (dets[T.GOAL_VIOLATION].threshold_multiplier,
                    dets[T.METRIC_ANOMALY].finder.lower_percentile,
                    dets[T.TOPIC_ANOMALY].finder.min_bad_partitions,
                    dets[T.TOPIC_ANOMALY].finder.target_rf,
                    dets[T.DISK_FAILURE].min_offline_dirs)

    ref, port = (knobs(pkg) for pkg in PKGS)
    assert port == ref == (2.5, 10.0, 3, 2, 2)

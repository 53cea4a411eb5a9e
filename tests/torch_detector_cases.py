"""Shared scenarios of the detector mirrors (``tests/test_detector.py``):
each scenario takes a package's detector namespace, a function that
builds its stack and a scratch directory, makes the reference test's
assertions, and returns what the port must reproduce — the anomalies
handled, the manager's journal and the backend's final placement.  :func:`on_both` runs one on
the reference's stack and on the port's greedy stack; :func:`on_engine` on
one package's stack and engine (the port's cuda engine on the CPU twins,
say), with every plan the facade made recorded."""

import functools
import importlib
import types

from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

MIN = 60_000
PKGS = ("cruise_control_tpu", "cruise_control_tpu_torch")


def namespace(pkg: str):
    """A package's detector names, its detectors module and a helper
    that builds its self-healing notifier."""
    det = importlib.import_module(f"{pkg}.detector")
    ns = types.SimpleNamespace(**{n: getattr(det, n) for n in det.__all__})
    ns.detectors = importlib.import_module(f"{pkg}.detector.detectors")

    def healing_notifier(alert_ms=0, heal_ms=0, **types_on):
        return det.SelfHealingNotifier(
            enabled={det.AnomalyType[k.upper()]: v
                     for k, v in types_on.items()},
            broker_failure_alert_threshold_ms=alert_ms,
            broker_failure_self_healing_threshold_ms=heal_ms,
        )

    ns.healing_notifier = healing_notifier
    return ns


def stack_of(pkg: str):
    """The function that builds the package's stack, on the greedy
    engine."""
    if pkg == PKGS[0]:
        return ref_full_stack
    return functools.partial(full_stack, engine="greedy", device="cpu")


def anomalies(found):
    """Anomalies as JSON, less their process-wide ids."""
    return [{k: v for k, v in a.to_json().items() if k != "anomalyId"}
            for a in found]


def journal(mgr):
    out = []
    for rec in mgr.journal():
        rec = dict(rec)
        if "anomaly" in rec:
            rec["anomaly"] = {k: v for k, v in rec["anomaly"].items()
                              if k != "anomalyId"}
        out.append(rec)
    return out


def placement(backend):
    return {p: (list(st.replicas), st.leader)
            for p, st in sorted(backend.partitions.items())}


def on_both(scenario, tmp_path):
    """``scenario`` on the reference and on the port's greedy stack →
    (reference's observables, port's)."""
    return tuple(scenario(namespace(pkg), stack_of(pkg), tmp_path / pkg)
                 for pkg in PKGS)


def on_engine(scenario, tmp_path, pkg=PKGS[1], engine="cuda"):
    """``scenario`` on a package's stack planning on ``engine`` (the
    port's on the CPU) → (observables, plans): each plan the facade made
    as (operation, model, goal names, options, result)."""
    plans = []
    build = ((lambda **kw: ref_full_stack(engine=engine, **kw))
             if pkg == PKGS[0] else
             functools.partial(full_stack, engine=engine, device="cpu"))

    def stack(**kw):
        cc, backend, reporter = build(**kw)
        run = cc._goal_based_operation

        def recorded(operation, state, goals, options, *a, **k):
            result = run(operation, state, goals, options, *a, **k)
            plans.append((operation, state, goals, options, result))
            return result

        cc._goal_based_operation = recorded
        return cc, backend, reporter

    return scenario(namespace(pkg), stack, tmp_path / f"{pkg}-{engine}"), plans


# ---- the manager's end-to-end scenarios -------------------------------------

def goal_violation_self_heals(D, stack, tmp_path):
    cc, backend, _ = stack()
    mgr = D.make_detector_manager(
        cc, backend=backend,
        notifier=D.healing_notifier(goal_violation=True))
    assert cc.anomaly_detector is mgr
    handled = mgr.run_detection_cycle(now_ms=0)
    assert any(a.anomaly_type == D.AnomalyType.GOAL_VIOLATION
               for a in handled)
    leaders = [st.leader for st in backend.partitions.values()]
    assert leaders.count(0) < len(leaders)
    st = mgr.state_summary()
    assert st["metrics"]["FIX"] >= 1
    assert any(r["fixStarted"] for r in st["recentAnomalies"])
    return anomalies(handled), journal(mgr), placement(backend)


def broker_failure_self_heals_after_threshold(D, stack, tmp_path):
    tmp_path.mkdir(parents=True, exist_ok=True)
    cc, backend, _ = stack(failed_brokers={2})
    mgr = D.make_detector_manager(
        cc, backend=backend,
        notifier=D.healing_notifier(alert_ms=MIN, heal_ms=3 * MIN,
                                    broker_failure=True),
        broker_failure_persist_path=str(tmp_path / "f.json"),
        detection_interval_ms=MIN,
    )
    first = mgr.run_detection_cycle(now_ms=0)  # first seen at 0; CHECK
    assert any(2 in st.replicas for st in backend.partitions.values())
    second = mgr.run_detection_cycle(now_ms=4 * MIN)  # past threshold: FIX
    assert all(2 not in st.replicas for st in backend.partitions.values())
    return (anomalies(first), anomalies(second), journal(mgr),
            placement(backend))


def fix_cooldown_blocks_second_fix(D, stack, tmp_path):
    cc, backend, _ = stack()
    mgr = D.make_detector_manager(
        cc, backend=backend,
        notifier=D.healing_notifier(goal_violation=True,
                                    maintenance_event=True),
        fix_cooldown_ms=10 * MIN, detection_interval_ms=0,
    )
    mgr.run_detection_cycle(now_ms=0)
    reader = mgr.detectors[D.AnomalyType.MAINTENANCE_EVENT].reader
    reader.submit("REBALANCE")
    mgr.run_detection_cycle(now_ms=MIN)  # within cooldown
    st = mgr.state_summary()
    assert any(r["action"] == "FIX_DELAYED_COOLDOWN"
               for r in st["recentAnomalies"])
    return journal(mgr), placement(backend)


def recovered_execution_claims_cooldown(D, stack, tmp_path):
    cc, backend, _ = stack()
    mgr = D.make_detector_manager(
        cc, backend=backend,
        notifier=D.healing_notifier(goal_violation=True),
        fix_cooldown_ms=10 * MIN, detection_interval_ms=0,
    )
    mgr.note_recovery()
    mgr.run_detection_cycle(now_ms=MIN)  # claims the cooldown at MIN
    st = mgr.state_summary()
    assert st["lastFixMs"] == MIN
    assert st["metrics"].get("FIX", 0) == 0
    assert any(r["action"] == "FIX_DELAYED_COOLDOWN"
               for r in st["recentAnomalies"])
    mgr.run_detection_cycle(now_ms=12 * MIN)
    assert mgr.state_summary()["metrics"]["FIX"] >= 1
    return journal(mgr), placement(backend)


def maintenance_event_remove_broker(D, stack, tmp_path):
    cc, backend, _ = stack()
    reader = D.MaintenanceEventReader()
    mgr = D.make_detector_manager(
        cc, backend=backend, maintenance_reader=reader,
        notifier=D.healing_notifier(maintenance_event=True))
    reader.submit("REMOVE_BROKER", brokers=[3])
    handled = mgr.run_detection_cycle(now_ms=0)
    assert all(3 not in st.replicas for st in backend.partitions.values())
    return anomalies(handled), journal(mgr), placement(backend)


def disk_failure_detector_sees_injected_offline_dirs(D, stack, tmp_path):
    cc, backend, _ = stack()
    mgr = D.make_detector_manager(cc, backend=backend)
    backend.offline_dirs = {1: ["/data/d1"]}
    handled = mgr.run_detection_cycle(now_ms=0)
    disk = [a for a in handled
            if a.anomaly_type == D.AnomalyType.DISK_FAILURE]
    assert len(disk) == 1 and disk[0].failed_disks == {1: ["/data/d1"]}
    return anomalies(handled), journal(mgr)


def disk_failure_self_heal_evacuates_broker_replicas(D, stack, tmp_path):
    cc, backend, _ = stack()
    mgr = D.make_detector_manager(
        cc, backend=backend, notifier=D.healing_notifier(disk_failure=True))
    backend.offline_dirs = {1: ["/data/d1"]}
    assert any(1 in st.replicas for st in backend.partitions.values())
    handled = mgr.run_detection_cycle(now_ms=0)
    assert all(1 not in st.replicas for st in backend.partitions.values())
    return anomalies(handled), journal(mgr), placement(backend)


def partial_disk_failure_evacuates_only_mapped_replicas(D, stack, tmp_path):
    cc, backend, _ = stack()
    on_b1 = [p for p, st in backend.partitions.items() if 1 in st.replicas]
    keep = on_b1[0]
    for p in on_b1:
        backend.replica_dir[(p, 1)] = "/d2" if p == keep else "/d1"
    backend.offline_dirs = {1: ["/d1"]}
    mgr = D.make_detector_manager(
        cc, backend=backend, notifier=D.healing_notifier(disk_failure=True))
    mgr.run_detection_cycle(now_ms=0)
    assert 1 in backend.partitions[keep].replicas
    assert backend.offline_replicas() == {}
    for (p, b), d in backend.replica_dir.items():
        if b == 1 and 1 in backend.partitions[p].replicas:
            assert d == "/d2"
    return journal(mgr), placement(backend), sorted(
        backend.replica_dir.items())


def detector_exception_does_not_kill_cycle(D, stack, tmp_path):
    cc, backend, _ = stack()
    mgr = D.make_detector_manager(
        cc, backend=backend,
        notifier=D.healing_notifier(goal_violation=True))

    class Broken:
        def detect(self, now_ms):
            raise RuntimeError("metadata unavailable")

    mgr.detectors[D.AnomalyType.TOPIC_ANOMALY] = Broken()
    handled = mgr.run_detection_cycle(now_ms=0)
    assert any(a.anomaly_type == D.AnomalyType.GOAL_VIOLATION
               for a in handled)
    assert any(r.get("action") == "DETECT_FAILED"
               for r in mgr.state_summary()["recentAnomalies"])
    return anomalies(handled), journal(mgr), placement(backend)


def delayed_maintenance_event_retried_after_cooldown(D, stack, tmp_path):
    cc, backend, _ = stack()
    reader = D.MaintenanceEventReader()
    mgr = D.make_detector_manager(
        cc, backend=backend, maintenance_reader=reader,
        notifier=D.healing_notifier(goal_violation=True,
                                    maintenance_event=True),
        fix_cooldown_ms=5 * MIN, detection_interval_ms=0,
    )
    mgr.run_detection_cycle(now_ms=0)  # goal-violation fix starts cooldown
    reader.submit("REMOVE_BROKER", brokers=[3])
    mgr.run_detection_cycle(now_ms=MIN)  # delayed by cooldown
    assert any(3 in st.replicas for st in backend.partitions.values())
    mgr.run_detection_cycle(now_ms=7 * MIN)  # retried from pending queue
    assert all(3 not in st.replicas for st in backend.partitions.values())
    return journal(mgr), placement(backend)


def detection_interval_respected(D, stack, tmp_path):
    cc, backend, _ = stack()
    mgr = D.make_detector_manager(cc, backend=backend,
                                  detection_interval_ms=5 * MIN)
    mgr.run_detection_cycle(now_ms=0)
    n1 = sum(mgr.state_summary()["metrics"].values())
    mgr.run_detection_cycle(now_ms=MIN)  # too soon; nothing runs
    assert sum(mgr.state_summary()["metrics"].values()) == n1
    return journal(mgr)


def rf_fix_raises_replication_factor(D, stack, tmp_path):
    cc, backend, _ = stack(rf=1)
    mgr = D.make_detector_manager(
        cc, backend=backend, target_rf=2,
        notifier=D.healing_notifier(topic_anomaly=True))
    handled = mgr.run_detection_cycle(now_ms=0)
    assert any(a.anomaly_type == D.AnomalyType.TOPIC_ANOMALY
               for a in handled)
    for p, st in backend.partitions.items():
        assert len(set(st.replicas)) >= 2, f"partition {p} still RF<2"
    return anomalies(handled), journal(mgr), placement(backend)


#: the manager's scenarios by the reference test's name
MANAGER = {f.__name__: f for f in (
    goal_violation_self_heals, broker_failure_self_heals_after_threshold,
    fix_cooldown_blocks_second_fix, recovered_execution_claims_cooldown,
    maintenance_event_remove_broker,
    disk_failure_detector_sees_injected_offline_dirs,
    disk_failure_self_heal_evacuates_broker_replicas,
    partial_disk_failure_evacuates_only_mapped_replicas,
    detector_exception_does_not_kill_cycle,
    delayed_maintenance_event_retried_after_cooldown,
    detection_interval_respected,
)}

#: the scenarios in which a self-healing fix plans and executes
SELF_HEAL = ("goal_violation_self_heals",
             "broker_failure_self_heals_after_threshold",
             "maintenance_event_remove_broker",
             "disk_failure_self_heal_evacuates_broker_replicas",
             "partial_disk_failure_evacuates_only_mapped_replicas",
             "delayed_maintenance_event_retried_after_cooldown",
             "rf_fix_raises_replication_factor")
ALL = dict(MANAGER, rf_fix_raises_replication_factor=(
    rf_fix_raises_replication_factor))

"""Build the served stack in-process: a simulated cluster, its metrics
pipeline, the load monitor, the executor and the facade, ready for
:class:`~cruise_control_tpu_torch.server.http_server.CruiseControlHttpServer`.

Two fixtures:

* :func:`full_stack` — the small skewed cluster (every leader on broker
  0) the facade and server tests drive, the same workload and monitor
  set-up as the reference's test harness, so the two stacks build
  identical models;
* :func:`fixture_stack` — any :class:`ClusterState` fixture (a
  ``random_cluster`` one, say) turned into ground truth: its placement,
  racks, topics and per-partition rates become a :class:`WorkloadModel`
  and a :class:`SimulatedClusterBackend`, its capacities are sized so the
  cluster is feasible by construction (bootstrap's :func:`_capacity_for`).

Both sample metric windows (three unless told otherwise) before they
return, so the monitor can build a model at once.  Both take the
incremental-replan and self-healing wiring as options, off by default:
``replan`` (a :class:`~cruise_control_tpu_torch.replan.ReplanConfig`)
attaches a :class:`~cruise_control_tpu_torch.replan.DeltaReplanner` to the
facade, ``replan_heals=True`` routes the detector's full-stack rebalance
fixes through it, and ``detector`` (the anomaly types to self-heal, ``()``
for none) attaches the anomaly detector manager (``cc.anomaly_detector``)
with a :class:`~cruise_control_tpu_torch.detector.SelfHealingNotifier`,
wired as :func:`~cruise_control_tpu_torch.bootstrap.build_app` wires them.
The facade plans on ``engine``, ``"cuda"`` unless the caller asks for
``"greedy"`` (the reference harness's default), and the cuda engine runs
on ``device``, ``"cuda"`` unless the caller asks for ``"cpu"``, where the
kernels' plain twins run.

In-process, on the card::

    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.server.http_server import (
        CruiseControlHttpServer)
    from cruise_control_tpu_torch.client.cccli import CruiseControlClient
    from cruise_control_tpu_torch.tools.served_stack import fixture_stack

    cc, backend, _, _ = fixture_stack(random_cluster(seed=42))
    srv = CruiseControlHttpServer(cc, port=0)
    srv.start()
    plan = CruiseControlClient(srv.url).post("rebalance", dryrun="true")
    srv.stop()

A replan and a self-healing cycle, in-process (``device="cpu"`` runs the
kernels' plain twins)::

    from cruise_control_tpu_torch.detector import AnomalyType
    from cruise_control_tpu_torch.replan import ReplanConfig

    cc, backend, reporter, _ = fixture_stack(
        random_cluster(seed=42), replan=ReplanConfig(), replan_heals=True,
        detector=(AnomalyType.GOAL_VIOLATION,))
    cc.get_proposals(ignore_cache=True)        # cold; the carry is kept
    ...                                        # roll metric windows
    cc.get_proposals(ignore_cache=True)        # warm, riding the carry
    cc.anomaly_detector.run_detection_cycle(now_ms=0)   # detect and heal
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.bootstrap import _capacity_for
from cruise_control_tpu_torch.common.resources import EMPTY_SLOT, Resource
from cruise_control_tpu_torch.config.cruise_control_config import (
    CruiseControlConfig,
)
from cruise_control_tpu_torch.detector.anomalies import AnomalyType
from cruise_control_tpu_torch.detector.manager import make_detector_manager
from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
from cruise_control_tpu_torch.executor.backend import SimulatedClusterBackend
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor.load_monitor import (
    BackendMetadataClient,
    LoadMonitor,
)
from cruise_control_tpu_torch.monitor.sampling import (
    MetricsReporterSampler,
    MetricsTopic,
    SimulatedMetricsReporter,
    WorkloadModel,
)
from cruise_control_tpu_torch.replan.planner import (
    DeltaReplanner,
    ReplanConfig,
)

#: metric window length (ms); the monitor keeps five
WINDOW_MS = 1000
_DEFAULTS = CruiseControlConfig()
#: the hard goals, the default of the anomaly.detection.goals config key
HARD_GOALS = tuple(_DEFAULTS.get_list("anomaly.detection.goals"))
#: bootstrap's defaults for the detector (ms), from the registry:
#: broker.failure.alert.threshold.ms, broker.failure.self.healing.
#: threshold.ms, anomaly.detection.interval.ms and self.healing.cooldown.ms
BROKER_FAILURE_ALERT_MS = _DEFAULTS.get_int(
    "broker.failure.alert.threshold.ms")
BROKER_FAILURE_SELF_HEALING_MS = _DEFAULTS.get_int(
    "broker.failure.self.healing.threshold.ms")
DETECTION_INTERVAL_MS = _DEFAULTS.get_int("anomaly.detection.interval.ms")
SELF_HEALING_COOLDOWN_MS = _DEFAULTS.get_int("self.healing.cooldown.ms")


def _attach_detector(cc: CruiseControl, backend,
                     self_healing: Sequence[AnomalyType]):
    """The detector manager over ``cc`` and ``backend``, as bootstrap
    builds it under the registry's defaults: a self-healing notifier
    on for the ``self_healing`` anomaly types, the hard goals as the goals
    whose violation is an anomaly (anomaly.detection.goals).  It attaches
    itself as ``cc.anomaly_detector``; no timer thread runs until the
    caller starts one (``manager.start()``)."""
    notifier = SelfHealingNotifier(
        enabled={t: t in self_healing for t in AnomalyType},
        broker_failure_alert_threshold_ms=BROKER_FAILURE_ALERT_MS,
        broker_failure_self_healing_threshold_ms=(
            BROKER_FAILURE_SELF_HEALING_MS),
    )
    return make_detector_manager(
        cc, backend=backend, notifier=notifier,
        detection_goal_names=list(HARD_GOALS),
        detection_interval_ms=DETECTION_INTERVAL_MS,
        fix_cooldown_ms=SELF_HEALING_COOLDOWN_MS,
    )


def skewed_workload(num_partitions=24, num_brokers=4, rf=2, seed=11,
                    extra_brokers=()):
    """All leaders piled onto broker 0 — plenty for goals to fix."""
    rng = np.random.default_rng(seed)
    assignment = {
        p: [0, 1 + p % (num_brokers - 1)][:rf] for p in range(num_partitions)
    }
    leaders = {p: assignment[p][0] for p in range(num_partitions)}
    w = WorkloadModel(
        bytes_in=rng.uniform(100, 1000, num_partitions),
        bytes_out=rng.uniform(100, 2000, num_partitions),
        size_mb=rng.uniform(10, 500, num_partitions),
        assignment=assignment,
        leaders=leaders,
    )
    brokers = set(range(num_brokers)) | set(extra_brokers)
    return w, brokers


def _backend(w: WorkloadModel, brokers, failed_brokers=None):
    return SimulatedClusterBackend(
        {p: list(r) for p, r in w.assignment.items()},
        dict(w.leaders),
        brokers=brokers,
        failed_brokers=failed_brokers,
    )


def _stack(w: WorkloadModel, backend, broker_rack: Dict[int, int], *,
           windows: int, engine: str, device, capacity_resolver=None,
           partition_topic: Optional[Dict[int, str]] = None,
           replan: Optional[ReplanConfig] = None, replan_heals: bool = False,
           detector: Optional[Sequence[AnomalyType]] = None):
    topic = MetricsTopic()
    reporter = SimulatedMetricsReporter(w, topic)
    monitor = LoadMonitor(
        BackendMetadataClient(backend, broker_rack, partition_topic),
        MetricsReporterSampler(topic),
        capacity_resolver=capacity_resolver,
        window_ms=WINDOW_MS,
        num_windows=5,
    )
    for wdx in range(windows):
        reporter.report(time_ms=wdx * WINDOW_MS + 500)
        monitor.run_sampling_iteration((wdx + 1) * WINDOW_MS)
    replanner = (None if replan is None
                 else DeltaReplanner(monitor, dataclasses.replace(replan)))
    cc = CruiseControl(monitor, Executor(backend, ExecutorConfig()),
                       engine=engine, device=device, replanner=replanner,
                       replan_heals=replan_heals)
    if detector is not None:
        _attach_detector(cc, backend, detector)
    return cc, backend, reporter


def full_stack(
    num_partitions=24,
    num_brokers=4,
    rf=2,
    windows=3,
    extra_brokers=(),
    failed_brokers=None,
    engine="cuda",
    device="cuda",
    replan: Optional[ReplanConfig] = None,
    replan_heals: bool = False,
    detector: Optional[Sequence[AnomalyType]] = None,
):
    """The whole system over a skewed simulated cluster (``replan``,
    ``replan_heals`` and ``detector`` as in the module doc).
    Returns (cruise_control, backend, reporter)."""
    w, brokers = skewed_workload(
        num_partitions, num_brokers, rf, extra_brokers=extra_brokers
    )
    return _stack(
        w, _backend(w, brokers, failed_brokers),
        {b: b % 2 for b in sorted(brokers)}, windows=windows,
        engine=engine, device=device, replan=replan,
        replan_heals=replan_heals, detector=detector,
    )


def workload_from_state(state) -> Tuple[WorkloadModel, Dict[int, int],
                                        Dict[int, str]]:
    """A fixture's placement and per-partition rates as ground truth:
    (workload, broker → rack, partition → topic name).  Each partition's
    leader is listed first among its replicas; its leader load's network
    rates and disk size become the partition's produce, consume and size
    rates."""
    a = np.asarray(state.assignment)
    ls = np.asarray(state.leader_slot)
    load = np.asarray(state.leader_load, np.float64)
    assignment, leaders = {}, {}
    for p in range(a.shape[0]):
        leader = int(a[p, ls[p]])
        assignment[p] = [leader] + [int(b) for b in a[p]
                                    if b != EMPTY_SLOT and b != leader]
        leaders[p] = leader
    w = WorkloadModel(
        bytes_in=load[:, Resource.NW_IN].copy(),
        bytes_out=load[:, Resource.NW_OUT].copy(),
        size_mb=load[:, Resource.DISK].copy(),
        assignment=assignment,
        leaders=leaders,
    )
    rack = {b: int(r) for b, r in enumerate(np.asarray(state.broker_rack))}
    topics = {p: f"topic_{int(t)}"
              for p, t in enumerate(np.asarray(state.partition_topic))}
    return w, rack, topics


def fixture_stack(state, engine="cuda", device="cuda",
                  replan: Optional[ReplanConfig] = None,
                  replan_heals: bool = False,
                  detector: Optional[Sequence[AnomalyType]] = None):
    """The served stack over ``state``'s cluster (see the module doc).

    Returns (cruise_control, backend, reporter, seconds) where
    ``seconds["sampling"]`` is the host time the metric windows took to
    report and aggregate."""
    w, rack, topics = workload_from_state(state)
    t0 = time.perf_counter()
    backend = _backend(w, set(rack))
    cc, backend, reporter = _stack(
        w, backend, rack, windows=3, engine=engine, device=device,
        capacity_resolver=_capacity_for(w, state.num_brokers),
        partition_topic=topics, replan=replan, replan_heals=replan_heals,
        detector=detector,
    )
    return cc, backend, reporter, {"sampling": time.perf_counter() - t0}

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
  cluster is feasible by construction (:func:`capacity_for`).

Both sample metric windows (three unless told otherwise) before they
return, so the monitor can build a model at once.  The facade plans on
``engine``, ``"cuda"`` unless the caller asks for ``"greedy"`` (the
reference harness's default), and the cuda engine runs on ``device``,
``"cuda"`` unless the caller asks for ``"cpu"``, where the kernels' plain
twins run.

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
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import EMPTY_SLOT, Resource
from cruise_control_tpu_torch.executor.backend import SimulatedClusterBackend
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver
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

#: metric window length (ms); the monitor keeps five
WINDOW_MS = 1000


def capacity_for(w: WorkloadModel, num_brokers: int,
                 target_mean_util: float = 0.45) -> StaticCapacityResolver:
    """Size per-broker capacities so the simulated cluster is feasible by
    construction (mean utilization ≈ target under perfect balance)."""
    rf = np.array([len(w.assignment[p]) for p in sorted(w.assignment)])
    total_cpu = (
        w.base_cpu * num_brokers
        + float(np.sum(w.bytes_in * (w.cpu_per_bytes_in
                                     + w.cpu_per_replication_in * (rf - 1))))
        + float(np.sum(w.bytes_out * w.cpu_per_bytes_out))
    )
    totals = {
        Resource.CPU: total_cpu,
        Resource.DISK: float(np.sum(w.size_mb * rf)),
        Resource.NW_IN: float(np.sum(w.bytes_in * rf)),
        Resource.NW_OUT: float(np.sum(w.bytes_out)),
    }
    per_broker = {
        r: max(t / num_brokers / target_mean_util, 1.0)
        for r, t in totals.items()
    }
    return StaticCapacityResolver(per_broker)


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
           partition_topic: Optional[Dict[int, str]] = None):
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
    cc = CruiseControl(monitor, Executor(backend, ExecutorConfig()),
                       engine=engine, device=device)
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
):
    """The whole system over a skewed simulated cluster.
    Returns (cruise_control, backend, reporter)."""
    w, brokers = skewed_workload(
        num_partitions, num_brokers, rf, extra_brokers=extra_brokers
    )
    return _stack(
        w, _backend(w, brokers, failed_brokers),
        {b: b % 2 for b in sorted(brokers)}, windows=windows,
        engine=engine, device=device,
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


def fixture_stack(state, engine="cuda", device="cuda"):
    """The served stack over ``state``'s cluster (see the module doc).

    Returns (cruise_control, backend, reporter, seconds) where
    ``seconds["sampling"]`` is the host time the metric windows took to
    report and aggregate."""
    w, rack, topics = workload_from_state(state)
    t0 = time.perf_counter()
    backend = _backend(w, set(rack))
    cc, backend, reporter = _stack(
        w, backend, rack, windows=3, engine=engine, device=device,
        capacity_resolver=capacity_for(w, state.num_brokers),
        partition_topic=topics,
    )
    return cc, backend, reporter, {"sampling": time.perf_counter() - t0}

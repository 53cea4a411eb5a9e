"""Standalone server bootstrap (upstream ``KafkaCruiseControlMain`` +
``KafkaCruiseControlApp``; SURVEY.md §3.1).

Assembles the full stack from a properties file: simulated cluster backend →
metrics reporter → sampler → LoadMonitor (+ fetcher manager) → facade (with
the chosen analyzer engine) → anomaly detector → REST server (+ proposal
precompute).  The build environment has no Kafka, so the managed cluster is
the deterministic simulation (``simulation.*`` keys); a real deployment
implements ClusterBackend over AdminClient and swaps it here.

The analyzer engine is ``"cuda"`` (``use.cuda.optimizer``, the
``cuda.search.*`` keys) on the card ``build_app`` is given; ``device="cpu"``
runs its kernels' plain twins.  The keys whose modules the port has not
ported yet are refused with :class:`ConfigException` naming their ROADMAP
item (:func:`_refuse_unported`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
from cruise_control_tpu_torch.detector.manager import make_detector_manager
from cruise_control_tpu_torch.executor.backend import SimulatedClusterBackend
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor.fetcher import MetricFetcherManager
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
from cruise_control_tpu_torch.server.http_server import CruiseControlHttpServer
from cruise_control_tpu_torch.server.user_tasks import UserTaskManager
from cruise_control_tpu_torch.utils.device import resolve_device
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("bootstrap")


def load_properties(path: str) -> Dict[str, str]:
    """Java-style ``key=value`` properties (comments with # or !)."""
    props: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in "#!":
                continue
            key, _, value = line.partition("=")
            props[key.strip()] = value.strip()
    return props


@dataclasses.dataclass
class App:
    """Everything ``main`` starts; ``shutdown`` stops it in reverse order."""

    config: CruiseControlConfig
    #: SimulatedClusterBackend or kafka.KafkaClusterBackend
    backend: object
    #: the simulated in-process reporter; None in Kafka mode (real brokers
    #: run the reporter plugin themselves)
    reporter: Optional[SimulatedMetricsReporter]
    cruise_control: CruiseControl
    fetcher_manager: MetricFetcherManager
    server: CruiseControlHttpServer
    detector_manager: object
    #: telemetry/recorder.FlightRecorder; None when disabled
    flight_recorder: object = None
    #: telemetry/slo.SloEngine; None when disabled
    slo_engine: object = None
    #: whatif/proactive.ProactiveScheduler; None when disabled
    proactive_scheduler: object = None

    def shutdown(self) -> None:
        if self.proactive_scheduler is not None:
            self.proactive_scheduler.stop()
        self.cruise_control.stop_proposal_precomputation()
        self.detector_manager.stop()
        self.fetcher_manager.stop()
        if self.slo_engine is not None:
            self.slo_engine.stop()
        if self.flight_recorder is not None:
            self.flight_recorder.stop()
        self.server.stop()


def _synthetic_workload(cfg: CruiseControlConfig) -> Tuple[WorkloadModel, set]:
    rng = np.random.default_rng(cfg.get_int("simulation.seed"))
    P = cfg.get_int("simulation.num.partitions")
    B = cfg.get_int("simulation.num.brokers")
    rf = min(cfg.get_int("simulation.replication.factor"), B)
    assignment = {
        p: [(p + i) % B for i in range(rf)] for p in range(P)
    }
    leaders = {p: assignment[p][0] for p in range(P)}
    w = WorkloadModel(
        bytes_in=rng.uniform(50, 1500, P),
        bytes_out=rng.uniform(50, 3000, P),
        size_mb=rng.uniform(100, 2000, P),
        assignment=assignment,
        leaders=leaders,
    )
    return w, set(range(B))


def _balancing_constraint(cfg: CruiseControlConfig):
    """BalancingConstraint from the analyzer key group (upstream
    AnalyzerConfig thresholds)."""
    from cruise_control_tpu_torch.analyzer.goals.base import BalancingConstraint
    from cruise_control_tpu_torch.common.resources import Resource

    return BalancingConstraint(
        capacity_threshold={
            Resource.CPU: cfg.get_double("cpu.capacity.threshold"),
            Resource.DISK: cfg.get_double("disk.capacity.threshold"),
            Resource.NW_IN: cfg.get_double(
                "network.inbound.capacity.threshold"),
            Resource.NW_OUT: cfg.get_double(
                "network.outbound.capacity.threshold"),
        },
        balance_threshold={
            Resource.CPU: cfg.get_double("cpu.balance.threshold"),
            Resource.DISK: cfg.get_double("disk.balance.threshold"),
            Resource.NW_IN: cfg.get_double(
                "network.inbound.balance.threshold"),
            Resource.NW_OUT: cfg.get_double(
                "network.outbound.balance.threshold"),
        },
        low_utilization_threshold={
            Resource.CPU: cfg.get_double("cpu.low.utilization.threshold"),
            Resource.DISK: cfg.get_double("disk.low.utilization.threshold"),
            Resource.NW_IN: cfg.get_double(
                "network.inbound.low.utilization.threshold"),
            Resource.NW_OUT: cfg.get_double(
                "network.outbound.low.utilization.threshold"),
        },
        replica_balance_threshold=cfg.get_double(
            "replica.count.balance.threshold"),
        leader_replica_balance_threshold=cfg.get_double(
            "leader.replica.count.balance.threshold"),
        topic_replica_balance_threshold=cfg.get_double(
            "topic.replica.count.balance.threshold"),
        max_replicas_per_broker=cfg.get_int("max.replicas.per.broker"),
        min_topic_leaders_per_broker=cfg.get_int(
            "min.topic.leaders.per.broker"),
        broker_sets=_load_broker_sets(cfg),
    )


def _load_broker_sets(cfg: CruiseControlConfig):
    """brokerset.config.file: JSON {topic name: [broker ids]} — resolved to
    topic-id keys lazily by the facade (names here, ids per model)."""
    path = cfg.get("brokerset.config.file")
    if not path:
        return {}
    import json

    with open(path) as f:
        raw = json.load(f)
    # the constraint's broker_sets is keyed by topic id; the facade resolves
    # names per model.  Store under a name key the facade rewrites.
    return {name: set(map(int, brokers)) for name, brokers in raw.items()}


def _cuda_search_config(cfg: CruiseControlConfig):
    """CudaSearchConfig from the cuda.engine key group."""
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaSearchConfig,
    )

    return CudaSearchConfig(
        max_rounds=cfg.get_int("cuda.search.max.rounds"),
        candidate_budget=cfg.get_int("cuda.search.candidate.budget"),
        max_source_replicas=cfg.get_int("cuda.search.max.source.replicas"),
        max_dest_brokers=cfg.get_int("cuda.search.max.dest.brokers"),
        topk_per_round=cfg.get_int("cuda.search.topk.per.round"),
        max_moves_per_round=cfg.get_int("cuda.search.max.moves.per.round"),
        improvement_tol=cfg.get_double("cuda.search.improvement.tolerance"),
        w_util_var=cfg.get_double("cuda.search.weight.util.variance"),
        w_bound=cfg.get_double("cuda.search.weight.balance.bound"),
        w_count=cfg.get_double("cuda.search.weight.replica.count"),
        w_leader_count=cfg.get_double("cuda.search.weight.leader.count"),
        w_leader_nwin=cfg.get_double("cuda.search.weight.leader.nwin"),
        w_pot_nwout=cfg.get_double("cuda.search.weight.potential.nwout"),
        w_move_size=cfg.get_double("cuda.search.weight.move.size"),
        scoring=cfg.get("cuda.search.scoring"),
        steps_per_call=cfg.get_int("cuda.search.steps.per.call"),
        repool_steps=cfg.get_int("cuda.search.repool.steps"),
        repool_incremental=cfg.get_boolean("cuda.search.repool.incremental"),
        repool_rows_budget=cfg.get_int("cuda.search.repool.rows.budget"),
        pipeline_depth=cfg.get_int("cuda.search.pipeline.depth"),
        incremental_rescore=cfg.get_boolean(
            "cuda.search.incremental.rescore"),
        rescore_rows_budget=cfg.get_int("cuda.search.rescore.rows.budget"),
        rescore_cols_budget=cfg.get_int("cuda.search.rescore.cols.budget"),
        rescore_lead_budget=cfg.get_int("cuda.search.rescore.lead.budget"),
        rescore_refresh_steps=cfg.get_int(
            "cuda.search.rescore.refresh.steps"),
        cohort_mode=cfg.get("cuda.search.cohort.mode"),
        cohort_stack_tol=cfg.get_double(
            "cuda.search.cohort.stack.tolerance"),
        device_batch_per_step=cfg.get_int(
            "cuda.search.device.batch.per.step"),
        moves_per_src=cfg.get_int("cuda.search.moves.per.src"),
        time_budget_s=cfg.get_double("cuda.search.time.budget.s"),
        profiler_trace_dir=cfg.get("cuda.search.profiler.trace.dir"),
        polish_rounds=cfg.get_int("cuda.search.polish.rounds"),
        selection_rows=cfg.get_int("cuda.search.selection.rows"),
        shard_tables=cfg.get_boolean("cuda.search.shard.tables"),
        donate_carry=cfg.get_boolean("cuda.search.shard.donate"),
    )


def _security_provider(cfg: CruiseControlConfig):
    """SecurityProvider from the webserver.security.* keys."""
    if not cfg.get_boolean("webserver.security.enable"):
        return None
    from cruise_control_tpu_torch.server import security as sec

    explicit = cfg.get("webserver.security.provider")
    if explicit:
        from cruise_control_tpu_torch.config.cruise_control_config import (
            resolve_class,
        )

        cls = resolve_class(explicit)
        if cls is sec.JwtSecurityProvider:
            secret_file = cfg.get("webserver.security.jwt.secret.file")
            if not secret_file:
                from cruise_control_tpu_torch.config.cruise_control_config import (
                    ConfigException,
                )

                raise ConfigException(
                    "webserver.security.jwt.secret.file must be set when "
                    "the JWT security provider is selected"
                )
            with open(secret_file, "rb") as f:
                secret = f.read().strip()
            return sec.JwtSecurityProvider(
                secret, audience=cfg.get("webserver.security.jwt.audience")
            )
        if cls is sec.TrustedProxySecurityProvider:
            return sec.TrustedProxySecurityProvider(
                cfg.get_list("trusted.proxy.ip.addresses"),
                user_header=cfg.get("trusted.proxy.user.header"),
            )
        if cls is sec.SpnegoSecurityProvider:
            return sec.SpnegoSecurityProvider(
                principal=cfg.get("spnego.principal"),
                keytab=cfg.get("spnego.keytab.file"),
            )
        return cls()
    creds_file = cfg.get("basic.auth.credentials.file")
    users = {}
    if creds_file:
        with open(creds_file) as f:
            for line in f:
                line = line.strip()
                if line and ":" in line:
                    u, _, p = line.partition(":")
                    users[u.strip()] = p.strip()
    return sec.BasicSecurityProvider(users)


def _per_type_detector_intervals(cfg: CruiseControlConfig):
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType

    keys = {
        AnomalyType.GOAL_VIOLATION: "goal.violation.detection.interval.ms",
        AnomalyType.BROKER_FAILURE: "broker.failure.detection.interval.ms",
        AnomalyType.METRIC_ANOMALY: "metric.anomaly.detection.interval.ms",
        AnomalyType.DISK_FAILURE: "disk.failure.detection.interval.ms",
        AnomalyType.TOPIC_ANOMALY: "topic.anomaly.detection.interval.ms",
    }
    return {
        t: int(cfg.get(k)) for t, k in keys.items() if cfg.get(k) is not None
    }


def _self_healing_enables(cfg: CruiseControlConfig):
    """Per-type enables defaulting to the master switch."""
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType

    master = cfg.get_boolean("self.healing.enabled")
    keys = {
        AnomalyType.BROKER_FAILURE: "self.healing.broker.failure.enabled",
        AnomalyType.GOAL_VIOLATION: "self.healing.goal.violation.enabled",
        AnomalyType.DISK_FAILURE: "self.healing.disk.failure.enabled",
        AnomalyType.METRIC_ANOMALY: "self.healing.metric.anomaly.enabled",
        AnomalyType.TOPIC_ANOMALY: "self.healing.topic.anomaly.enabled",
        AnomalyType.MAINTENANCE_EVENT:
            "self.healing.maintenance.event.enabled",
    }
    return {
        t: (master if cfg.get(k) is None else bool(cfg.get(k)))
        for t, k in keys.items()
    }


def _capacity_for(w: WorkloadModel, num_brokers: int,
                  target_mean_util: float = 0.45):
    """Size per-broker capacities so the simulated cluster is feasible by
    construction (mean utilization ≈ target under perfect balance)."""
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver

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


#: keys whose modules the port has not ported yet, with the ROADMAP item
#: that brings each: build_app refuses any value but the default
_UNPORTED = {
    "cuda.search.pipeline.depth": "A4",
    "cuda.search.shard.tables": "A11",
    "cuda.search.shard.donate": "A11",
}


def _refuse_unported(cfg: CruiseControlConfig) -> None:
    """Raise on a key this port cannot honour yet: drive-loop pipelining
    (A4) and a multi-card mesh (A11)."""
    from cruise_control_tpu_torch.config.cruise_control_config import (
        DEFAULT_CONFIG_DEF,
        ConfigException,
    )

    defaults = DEFAULT_CONFIG_DEF.keys()
    for key, item in _UNPORTED.items():
        value = cfg.get(key)
        if value != defaults[key].default:
            raise ConfigException(
                f"{key}={value}: not ported yet (ROADMAP {item})")
    if cfg.get_int("cuda.mesh.devices") > 1:
        raise ConfigException(
            f"cuda.mesh.devices={cfg.get_int('cuda.mesh.devices')}: a "
            "multi-card search is not ported yet (ROADMAP A11)")


def build_app(
    config: Optional[CruiseControlConfig] = None,
    port: Optional[int] = None,
    kafka_wire=None,
    device="cuda",
) -> App:
    """Assemble the server.

    ``bootstrap.servers`` set (or an explicit ``kafka_wire``) boots the
    real-Kafka stack from ``cruise_control_tpu_torch.kafka``; otherwise the
    deterministic simulated cluster (``simulation.*`` keys) is managed.
    ``kafka_wire`` injects a wire (e.g. the scripted FakeKafkaWire) in
    place of dialing ``bootstrap.servers`` — the test seam.  ``device`` is
    the card the cuda engine and the what-if engine run on; with
    ``use.cuda.optimizer`` on, a missing card raises here, before any
    thread or socket starts.
    """
    cfg = config or CruiseControlConfig()
    _refuse_unported(cfg)
    if cfg.get_boolean("use.cuda.optimizer"):
        resolve_device(device)
    from cruise_control_tpu_torch.telemetry import (
        critical_path,
        device_cost,
        device_stats,
        events,
        host_profile,
        kernel_budget,
        mesh_budget,
        tracing,
    )
    from cruise_control_tpu_torch.telemetry import trace as trace_mod
    from cruise_control_tpu_torch.utils import locks

    tracing.configure(
        enabled=cfg.get_boolean("telemetry.enabled"),
        ring_size=cfg.get_int("telemetry.span.ring.size"),
        slow_span_log_s=cfg.get_double("telemetry.slow.span.log.ms") / 1000,
    )
    device_stats.configure(
        enabled=cfg.get_boolean("telemetry.device.stats.enabled"),
        retrace_threshold=cfg.get_int(
            "telemetry.device.stats.retrace.threshold"
        ),
    )
    device_cost.configure(
        enabled=cfg.get_boolean("telemetry.device.cost.enabled"),
        hbm_gbps=cfg.get_double("telemetry.device.cost.hbm.gbps"),
    )
    kernel_budget.configure(
        enabled=cfg.get_boolean("telemetry.kernel.enabled"),
        default_scans=cfg.get_int("telemetry.kernel.capture.scans"),
        trace_dir=cfg.get("telemetry.kernel.trace.dir") or "",
    )
    mesh_budget.configure(
        enabled=cfg.get_boolean("telemetry.mesh.enabled"),
        ledger_enabled=cfg.get_boolean("telemetry.mesh.ledger.enabled"),
        audit_max_arrays=cfg.get_int("telemetry.mesh.audit.max.arrays"),
    )
    if cfg.get_boolean("telemetry.mesh.enabled"):
        # ride the kernel observatory's capture pipeline: one armed
        # capture feeds both /profile/kernels and /profile/mesh
        mesh_budget.MESH.attach(kernel_budget.CAPTURE)
    host_profile.configure(
        enabled=cfg.get_boolean("telemetry.host.enabled"),
        interval_ms=cfg.get_double("telemetry.host.sample.interval.ms"),
        default_samples=cfg.get_int("telemetry.host.capture.samples"),
    )
    locks.CONTENTION.configure(
        threshold_ms=cfg.get_double(
            "telemetry.host.contention.threshold.ms"),
        sustain_windows=cfg.get_int(
            "telemetry.host.contention.sustain.windows"),
    )
    if cfg.get_boolean("telemetry.host.lock.order.witness"):
        locks.CONTENTION.enable_order_witness()
    trace_mod.configure(
        enabled=cfg.get_boolean("telemetry.trace.enabled"),
        max_traces=cfg.get_int("telemetry.trace.max.traces"),
        spans_per_trace=cfg.get_int("telemetry.trace.spans.per.trace"),
    )
    events.configure(
        enabled=cfg.get_boolean("telemetry.events.enabled"),
        path=cfg.get("telemetry.events.path") or "",
        max_bytes=cfg.get_int("telemetry.events.max.bytes"),
        max_files=cfg.get_int("telemetry.events.max.files"),
        ring_size=cfg.get_int("telemetry.events.ring.size"),
    )
    if cfg.get_boolean("telemetry.logging.json"):
        # structured JSON log lines sharing the event-journal field names
        from cruise_control_tpu_torch.utils import logging as cc_logging

        cc_logging.configure(
            level=cfg.get("logging.level"),
            file=cfg.get("logging.file"),
            json_lines=True,
        )
    # journal the effective config at startup: a postmortem must know what
    # the server was actually running with (non-default keys only — the
    # full surface is docs/CONFIGURATION.md)
    overrides = {
        name: cfg.get(name)
        for name, key in cfg._def.keys().items()
        if cfg.get(name) != key.default
    }
    events.emit(
        "bootstrap.config",
        numKeys=len(cfg._def.keys()),
        overrides={k: overrides[k] for k in sorted(overrides)},
    )
    kafka_mode = kafka_wire is not None or bool(cfg.get("bootstrap.servers"))
    if kafka_mode:
        from cruise_control_tpu_torch.kafka import (
            KafkaMetricsReporterSampler,
            build_kafka_stack,
        )

        backend, metadata, kafka_sampler, kafka_store, kafka_wire = (
            build_kafka_stack(cfg, wire=kafka_wire)
        )
        topic = None
        reporter = None
        workload = None
    else:
        workload, brokers = _synthetic_workload(cfg)
        backend = SimulatedClusterBackend(
            workload.assignment, workload.leaders, brokers=brokers
        )
        topic = MetricsTopic(name=cfg.get("metric.reporter.topic"))
        reporter = SimulatedMetricsReporter(
            workload, topic,
            noise_std=cfg.get_double("simulation.workload.noise.std"),
            seed=cfg.get_int("simulation.seed"),
        )
        num_racks = cfg.get_int("simulation.num.racks")
        num_topics = cfg.get_int("simulation.num.topics")
        metadata = BackendMetadataClient(
            backend,
            broker_rack={b: f"rack_{b % num_racks}" for b in brokers},
            partition_topic={
                p: f"topic_{p % num_topics}" for p in workload.assignment
            },
            max_age_ms=cfg.get_int("metadata.max.age.ms"),
        )
    capacity_file = cfg.get("capacity.config.file")
    if capacity_file:
        from cruise_control_tpu_torch.monitor.capacity import (
            BrokerCapacityConfigFileResolver,
        )

        capacity_resolver = BrokerCapacityConfigFileResolver(capacity_file)
    elif kafka_mode:
        from cruise_control_tpu_torch.config.cruise_control_config import (
            ConfigException,
        )

        raise ConfigException(
            "capacity.config.file is required for a Kafka deployment "
            "(broker capacities cannot be derived from a live cluster)"
        )
    else:
        # no file configured: size capacities so the simulated cluster is
        # feasible by construction
        capacity_resolver = _capacity_for(
            workload, len(brokers),
            target_mean_util=cfg.get_double(
                "simulation.target.mean.utilization"
            ),
        )
    sample_store = None
    store_path = cfg.get("sample.store.path")
    if store_path:
        import inspect

        from cruise_control_tpu_torch.config.cruise_control_config import (
            resolve_class,
        )

        store_params = inspect.signature(
            resolve_class(cfg.get("sample.store.class")).__init__
        ).parameters
        store_kwargs = {}
        # custom stores may predate the loading_threads contract
        if "loading_threads" in store_params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in store_params.values()
        ):
            store_kwargs["loading_threads"] = cfg.get_int(
                "num.sample.loading.threads"
            )
        sample_store = cfg.get_configured_instance(
            "sample.store.class", store_path, **store_kwargs
        )
    elif kafka_mode:
        # default persistence on Kafka: the retention-bounded store topics
        sample_store = kafka_store
    window_ms = cfg.get("partition.metrics.window.ms")
    from cruise_control_tpu_torch.monitor.sampling import (
        SampleValidationConfig,
        SampleValidator,
    )

    sample_validator = SampleValidator(SampleValidationConfig(
        enabled=cfg.get_boolean("monitor.sample.validation.enabled"),
        spike_factor=cfg.get_double(
            "monitor.sample.validation.spike.factor"
        ),
        max_age_ms=cfg.get_int("monitor.sample.validation.max.age.ms"),
        storm_ratio=cfg.get_double(
            "monitor.sample.validation.storm.ratio"
        ),
        storm_min_samples=cfg.get_int(
            "monitor.sample.validation.storm.min.samples"
        ),
        storm_window_batches=cfg.get_int(
            "monitor.sample.validation.storm.window.batches"
        ),
    ))
    monitor = LoadMonitor(
        metadata,
        kafka_sampler if kafka_mode else _make_sampler(cfg, topic),
        sample_validator=sample_validator,
        capacity_resolver=capacity_resolver,
        sample_store=sample_store,
        window_ms=window_ms,
        num_windows=cfg.get_int("num.partition.metrics.windows"),
        min_samples_per_window=cfg.get_int(
            "min.samples.per.partition.metrics.window"
        ),
        max_allowed_extrapolations=cfg.get_int(
            "max.allowed.extrapolations.per.partition"
        ),
        capacity_estimation_percentile=cfg.get_double(
            "capacity.estimation.percentile"
        ),
        skip_loading_samples=cfg.get_boolean("skip.loading.samples"),
    )
    execution_journal = None
    checkpoint_path = cfg.get("execution.checkpoint.path")
    if checkpoint_path:
        from cruise_control_tpu_torch.executor.journal import ExecutionJournal

        execution_journal = ExecutionJournal(
            checkpoint_path,
            max_bytes=cfg.get_int("execution.checkpoint.max.bytes"),
        )
    executor = Executor(
        backend,
        ExecutorConfig(
            num_concurrent_partition_movements_per_broker=cfg.get_int(
                "num.concurrent.partition.movements.per.broker"
            ),
            num_concurrent_intra_broker_partition_movements=cfg.get_int(
                "num.concurrent.intra.broker.partition.movements"
            ),
            num_concurrent_leader_movements=cfg.get_int(
                "num.concurrent.leader.movements"
            ),
            task_timeout_ticks=cfg.get_int("execution.task.timeout.ticks"),
            replication_throttle=cfg.get("default.replication.throttle"),
            concurrency_adjuster_enabled=cfg.get_boolean(
                "concurrency.adjuster.enabled"
            ),
            concurrency_adjuster_min_cap=cfg.get_int(
                "concurrency.adjuster.min.partition.movements.per.broker"
            ),
            concurrency_adjuster_max_cap=(
                None
                if cfg.get(
                    "concurrency.adjuster.max.partition.movements.per.broker"
                ) is None
                else cfg.get_int(
                    "concurrency.adjuster.max.partition.movements.per.broker"
                )
            ),
            concurrency_adjuster_healthy_ticks=cfg.get_int(
                "concurrency.adjuster.healthy.ticks"
            ),
            concurrency_adjuster_urp_threshold=cfg.get_int(
                "concurrency.adjuster.urp.threshold"
            ),
            max_inter_broker_moves=cfg.get_int("max.num.cluster.movements"),
            progress_check_interval_ms=cfg.get_int(
                "execution.progress.check.interval.ms"
            ),
            history_retention=cfg.get_int("execution.history.retention"),
            task_retry_max_attempts=cfg.get_int(
                "execution.task.retry.max.attempts"
            ),
            task_retry_backoff_base_ticks=cfg.get_int(
                "execution.task.retry.backoff.base.ticks"
            ),
            task_retry_backoff_max_ticks=cfg.get_int(
                "execution.task.retry.backoff.max.ticks"
            ),
            task_retry_jitter_ticks=cfg.get_int(
                "execution.task.retry.jitter.ticks"
            ),
            dest_exclusion_threshold=cfg.get_int(
                "execution.task.retry.dest.exclusion.threshold"
            ),
            watchdog_stuck_ticks=cfg.get_int(
                "execution.watchdog.stuck.ticks"
            ),
            foreign_conflict_policy=cfg.get(
                "execution.foreign.conflict.policy"
            ),
            foreign_yield_backoff_ticks=cfg.get_int(
                "execution.foreign.yield.backoff.ticks"
            ),
            revalidate_preconditions=cfg.get_boolean(
                "execution.revalidate.preconditions"
            ),
        ),
        notifier=cfg.get_configured_instance("executor.notifier.class"),
        default_strategy=_movement_strategy(cfg),
        journal=execution_journal,
    )
    use_cuda = cfg.get_boolean("use.cuda.optimizer")
    breaker = None
    if cfg.get_int("proposals.precompute.breaker.failure.threshold") > 0:
        from cruise_control_tpu_torch.analyzer.precompute import CircuitBreaker

        breaker = CircuitBreaker(
            failure_threshold=cfg.get_int(
                "proposals.precompute.breaker.failure.threshold"
            ),
            reset_s=cfg.get("proposals.precompute.breaker.reset.ms") / 1000,
        )
    replanner = None
    if cfg.get_boolean("replan.enabled"):
        from cruise_control_tpu_torch.replan import DeltaReplanner, ReplanConfig

        replanner = DeltaReplanner(
            monitor,
            ReplanConfig(
                enabled=True,
                dirty_load_rel_threshold=cfg.get_double(
                    "replan.dirty.load.relative.threshold"
                ),
                dirty_partition_budget_ratio=cfg.get_double(
                    "replan.dirty.partition.budget.ratio"
                ),
                full_verify=cfg.get_boolean("replan.full.verify"),
                table_carry=cfg.get_boolean("replan.table.carry.enabled"),
            ),
        )
    engine_degradation = None
    if use_cuda:
        # the cuda→greedy engine ladder: a cold cuda failure degrades to
        # greedy with a breaker-style cooldown instead of failing the
        # operation — off the card only: on a card the facade lets the
        # failure surface (facade._on_card)
        from cruise_control_tpu_torch.analyzer.degradation import (
            EngineDegradation,
        )

        engine_degradation = EngineDegradation(
            cooldown_s=cfg.get("analyzer.engine.degraded.cooldown.ms")
            / 1000,
        )
    cc = CruiseControl(
        monitor,
        executor,
        constraint=_balancing_constraint(cfg),
        engine="cuda" if use_cuda else "greedy",
        proposal_ttl_s=cfg.get("proposal.expiration.ms") / 1000,
        cuda_config=_cuda_search_config(cfg) if use_cuda else None,
        device=device,
        excluded_topics_regex=cfg.get(
            "topics.excluded.from.partition.movement"
        ),
        min_leaders_topics_regex=cfg.get(
            "topics.with.min.leaders.per.broker"
        ),
        allowed_goals=cfg.get_list("goals"),
        default_goal_names=cfg.get_list("default.goals"),
        hard_goal_names=cfg.get_list("hard.goals"),
        breaker=breaker,
        replanner=replanner,
        replan_heals=cfg.get_boolean("replan.heal.enabled"),
        engine_degradation=engine_degradation,
        whatif_cache_entries=cfg.get_int("whatif.cache.max.entries"),
        whatif_precompute_futures=cfg.get_int("whatif.precompute.futures"),
        whatif_max_futures=cfg.get_int("whatif.max.futures"),
    )
    if kafka_mode and cfg.get_int("num.metric.fetchers") > 1:
        # each per-fetcher consumer reads the WHOLE reporter topic (the
        # wire seam has no partition-scoped consume), so N fetchers
        # multiply broker-side consumer load for wall-clock overlap only
        LOG.warning(
            "num.metric.fetchers=%d on the Kafka stack: each fetcher "
            "consumes the full %s topic (N× broker read load); consider 1",
            cfg.get_int("num.metric.fetchers"),
            cfg.get("metric.reporter.topic"),
        )
    fetchers = MetricFetcherManager(
        monitor,
        sampling_interval_ms=cfg.get("metric.sampling.interval.ms"),
        num_fetchers=cfg.get_int("num.metric.fetchers"),
        # each fetcher needs its own sampler (offset cursor); without a
        # factory the manager silently collapses to one fetcher.  In Kafka
        # mode the per-fetcher sampler is a reporter-topic consumer over the
        # shared wire (each with its own offset cursor), NOT _make_sampler —
        # there is no in-process MetricsTopic to read.
        sampler_factory=(
            None if cfg.get_int("num.metric.fetchers") <= 1
            else (
                (lambda: KafkaMetricsReporterSampler(
                    kafka_wire, topic=cfg.get("metric.reporter.topic"),
                    metadata=backend))
                if kafka_mode else (lambda: _make_sampler(cfg, topic))
            )
        ),
        assignor=cfg.get_configured_instance(
            "metric.sampler.partition.assignor.class"
        ),
    )
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier

    notifier = cfg.get_configured_instance("anomaly.notifier.class")
    if notifier is None:
        notifier = SelfHealingNotifier(
            enabled=_self_healing_enables(cfg),
            broker_failure_alert_threshold_ms=cfg.get(
                "broker.failure.alert.threshold.ms"
            ),
            broker_failure_self_healing_threshold_ms=cfg.get(
                "broker.failure.self.healing.threshold.ms"
            ),
        )
    cluster_configs_file = cfg.get("cluster.configs.file")
    target_rf = cfg.get("self.healing.target.topic.replication.factor")
    if target_rf is None and cluster_configs_file:
        import json

        with open(cluster_configs_file) as f:
            cluster_configs = json.load(f)
        rf = cluster_configs.get("replication.factor")
        target_rf = int(rf) if rf is not None else None
    from cruise_control_tpu_torch.detector.detectors import (
        PercentileMetricAnomalyFinder,
    )

    finder_cls = cfg.get("metric.anomaly.finder.class")
    metric_finder = None
    if finder_cls:
        from cruise_control_tpu_torch.config.cruise_control_config import (
            resolve_class,
        )

        cls = resolve_class(finder_cls)
        if cls is PercentileMetricAnomalyFinder:
            metric_finder = cls(
                upper_percentile=cfg.get_double(
                    "metric.anomaly.percentile.upper.threshold"
                ),
                margin=cfg.get_double("metric.anomaly.percentile.margin"),
                min_windows=cfg.get_int("metric.anomaly.min.windows"),
                lower_percentile=cfg.get_double(
                    "metric.anomaly.percentile.lower.threshold"
                ),
            )
        else:
            metric_finder = cls()
    healing_goals = cfg.get_list("self.healing.goals")
    detector = make_detector_manager(
        cc,
        backend=backend,
        notifier=notifier,
        target_rf=int(target_rf) if target_rf is not None else None,
        maintenance_reader=cfg.get_configured_instance(
            "maintenance.event.reader.class"
        ),
        broker_failure_persist_path=cfg.get(
            "broker.failures.persistence.path"
        ),
        detection_goal_names=cfg.get_list("anomaly.detection.goals") or None,
        self_healing_goal_names=healing_goals or None,
        metric_finder=metric_finder,
        goal_violation_threshold_multiplier=cfg.get_double(
            "goal.violation.distribution.threshold.multiplier"
        ),
        topic_anomaly_min_bad_partitions=cfg.get_int(
            "topic.anomaly.min.bad.partitions"
        ),
        disk_failure_min_offline_dirs=cfg.get_int(
            "disk.failure.min.offline.dirs"
        ),
        foreign_reassignment_min_cycles=cfg.get_int(
            "foreign.reassignment.detection.min.cycles"
        ),
        detection_interval_ms=cfg.get("anomaly.detection.interval.ms"),
        per_type_interval_ms=_per_type_detector_intervals(cfg),
        fix_cooldown_ms=cfg.get("self.healing.cooldown.ms"),
        history_size=cfg.get_int("anomaly.detector.history.size"),
    )
    # crash recovery (docs/ARCHITECTURE.md "Execution recovery"): resume or
    # cleanly settle the execution a previous instance checkpointed —
    # BEFORE adopting foreign reassignments (the checkpointed moves are
    # ours) and with the detector attached, so the self-healing cooldown
    # honors the recovered execution instead of double-firing
    if execution_journal is not None:
        cc.recover_execution()
    # upstream executor recovery: surface (and optionally stop) reassignments
    # a previous instance left in flight — anything the checkpoint recovery
    # did not already settle is foreign work
    executor.detect_ongoing_at_startup(
        stop=cfg.get_boolean("stop.ongoing.execution.at.startup")
    )
    if cfg.get_boolean("telemetry.device.stats.enabled"):
        # live-buffer gauges ride the shared registry: GET /state JSON,
        # /metrics gauge families, and the flight recorder's series
        device_stats.install_gauges(cc.registry)
    if cfg.get_boolean("telemetry.device.cost.enabled"):
        # HBM-utilization estimate + pending-capture depth as gauges
        device_cost.install_gauges(cc.registry)
    if cfg.get_boolean("telemetry.kernel.enabled"):
        # kernel-observatory capture count + pending-parse depth
        kernel_budget.install_gauges(cc.registry)
    if cfg.get_boolean("telemetry.mesh.enabled"):
        # mesh-observatory parse counters
        mesh_budget.install_gauges(cc.registry)
    if cfg.get_boolean("telemetry.host.enabled"):
        # the always-on host sampling profiler: lifetime sample count +
        # pending-build depth as gauges, sampler daemon started here
        # (server path only — sims/tests drive ingest() synthetically)
        host_profile.install_gauges(cc.registry)
        host_profile.ensure_started()
    flight_recorder = None
    if cfg.get_boolean("telemetry.recorder.enabled"):
        from cruise_control_tpu_torch.telemetry.recorder import FlightRecorder

        def _device_summary() -> dict:
            out = device_stats.MONITOR.summary()
            # cost ESTIMATES, per fn / per executable / per device —
            # beside the MEASURED kernel budget the artifact's
            # kernelBudget block carries, one diagnostics dump holds both
            out["deviceCost"] = device_cost.MONITOR.summary(detail=True)
            return out

        flight_recorder = FlightRecorder(
            cc.registry,
            interval_s=cfg.get_double("telemetry.recorder.interval.ms")
            / 1000,
            retention=cfg.get_int("telemetry.recorder.retention.samples"),
            journal_source=detector.journal,
            extra_sources=(
                [device_stats.MONITOR.totals]
                if cfg.get_boolean("telemetry.device.stats.enabled") else ()
            ),
            device_stats_source=_device_summary,
            dump_dir=cfg.get("telemetry.recorder.dump.dir"),
            # merge the decision journal into the artifact: an incident
            # dump carries the why alongside the numbers
            events_source=(
                (lambda: events.recent(limit=512))
                if cfg.get_boolean("telemetry.events.enabled") else None
            ),
            # and the retained trace index: the dump names the
            # correlation ids GET /trace?id= can still reconstruct
            traces_source=(
                trace_mod.STORE.index
                if cfg.get_boolean("telemetry.trace.enabled") else None
            ),
            # host observatory: where the host threads were (profiler
            # window + latest capture), which named locks they fought
            # over, and how recent requests' walls decompose
            host_profile_source=(
                host_profile.PROFILER.summary
                if cfg.get_boolean("telemetry.host.enabled") else None
            ),
            # the measured kernel budget (latest parsed capture) rides
            # the same dump the estimates do
            kernel_budget_source=(
                kernel_budget.CAPTURE.summary
                if cfg.get_boolean("telemetry.kernel.enabled") else None
            ),
            # the mesh decomposition + replication audit beside it
            mesh_budget_source=(
                mesh_budget.MESH.summary
                if cfg.get_boolean("telemetry.mesh.enabled") else None
            ),
            contention_source=locks.CONTENTION.snapshot,
            critical_path_source=critical_path.STORE.snapshot,
        )
        detector.flight_recorder = flight_recorder
        flight_recorder.start()
    slo_engine = None
    if cfg.get_boolean("telemetry.slo.enabled"):
        from cruise_control_tpu_torch.telemetry.slo import (
            SloEngine,
            parse_objectives,
        )

        on_breach = []
        if flight_recorder is not None:
            # reuse the FIX_FAILED dump plumbing: an SLO breach
            # self-captures its diagnostic context the moment it trips
            def _dump_on_breach(name: str, row) -> None:
                flight_recorder.dump(f"slo.breach:{name}")

            on_breach.append(_dump_on_breach)
        maintenance = []
        if cfg.get_boolean("telemetry.device.cost.enabled"):
            # per-executable cost capture — pumped here, off every
            # request thread
            maintenance.append(device_cost.MONITOR.capture_pending)
        if cfg.get_boolean("telemetry.kernel.enabled"):
            # Chrome-trace parsing is seconds of host work at north-star
            # scale — same discipline: the SLO tick pumps it
            maintenance.append(kernel_budget.CAPTURE.parse_pending)
        if cfg.get_boolean("telemetry.host.enabled"):
            # host-profile artifact builds + the sustained-contention
            # detector ride the same maintenance tick: never a request
            # thread, never the sim (journal fingerprints stay pinned)
            maintenance.append(host_profile.PROFILER.parse_pending)
            maintenance.append(locks.CONTENTION.check_pending)
        slo_engine = SloEngine(
            registry=cc.registry,
            events_reader=(
                events.recent
                if cfg.get_boolean("telemetry.events.enabled") else None
            ),
            window_ms=cfg.get_int("telemetry.slo.window.ms"),
            breach_cycles=cfg.get_int("telemetry.slo.breach.cycles"),
            recover_cycles=cfg.get_int("telemetry.slo.recover.cycles"),
            objectives=parse_objectives(cfg.get("telemetry.slo.objectives")),
            on_breach=on_breach,
            maintenance_hooks=maintenance,
        )
        slo_engine.start(
            interval_s=cfg.get_double("telemetry.slo.interval.ms") / 1000
        )
    tasks = UserTaskManager(
        max_active_tasks=cfg.get_int("max.active.user.tasks"),
        completed_task_ttl_s=(
            cfg.get("completed.user.task.retention.time.ms") / 1000
        ),
        max_workers=cfg.get_int("user.task.executor.threads"),
        max_cached_completed=cfg.get_int("max.cached.completed.user.tasks"),
    )
    server = CruiseControlHttpServer(
        cc,
        host=cfg.get("webserver.http.address"),
        port=port if port is not None else cfg.get_int("webserver.http.port"),
        security_provider=_security_provider(cfg),
        two_step_verification=cfg.get_boolean("two.step.verification.enabled"),
        user_task_manager=tasks,
        api_prefix=cfg.get("webserver.api.urlprefix"),
        cors_enabled=cfg.get_boolean("webserver.http.cors.enabled"),
        cors_origin=cfg.get("webserver.http.cors.origin"),
        access_log=cfg.get_boolean("webserver.accesslog.enabled"),
        purgatory_retention_s=(
            cfg.get("two.step.purgatory.retention.time.ms") / 1000
        ),
        ui_path=cfg.get("webserver.ui.path"),
        flight_recorder=flight_recorder,
        get_max_concurrent=cfg.get_int(
            "webserver.request.get.max.concurrent"
        ),
        compute_max_concurrent=cfg.get_int(
            "webserver.request.compute.max.concurrent"
        ),
        admission_queue_size=cfg.get_int("webserver.request.queue.size"),
        admission_queue_timeout_s=(
            cfg.get("webserver.request.queue.timeout.ms") / 1000
        ),
        default_deadline_ms=cfg.get_int(
            "webserver.request.default.deadline.ms"
        ),
        max_body_bytes=cfg.get_int("webserver.request.max.body.bytes"),
        read_timeout_s=cfg.get("webserver.request.read.timeout.ms") / 1000,
        drain_timeout_s=cfg.get("webserver.request.drain.timeout.ms") / 1000,
        max_inflight=cfg.get_int("webserver.request.max.inflight"),
        slo_engine=slo_engine,
    )
    if cfg.get_boolean("proposals.precompute.enabled"):
        # the §3.5 warm-plan daemon: GET /proposals answers from cache,
        # and each pass doubles as the breaker's half-open probe
        cc.start_proposal_precomputation(
            interval_s=cfg.get("proposal.precompute.interval.ms") / 1000,
            engine=cfg.get("proposal.precompute.engine"),
        )
    proactive = None
    if cfg.get_boolean("whatif.proactive.enabled"):
        # forecast-driven proactive control: fit the diurnal
        # curve to observed ingress, project the peak, rebalance BEFORE
        # the what-if verdict says a goal breaks
        from cruise_control_tpu_torch.whatif.proactive import ProactiveScheduler

        proactive = ProactiveScheduler(
            cc,
            period_ms=cfg.get_int("whatif.proactive.period.ms"),
            horizon_ms=cfg.get_int("whatif.proactive.horizon.ms"),
            threshold=cfg.get_double("whatif.proactive.threshold"),
            cooldown_ms=cfg.get_int("whatif.proactive.cooldown.ms"),
            sample_fn=monitor.observed_total_ingress,
        )
        proactive.start(
            interval_s=cfg.get("whatif.proactive.interval.ms") / 1000,
        )
    return App(cfg, backend, reporter, cc, fetchers, server, detector,
               flight_recorder, slo_engine, proactive)


def _movement_strategy(cfg: CruiseControlConfig):
    """default.replica.movement.strategies: a chain, earlier dominates."""
    from cruise_control_tpu_torch.executor.tasks import (
        ChainedReplicaMovementStrategy,
    )

    strategies = cfg.get_configured_instances(
        "default.replica.movement.strategies"
    )
    if not strategies:
        return None
    if len(strategies) == 1:
        return strategies[0]
    return ChainedReplicaMovementStrategy(strategies)


def _make_sampler(cfg: CruiseControlConfig, topic: MetricsTopic):
    """metric.sampler.class, constructed with whatever its kind needs."""
    from cruise_control_tpu_torch.config.cruise_control_config import resolve_class
    from cruise_control_tpu_torch.monitor.prometheus import PrometheusMetricSampler

    cls = resolve_class(cfg.get("metric.sampler.class"))
    if cls is MetricsReporterSampler:
        return MetricsReporterSampler(topic)
    if cls is PrometheusMetricSampler:
        import urllib.request

        return PrometheusMetricSampler(
            http_get=lambda url: urllib.request.urlopen(url).read().decode(),
            endpoint=cfg.get("prometheus.server.endpoint"),
        )
    return cls()

"""Typed config registry (upstream ``config/KafkaCruiseControlConfig.java`` +
``config/constants/{Monitor,Analyzer,Executor,AnomalyDetector,WebServer,
UserTaskManager}Config.java``; SURVEY.md §5.6).

Kafka-style ``AbstractConfig`` semantics: every key has a type, default,
optional validator, importance and doc string; unknown keys are rejected;
pluggable classes (samplers, goals, notifiers, strategies) are instantiated
by dotted name from config values.  Key names keep the upstream dotted
surface (``metric.sampling.interval.ms`` …) so reference configs map over.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
from typing import Any, Callable, Dict, List, Optional


class Importance(enum.Enum):
    HIGH = "HIGH"
    MEDIUM = "MEDIUM"
    LOW = "LOW"


class ConfigType(enum.Enum):
    INT = "INT"
    LONG = "LONG"
    DOUBLE = "DOUBLE"
    STRING = "STRING"
    BOOLEAN = "BOOLEAN"
    LIST = "LIST"      # comma-separated string or python list
    CLASS = "CLASS"    # dotted path, instantiated on demand


def at_least(lo: float) -> Callable[[str, Any], None]:
    def check(name: str, v: Any) -> None:
        if v < lo:
            raise ConfigException(f"{name}={v} must be >= {lo}")
    return check


def one_of(*allowed: str) -> Callable[[str, Any], None]:
    def check(name: str, v: Any) -> None:
        if v not in allowed:
            raise ConfigException(
                f"{name}={v!r} must be one of {sorted(allowed)}"
            )
    return check


def between(lo: float, hi: float) -> Callable[[str, Any], None]:
    def check(name: str, v: Any) -> None:
        if not (lo <= v <= hi):
            raise ConfigException(f"{name}={v} must be in [{lo}, {hi}]")
    return check


class ConfigException(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    name: str
    type: ConfigType
    default: Any
    importance: Importance
    doc: str
    validator: Optional[Callable[[str, Any], None]] = None
    group: str = ""


class ConfigDef:
    """Mutable registry of keys; shared singleton below."""

    def __init__(self) -> None:
        self._keys: Dict[str, ConfigKey] = {}

    def define(
        self,
        name: str,
        type: ConfigType,
        default: Any,
        importance: Importance,
        doc: str,
        validator: Optional[Callable[[str, Any], None]] = None,
        group: str = "",
    ) -> "ConfigDef":
        if name in self._keys:
            raise ConfigException(f"duplicate config key {name}")
        self._keys[name] = ConfigKey(
            name, type, default, importance, doc, validator, group
        )
        return self

    def keys(self) -> Dict[str, ConfigKey]:
        return dict(self._keys)

    def __contains__(self, name: str) -> bool:
        return name in self._keys


def _coerce(key: ConfigKey, value: Any) -> Any:
    t = key.type
    try:
        if t in (ConfigType.INT, ConfigType.LONG):
            return int(value)
        if t == ConfigType.DOUBLE:
            return float(value)
        if t == ConfigType.BOOLEAN:
            if isinstance(value, bool):
                return value
            return str(value).strip().lower() in ("true", "1", "yes")
        if t == ConfigType.LIST:
            if isinstance(value, str):
                return [v.strip() for v in value.split(",") if v.strip()]
            return list(value)
        if t == ConfigType.STRING or t == ConfigType.CLASS:
            return None if value is None else str(value)
    except (TypeError, ValueError) as e:
        raise ConfigException(f"bad value for {key.name}: {value!r}") from e
    raise ConfigException(f"unknown type {t}")


class CruiseControlConfig:
    """Validated, typed view over a raw ``{key: value}`` dict."""

    def __init__(
        self,
        props: Optional[Dict[str, Any]] = None,
        definition: Optional[ConfigDef] = None,
    ):
        self._def = definition or DEFAULT_CONFIG_DEF
        keys = self._def.keys()
        self._values: Dict[str, Any] = {}
        props = props or {}
        unknown = set(props) - set(keys)
        if unknown:
            raise ConfigException(f"unknown config keys: {sorted(unknown)}")
        for name, key in keys.items():
            raw = props.get(name, key.default)
            v = raw if raw is None else _coerce(key, raw)
            if key.validator is not None and v is not None:
                key.validator(name, v)
            self._values[name] = v

    def get(self, name: str) -> Any:
        if name not in self._values:
            raise ConfigException(f"unknown config key {name}")
        return self._values[name]

    __getitem__ = get

    def get_int(self, name: str) -> int:
        return int(self.get(name))

    def get_double(self, name: str) -> float:
        return float(self.get(name))

    def get_list(self, name: str) -> List[str]:
        return list(self.get(name))

    def get_boolean(self, name: str) -> bool:
        return bool(self.get(name))

    def get_configured_instance(self, name: str, *args, **kwargs) -> Any:
        """Instantiate the class named by a CLASS key (upstream
        ``getConfiguredInstance``); the instance may accept the config."""
        path = self.get(name)
        if path is None:
            return None
        cls = resolve_class(path)
        return cls(*args, **kwargs)

    def get_configured_instances(self, name: str, *args, **kwargs) -> List[Any]:
        return [resolve_class(p)(*args, **kwargs) for p in self.get_list(name)]

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)


#: the JAX package's module prefix: a class path under it would load that
#: package (and JAX) into this process
_REFERENCE_PREFIX = "cruise_control_tpu."


def resolve_class(path: str) -> type:
    """Dotted-path (or registered short-name) → class object.  A path into
    the JAX package (an old properties file's) is refused: name the
    class's ``cruise_control_tpu_torch.`` counterpart instead."""
    if path.startswith(_REFERENCE_PREFIX):
        raise ConfigException(
            f"class {path!r} is in the JAX package; use "
            f"{'cruise_control_tpu_torch.' + path[len(_REFERENCE_PREFIX):]!r}"
        )
    if "." not in path:
        # short names resolve against the goal registry for upstream parity
        from cruise_control_tpu_torch.analyzer.goal_optimizer import GOAL_CLASSES
        if path in GOAL_CLASSES:
            return GOAL_CLASSES[path]
        raise ConfigException(f"cannot resolve class short-name {path!r}")
    module, _, cls_name = path.rpartition(".")
    try:
        return getattr(importlib.import_module(module), cls_name)
    except (ImportError, AttributeError) as e:
        raise ConfigException(f"cannot resolve class {path!r}") from e


# ---------------------------------------------------------------------------------
# Default key surface (upstream config/constants/*Config.java, abridged to the
# keys this framework consumes; names match upstream where the concept exists)
# ---------------------------------------------------------------------------------

_DEFAULT_GOALS = (
    "RackAwareGoal,ReplicaCapacityGoal,DiskCapacityGoal,"
    "NetworkInboundCapacityGoal,NetworkOutboundCapacityGoal,CpuCapacityGoal,"
    "ReplicaDistributionGoal,PotentialNwOutGoal,DiskUsageDistributionGoal,"
    "NetworkInboundUsageDistributionGoal,NetworkOutboundUsageDistributionGoal,"
    "CpuUsageDistributionGoal,TopicReplicaDistributionGoal,"
    "LeaderReplicaDistributionGoal,LeaderBytesInDistributionGoal"
)

_HARD_GOALS = (
    "RackAwareGoal,ReplicaCapacityGoal,DiskCapacityGoal,"
    "NetworkInboundCapacityGoal,NetworkOutboundCapacityGoal,CpuCapacityGoal"
)


def default_config_def() -> ConfigDef:
    """The full key surface.

    Upstream names are kept wherever the concept exists (``config/constants/
    {Monitor,Analyzer,Executor,AnomalyDetector,WebServer,UserTaskManager}
    Config.java``); framework-specific keys (the ``cuda.*`` engine group, the
    ``simulation.*`` cluster group) are documented as such.  Every key is
    consumed by a constructor — ``bootstrap.build_app`` is the single wiring
    point, and ``tests/test_config.py`` boots the server from a properties
    file overriding one key per subsystem to prove reachability.
    """
    d = ConfigDef()
    G = "monitor"
    d.define("bootstrap.servers", ConfigType.STRING, None,
             Importance.HIGH,
             "Kafka bootstrap servers for a real-cluster deployment "
             "(consumed by the kafka adapter wiring); None runs the "
             "built-in simulated cluster (simulation.* keys).",
             None, G)
    d.define("num.metric.fetchers", ConfigType.INT, 1,
             Importance.MEDIUM, "Parallel metric fetchers; the partition "
             "universe is split across them.", at_least(1), G)
    d.define("metric.sampler.partition.assignor.class", ConfigType.CLASS,
             "cruise_control_tpu_torch.monitor.fetcher.MetricSamplerPartitionAssignor",
             Importance.LOW, "Partition-to-fetcher assignor.", None, G)
    d.define("prometheus.server.endpoint", ConfigType.STRING,
             "http://localhost:9090/metrics", Importance.LOW,
             "Prometheus endpoint for the PrometheusMetricSampler.", None, G)
    d.define("skip.loading.samples", ConfigType.BOOLEAN, False,
             Importance.LOW, "Skip sample-store replay at startup (no "
             "LOADING phase).", None, G)
    d.define("metadata.max.age.ms", ConfigType.LONG, 0,
             Importance.LOW, "Cluster-metadata cache age before a forced "
             "refresh (0 = no caching, every read hits the backend). "
             "Caching trades admin-call volume for detection latency: "
             "broker failures surface up to this many ms late.",
             at_least(0), G)
    d.define("default.api.timeout.ms", ConfigType.LONG, 30000,
             Importance.LOW, "Consolidated timeout for every Kafka RPC the "
             "production wire issues (admin futures, produce flush, "
             "consume drain); the per-RPC *.timeout.ms keys below "
             "override it per RPC class.", at_least(1), G)
    # upstream's per-RPC timeout family (CONFIG_DELTA §1): 0 = inherit
    # default.api.timeout.ms.  Key names follow upstream where upstream
    # has one; produce/consume cover this wire's two data-path RPCs.
    for _tkey, _tdoc in (
        ("describe.cluster.timeout.ms",
         "describe-cluster / broker-list RPCs"),
        ("list.partition.reassignments.timeout.ms",
         "reassignment alter/list RPCs"),
        ("logdir.response.timeout.ms", "JBOD log-dir describe RPCs"),
        ("metadata.timeout.ms", "topic-metadata RPCs"),
        ("produce.timeout.ms", "producer queue drain + delivery flush"),
        ("consume.timeout.ms",
         "per-call consumer metadata/watermark/poll"),
    ):
        d.define(_tkey, ConfigType.LONG, 0, Importance.LOW,
                 f"Timeout override for {_tdoc}; 0 inherits "
                 "default.api.timeout.ms.", at_least(0), G)
    d.define("topics.excluded.from.partition.movement", ConfigType.STRING, "",
             Importance.MEDIUM, "Regex of topic names excluded from replica "
             "movement in every optimization.", None, G)
    d.define("metric.reporter.topic", ConfigType.STRING,
             "__CruiseControlMetrics", Importance.LOW,
             "Topic the broker-side metrics reporter produces to.", None, G)
    d.define("partition.metric.sample.store.topic", ConfigType.STRING,
             "__KafkaCruiseControlPartitionMetricSamples", Importance.LOW,
             "Kafka-backed sample store topic for partition samples.",
             None, G)
    d.define("broker.metric.sample.store.topic", ConfigType.STRING,
             "__KafkaCruiseControlModelTrainingSamples", Importance.LOW,
             "Kafka-backed sample store topic for broker samples.", None, G)
    d.define("sample.store.topic.replication.factor", ConfigType.INT, 2,
             Importance.LOW, "RF for auto-created sample-store topics.",
             at_least(1), G)
    d.define("num.sample.loading.threads", ConfigType.INT, 8,
             Importance.LOW,
             "Parallelism for sample-store replay; capped by the number of "
             "independent sample streams (2: partition + broker).",
             at_least(1), G)
    d.define("metric.sampling.interval.ms", ConfigType.LONG, 120_000,
             Importance.HIGH, "Interval between metric sampling runs.",
             at_least(1), G)
    d.define("partition.metrics.window.ms", ConfigType.LONG, 3_600_000,
             Importance.HIGH, "Span of one partition-metrics window.",
             at_least(1), G)
    d.define("num.partition.metrics.windows", ConfigType.INT, 5,
             Importance.HIGH, "Completed windows retained per partition.",
             at_least(1), G)
    d.define("broker.metrics.window.ms", ConfigType.LONG, 3_600_000,
             Importance.HIGH, "Span of one broker-metrics window.",
             at_least(1), G)
    d.define("num.broker.metrics.windows", ConfigType.INT, 5,
             Importance.HIGH, "Completed windows retained per broker.",
             at_least(1), G)
    d.define("min.samples.per.partition.metrics.window", ConfigType.INT, 1,
             Importance.MEDIUM, "Samples required for a valid window.",
             at_least(1), G)
    d.define("min.samples.per.broker.metrics.window", ConfigType.INT, 1,
             Importance.MEDIUM, "Samples required for a valid window.",
             at_least(1), G)
    d.define("min.valid.partition.ratio", ConfigType.DOUBLE, 0.95,
             Importance.HIGH, "Monitored-partition ratio for a usable model.",
             between(0, 1), G)
    d.define("capacity.estimation.percentile", ConfigType.DOUBLE, 0.0,
             Importance.MEDIUM,
             "Percentile over the per-window load series used by capacity "
             "goals (0 disables: capacity checks use mean loads). When set, "
             "models carry the window series and capacity goals provision "
             "for peak while balance goals keep optimizing the mean.",
             between(0, 100), G)
    d.define("max.allowed.extrapolations.per.partition", ConfigType.INT, 5,
             Importance.LOW, "Extrapolated windows tolerated per partition.",
             at_least(0), G)
    d.define("broker.capacity.config.resolver.class", ConfigType.CLASS,
             "cruise_control_tpu_torch.monitor.capacity.BrokerCapacityConfigFileResolver",
             Importance.MEDIUM, "BrokerCapacityConfigResolver implementation.",
             None, G)
    d.define("capacity.config.file", ConfigType.STRING, None,
             Importance.MEDIUM, "Path of the broker-capacity JSON file.",
             None, G)
    d.define("stop.ongoing.execution.at.startup", ConfigType.BOOLEAN, False,
             Importance.LOW,
             "Cancel reassignments a previous instance left in flight "
             "instead of letting them drain (upstream executor recovery).",
             None, G)
    d.define("cluster.configs.file", ConfigType.STRING, None,
             Importance.LOW,
             "Path of the cluster-default-configs JSON file "
             "(upstream config/clusterConfigs.json); replication.factor "
             "seeds the topic-anomaly detector's target RF.", None, G)
    d.define("sample.store.class", ConfigType.CLASS,
             "cruise_control_tpu_torch.monitor.sample_store.FileSampleStore",
             Importance.MEDIUM, "SampleStore implementation.", None, G)
    d.define("sample.store.path", ConfigType.STRING, None,
             Importance.MEDIUM, "Directory for persisted samples.", None, G)
    d.define("metric.sampler.class", ConfigType.CLASS,
             "cruise_control_tpu_torch.monitor.sampling.MetricsReporterSampler",
             Importance.HIGH, "MetricSampler implementation.", None, G)
    # the data-integrity validation stage (ISSUE 13): upstream
    # CruiseControlMetricsProcessor sanity checks, made explicit
    d.define("monitor.sample.validation.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM,
             "Validate every ingested metric sample before aggregation: "
             "non-finite / negative values and samples for entities "
             "absent from current metadata are QUARANTINED (journaled as "
             "monitor.sample_quarantined, counted per reason) instead of "
             "silently poisoning window means and model loads.", None, G)
    d.define("monitor.sample.validation.spike.factor", ConfigType.DOUBLE,
             0.0, Importance.LOW,
             "Absurd-spike rate limit on broker samples: a metric more "
             "than this many times the broker's last accepted value is "
             "quarantined (reason 'spike').  0 disables; values <= 1 are "
             "meaningless and treated as disabled.", at_least(0), G)
    d.define("monitor.sample.validation.max.age.ms", ConfigType.LONG, 0,
             Importance.LOW,
             "Quarantine samples timestamped more than this many ms "
             "before the sampling poll (a wedged reporter replaying "
             "ancient data; reason 'stale').  0 disables.", at_least(0), G)
    d.define("monitor.sample.validation.storm.ratio", ConfigType.DOUBLE,
             0.5, Importance.LOW,
             "Quarantine-storm threshold: a broker whose rolling "
             "quarantined-sample ratio reaches this is surfaced as an "
             "alert-only metric anomaly (sample.quarantine.ratio) — "
             "persistently bad data is itself an anomaly.",
             between(0, 1), G)
    d.define("monitor.sample.validation.storm.min.samples", ConfigType.INT,
             4, Importance.LOW,
             "Broker samples the storm window must hold before a "
             "quarantine-storm finding can fire.", at_least(1), G)
    d.define("monitor.sample.validation.storm.window.batches",
             ConfigType.INT, 8, Importance.LOW,
             "Ingest batches in the rolling quarantine-storm window.",
             at_least(1), G)

    G = "analyzer"
    d.define("goals", ConfigType.LIST,
             _DEFAULT_GOALS + ",PreferredLeaderElectionGoal,"
             "RackAwareDistributionGoal,MinTopicLeadersPerBrokerGoal,"
             "BrokerSetAwareGoal,IntraBrokerDiskCapacityGoal,"
             "IntraBrokerDiskUsageDistributionGoal,"
             "KafkaAssignerDiskUsageDistributionGoal,"
             "KafkaAssignerEvenRackAwareGoal",
             Importance.HIGH, "All goals REST requests may name; requests "
             "naming others are rejected (internal operations are not "
             "restricted).", None, G)
    d.define("default.goals", ConfigType.LIST, _DEFAULT_GOALS,
             Importance.HIGH, "Goal stack in priority order.", None, G)
    d.define("hard.goals", ConfigType.LIST, _HARD_GOALS,
             Importance.HIGH, "Goals that must never be violated.", None, G)
    d.define("replica.count.balance.threshold", ConfigType.DOUBLE, 1.1,
             Importance.MEDIUM, "Max/avg replica-count ratio considered "
             "balanced.", at_least(1), G)
    d.define("leader.replica.count.balance.threshold", ConfigType.DOUBLE, 1.1,
             Importance.MEDIUM, "Max/avg leader-count ratio considered "
             "balanced.", at_least(1), G)
    d.define("topic.replica.count.balance.threshold", ConfigType.DOUBLE, 3.0,
             Importance.LOW, "Max/avg per-topic replica-count ratio "
             "considered balanced.", at_least(1), G)
    d.define("cpu.low.utilization.threshold", ConfigType.DOUBLE, 0.0,
             Importance.LOW, "Below this average CPU utilization the "
             "distribution goal stands down.", between(0, 1), G)
    d.define("disk.low.utilization.threshold", ConfigType.DOUBLE, 0.0,
             Importance.LOW, "Below this average disk utilization the "
             "distribution goal stands down.", between(0, 1), G)
    d.define("network.inbound.low.utilization.threshold", ConfigType.DOUBLE,
             0.0, Importance.LOW, "Below this average NW-in utilization the "
             "distribution goal stands down.", between(0, 1), G)
    d.define("network.outbound.low.utilization.threshold", ConfigType.DOUBLE,
             0.0, Importance.LOW, "Below this average NW-out utilization "
             "the distribution goal stands down.", between(0, 1), G)
    d.define("min.topic.leaders.per.broker", ConfigType.INT, 0,
             Importance.LOW, "MinTopicLeadersPerBrokerGoal floor (0 "
             "disables).", at_least(0), G)
    d.define("topics.with.min.leaders.per.broker", ConfigType.STRING, "",
             Importance.LOW, "Regex of topic names subject to "
             "min.topic.leaders.per.broker.", None, G)
    d.define("brokerset.config.file", ConfigType.STRING, None,
             Importance.LOW, "JSON file mapping topic name to allowed "
             "broker ids (BrokerSetAwareGoal).", None, G)
    d.define("proposal.precompute.interval.ms", ConfigType.LONG, 30_000,
             Importance.LOW, "Background proposal-precompute period.",
             at_least(1), G)
    d.define("proposal.precompute.engine", ConfigType.STRING, None,
             Importance.LOW, "Engine for precomputed proposals (cuda/greedy); "
             "None = the instance default.", None, G)
    d.define("proposals.precompute.enabled", ConfigType.BOOLEAN, False,
             Importance.MEDIUM, "Keep a warm proposal plan against the "
             "live model on a background thread (upstream §3.5): "
             "GET /proposals and POST /rebalance?allow_cached=true answer "
             "from the cache in milliseconds, and analyzer/monitor "
             "outages degrade to the last-good plan with stale=true "
             "instead of 503ing.", None, G)
    d.define("proposals.precompute.breaker.failure.threshold",
             ConfigType.INT, 3, Importance.MEDIUM,
             "Consecutive analyzer failures that trip the circuit "
             "breaker into cached/shed-only serving (0 disables the "
             "breaker).", at_least(0), G)
    d.define("proposals.precompute.breaker.reset.ms", ConfigType.LONG,
             30_000, Importance.LOW, "Open-state hold before the breaker "
             "lets one probe through (half-open); the probe's success "
             "closes it.", at_least(1), G)
    d.define("replan.enabled", ConfigType.BOOLEAN, False,
             Importance.MEDIUM, "Incremental re-optimization: proposal "
             "computations (the precompute daemon, GET /proposals misses, "
             "anomaly-invalidated refreshes) diff the new model against "
             "the previous one and WARM-START the search from the "
             "previous plan — delta model build, delta device upload, "
             "seeded search, partial re-verification — instead of cold "
             "recomputing.  Falls back to the cold path whenever the "
             "delta exceeds its budget or the model shape drifts.",
             None, G)
    d.define("replan.dirty.load.relative.threshold", ConfigType.DOUBLE,
             0.05, Importance.LOW, "Per-partition relative load drift "
             "below which the delta model keeps the previous row's bits "
             "(the replan's quality/working-set trade; 0 marks every "
             "drifted row dirty).", at_least(0), G)
    d.define("replan.dirty.partition.budget.ratio", ConfigType.DOUBLE,
             0.25, Importance.LOW, "Dirty-partition fraction of the "
             "model above which a replan cold-starts instead of "
             "warm-starting (a warm start over a mostly-changed model "
             "saves nothing).", between(0, 1), G)
    d.define("replan.full.verify", ConfigType.BOOLEAN, False,
             Importance.LOW, "Safety net: re-verify EVERY goal on warm "
             "replans even when its input signature matches the "
             "previously verified state (signature reuse is exact, so "
             "this buys audit comfort, not correctness).", None, G)
    d.define("replan.heal.enabled", ConfigType.BOOLEAN, False,
             Importance.MEDIUM, "Route full-stack self-healing rebalances "
             "(the detector's goal-violation fixes with the default goal "
             "stack and options) through the delta replanner too, so a "
             "heal plan WARM-STARTS from the previous plan and commits "
             "itself as the next diff base — the warm control loop "
             "covers the fault path, not just proposal refreshes.  "
             "Requires replan.enabled.", None, G)
    d.define("replan.table.carry.enabled", ConfigType.BOOLEAN, True,
             Importance.LOW, "Carry the TPU engine's device model and "
             "pool row tables across plans, so a warm replan re-uploads "
             "only dirty rows and the first repool refreshes rather than "
             "rebuilds (ops/pools incremental repool extended to "
             "cross-plan lifetime).", None, G)
    d.define("cpu.balance.threshold", ConfigType.DOUBLE, 1.1,
             Importance.MEDIUM, "Max/avg CPU ratio considered balanced.",
             at_least(1), G)
    d.define("disk.balance.threshold", ConfigType.DOUBLE, 1.1,
             Importance.MEDIUM, "Max/avg disk ratio considered balanced.",
             at_least(1), G)
    d.define("network.inbound.balance.threshold", ConfigType.DOUBLE, 1.1,
             Importance.MEDIUM, "Max/avg NW-in ratio considered balanced.",
             at_least(1), G)
    d.define("network.outbound.balance.threshold", ConfigType.DOUBLE, 1.1,
             Importance.MEDIUM, "Max/avg NW-out ratio considered balanced.",
             at_least(1), G)
    d.define("cpu.capacity.threshold", ConfigType.DOUBLE, 0.7,
             Importance.MEDIUM, "Usable fraction of CPU capacity.",
             between(0, 1), G)
    d.define("disk.capacity.threshold", ConfigType.DOUBLE, 0.8,
             Importance.MEDIUM, "Usable fraction of disk capacity.",
             between(0, 1), G)
    d.define("network.inbound.capacity.threshold", ConfigType.DOUBLE, 0.8,
             Importance.MEDIUM, "Usable fraction of NW-in capacity.",
             between(0, 1), G)
    d.define("network.outbound.capacity.threshold", ConfigType.DOUBLE, 0.8,
             Importance.MEDIUM, "Usable fraction of NW-out capacity.",
             between(0, 1), G)
    d.define("max.replicas.per.broker", ConfigType.LONG, 10_000,
             Importance.MEDIUM, "ReplicaCapacityGoal ceiling.", at_least(1), G)
    d.define("proposal.expiration.ms", ConfigType.LONG, 900_000,
             Importance.MEDIUM, "Cached proposal freshness bound.",
             at_least(0), G)
    d.define("use.cuda.optimizer", ConfigType.BOOLEAN, True,
             Importance.HIGH, "Route optimizations through the cuda engine "
             "(framework-specific; no upstream equivalent).", None, G)
    d.define("analyzer.engine.degraded.cooldown.ms", ConfigType.LONG,
             300_000, Importance.MEDIUM,
             "Engine degradation ladder: after a cold TPU-engine failure "
             "(XLA OOM, compile error, plan-sanity rejection) the failed "
             "operation and everything for this long afterwards serve on "
             "the greedy engine (analyzer.engine_degraded journaled); "
             "the first TPU attempt past the cooldown is the recovery "
             "probe.", at_least(1), G)
    d.define("whatif.max.futures", ConfigType.INT, 256,
             Importance.LOW, "Most hypothetical futures one POST /whatif "
             "request may carry (each adds one row to the batched device "
             "dispatch).", at_least(1), G)
    d.define("whatif.cache.max.entries", ConfigType.INT, 256,
             Importance.LOW, "Bound on cached per-future what-if verdicts "
             "(keyed model-generation × future fingerprint; FIFO "
             "eviction).", at_least(1), G)
    d.define("whatif.precompute.futures", ConfigType.INT, 0,
             Importance.MEDIUM, "Top-k likely futures (rack losses, broker "
             "losses, traffic growth) the precompute daemon keeps warm "
             "what-if verdicts for, re-evaluated alongside the warm plan "
             "on every model-generation bump (0 disables; requires "
             "proposals.precompute.enabled to refresh in background).",
             at_least(0), G)
    d.define("whatif.proactive.enabled", ConfigType.BOOLEAN, False,
             Importance.MEDIUM, "Forecast-driven proactive control: fit a "
             "diurnal model to observed load, project the next peak, ask "
             "the what-if engine whether the cluster survives it, and "
             "trigger a rebalance BEFORE the projected breach "
             "(proactive.* journal kinds).", None, G)
    d.define("whatif.proactive.period.ms", ConfigType.LONG, 86_400_000,
             Importance.LOW, "Diurnal period the proactive forecaster "
             "fits (24h for real workloads; the sim passes its own).",
             at_least(1), G)
    d.define("whatif.proactive.horizon.ms", ConfigType.LONG, 3_600_000,
             Importance.LOW, "How far ahead the proactive forecaster "
             "looks for the projected peak.", at_least(1), G)
    d.define("whatif.proactive.threshold", ConfigType.DOUBLE, 1.1,
             Importance.LOW, "Projected-peak/current load ratio below "
             "which the proactive scheduler stands down.", at_least(1), G)
    d.define("whatif.proactive.cooldown.ms", ConfigType.LONG, 1_800_000,
             Importance.LOW, "Minimum spacing between proactive "
             "rebalances.", at_least(0), G)
    d.define("whatif.proactive.interval.ms", ConfigType.LONG, 60_000,
             Importance.LOW, "Proactive scheduler tick period (sample + "
             "decide).", at_least(1), G)

    G = "executor"
    d.define("num.concurrent.partition.movements.per.broker", ConfigType.INT, 5,
             Importance.HIGH, "Per-broker in-flight replica-move cap.",
             at_least(1), G)
    d.define("num.concurrent.intra.broker.partition.movements", ConfigType.INT,
             2, Importance.MEDIUM,
             "Per-broker in-flight disk-to-disk move cap.", at_least(1), G)
    d.define("num.concurrent.leader.movements", ConfigType.INT, 1000,
             Importance.HIGH, "Leadership-election batch cap.", at_least(1), G)
    d.define("max.num.cluster.movements", ConfigType.INT, 1 << 30,
             Importance.MEDIUM, "Safety ceiling on one execution's total "
             "inter-broker moves.", at_least(1), G)
    d.define("execution.progress.check.interval.ms", ConfigType.LONG, 10_000,
             Importance.MEDIUM, "Metadata poll interval during execution "
             "(real-backend executions; the simulated backend is "
             "tick-driven).", at_least(1), G)
    d.define("execution.task.timeout.ticks", ConfigType.INT, 100,
             Importance.LOW, "Progress checks an in-flight move may take "
             "before being declared DEAD.", at_least(1), G)
    d.define("execution.history.retention", ConfigType.INT, 64,
             Importance.LOW, "ExecutionResults retained in the executor's "
             "bounded history deque (was unbounded).", at_least(1), G)
    d.define("execution.checkpoint.path", ConfigType.STRING, None,
             Importance.MEDIUM,
             "Write-ahead execution checkpoint file "
             "(cc-tpu-execution-checkpoint/1 JSONL). When set, the "
             "executor journals every drive-loop state transition and a "
             "restarted process resumes the execution instead of "
             "orphaning in-flight moves; None disables durability.",
             None, G)
    d.define("execution.checkpoint.max.bytes", ConfigType.LONG, 4_194_304,
             Importance.LOW,
             "Checkpoint size at which the file is atomically compacted "
             "to a snapshot (start + latest per-task states).",
             at_least(1024), G)
    d.define("execution.task.retry.max.attempts", ConfigType.INT, 0,
             Importance.MEDIUM,
             "Re-dispatches a DEAD/timed-out move may get before going "
             "terminally DEAD (0 = upstream behavior, no retry).",
             at_least(0), G)
    d.define("execution.task.retry.backoff.base.ticks", ConfigType.INT, 2,
             Importance.LOW,
             "Exponential retry backoff base: attempt N waits "
             "base * 2^(N-1) ticks (capped) plus jitter.", at_least(1), G)
    d.define("execution.task.retry.backoff.max.ticks", ConfigType.INT, 64,
             Importance.LOW, "Retry backoff ceiling in ticks.",
             at_least(1), G)
    d.define("execution.task.retry.jitter.ticks", ConfigType.INT, 1,
             Importance.LOW,
             "Deterministic per-task jitter added to each backoff (0-N "
             "ticks, seeded by task id and attempt — no RNG, so scenario "
             "fingerprints stay reproducible).", at_least(0), G)
    d.define("execution.task.retry.dest.exclusion.threshold",
             ConfigType.INT, 3, Importance.LOW,
             "Failed-move outcomes charged to a destination broker before "
             "it is excluded from further dispatches and re-planned "
             "around (0 disables exclusion).", at_least(0), G)
    d.define("execution.watchdog.stuck.ticks", ConfigType.INT, 0,
             Importance.LOW,
             "Stuck-execution watchdog: after this many ticks without any "
             "dispatch or completion, stop dispatching; after twice this "
             "many, abort in-flight moves and journal "
             "execution.unrecoverable (0 disables).", at_least(0), G)
    d.define("execution.foreign.conflict.policy", ConfigType.STRING, "yield",
             Importance.MEDIUM,
             "What a planned task does when a FOREIGN reassignment "
             "(another controller, kafka-reassign-partitions) touches its "
             "partition mid-flight. 'yield': the task steps aside and "
             "retries after the foreign move drains (cancelled "
             "foreign-conflict when the retry budget is spent); 'abort': "
             "the whole plan aborts partial-gracefully on first conflict. "
             "Disjoint foreign moves are always tolerated and fed to the "
             "ConcurrencyAdjuster as external URPs.",
             one_of("yield", "abort"), G)
    d.define("execution.foreign.yield.backoff.ticks", ConfigType.INT, 4,
             Importance.LOW,
             "Ticks a yielded (pre-dispatch) task waits before re-checking "
             "its partition for foreign reassignment activity.",
             at_least(1), G)
    d.define("execution.revalidate.preconditions", ConfigType.BOOLEAN, True,
             Importance.MEDIUM,
             "Per-batch topology revalidation: verify each task against "
             "live metadata before its alterPartitionReassignments and "
             "cancel stale tasks with categorical reasons "
             "(topology-drift:deleted / topology-drift:rf-changed / "
             "foreign-conflict) instead of burning the retry budget on "
             "generic replica-mismatch failures.", None, G)
    d.define("default.replication.throttle", ConfigType.DOUBLE, None,
             Importance.MEDIUM, "Replication throttle (bytes/s); None = off.",
             None, G)
    d.define("default.replica.movement.strategies", ConfigType.LIST,
             "cruise_control_tpu_torch.executor.tasks.ReplicaMovementStrategy",
             Importance.MEDIUM, "Replica-move ordering strategy chain.",
             None, G)
    d.define("executor.notifier.class", ConfigType.CLASS, None,
             Importance.LOW, "ExecutorNotifier implementation invoked on "
             "execution finish/abort.", None, G)
    d.define("concurrency.adjuster.enabled", ConfigType.BOOLEAN, False,
             Importance.MEDIUM, "Adapt movement concurrency to live broker "
             "health (AIMD).", None, G)
    d.define("concurrency.adjuster.min.partition.movements.per.broker",
             ConfigType.INT, 1, Importance.LOW,
             "Adjuster floor for the per-broker move cap.", at_least(1), G)
    d.define("concurrency.adjuster.max.partition.movements.per.broker",
             ConfigType.INT, None, Importance.LOW,
             "Adjuster ceiling; None = 2x the configured cap.", None, G)
    d.define("concurrency.adjuster.healthy.ticks", ConfigType.INT, 3,
             Importance.LOW, "Consecutive healthy progress checks before the "
             "adjuster raises concurrency.", at_least(1), G)
    d.define("concurrency.adjuster.urp.threshold", ConfigType.INT, 1 << 30,
             Importance.LOW, "Halve concurrency when external "
             "under-replicated partitions exceed this.", at_least(0), G)

    G = "anomaly.detector"
    d.define("anomaly.detection.interval.ms", ConfigType.LONG, 300_000,
             Importance.HIGH, "Default detector scheduling interval.",
             at_least(1), G)
    d.define("goal.violation.detection.interval.ms", ConfigType.LONG, None,
             Importance.LOW, "Override for the goal-violation detector; "
             "None inherits anomaly.detection.interval.ms.", None, G)
    d.define("broker.failure.detection.interval.ms", ConfigType.LONG, None,
             Importance.LOW, "Override for the broker-failure detector.",
             None, G)
    d.define("metric.anomaly.detection.interval.ms", ConfigType.LONG, None,
             Importance.LOW, "Override for the metric-anomaly detector.",
             None, G)
    d.define("disk.failure.detection.interval.ms", ConfigType.LONG, None,
             Importance.LOW, "Override for the disk-failure detector.",
             None, G)
    d.define("topic.anomaly.detection.interval.ms", ConfigType.LONG, None,
             Importance.LOW, "Override for the topic-anomaly detector.",
             None, G)
    d.define("anomaly.detection.goals", ConfigType.LIST, _HARD_GOALS,
             Importance.HIGH, "Goals watched by GoalViolationDetector.",
             None, G)
    d.define("self.healing.goals", ConfigType.LIST, "",
             Importance.MEDIUM, "Goals used when self-healing fixes run; "
             "empty = the default goal stack.", None, G)
    d.define("self.healing.enabled", ConfigType.BOOLEAN, False,
             Importance.HIGH, "Master switch for automatic anomaly fixes.",
             None, G)
    d.define("self.healing.broker.failure.enabled", ConfigType.BOOLEAN, None,
             Importance.MEDIUM, "Per-type override of self.healing.enabled.",
             None, G)
    d.define("self.healing.goal.violation.enabled", ConfigType.BOOLEAN, None,
             Importance.MEDIUM, "Per-type override of self.healing.enabled.",
             None, G)
    d.define("self.healing.disk.failure.enabled", ConfigType.BOOLEAN, None,
             Importance.MEDIUM, "Per-type override of self.healing.enabled.",
             None, G)
    d.define("self.healing.metric.anomaly.enabled", ConfigType.BOOLEAN, None,
             Importance.MEDIUM, "Per-type override of self.healing.enabled.",
             None, G)
    d.define("self.healing.topic.anomaly.enabled", ConfigType.BOOLEAN, None,
             Importance.MEDIUM, "Per-type override of self.healing.enabled.",
             None, G)
    d.define("self.healing.maintenance.event.enabled", ConfigType.BOOLEAN,
             None, Importance.MEDIUM,
             "Per-type override of self.healing.enabled.", None, G)
    d.define("foreign.reassignment.detection.min.cycles", ConfigType.INT, 3,
             Importance.LOW,
             "Consecutive detection cycles a reassignment not owned by "
             "this executor must persist before a FOREIGN_REASSIGNMENT "
             "anomaly surfaces (alert-only: concurrent-writer overlap is "
             "handled by execution fencing and the per-task yield "
             "machinery, never by cancelling someone else's moves).",
             at_least(1), G)
    d.define("broker.failure.alert.threshold.ms", ConfigType.LONG, 900_000,
             Importance.MEDIUM, "Broker-down time before alerting.",
             at_least(0), G)
    d.define("broker.failure.self.healing.threshold.ms", ConfigType.LONG,
             1_800_000, Importance.MEDIUM,
             "Broker-down time before self-healing starts.", at_least(0), G)
    d.define("self.healing.cooldown.ms", ConfigType.LONG, 300_000,
             Importance.MEDIUM, "Minimum spacing between automatic fixes.",
             at_least(0), G)
    d.define("anomaly.notifier.class", ConfigType.CLASS, None,
             Importance.MEDIUM, "AnomalyNotifier implementation; None keeps "
             "the built-in SelfHealingNotifier.", None, G)
    d.define("metric.anomaly.finder.class", ConfigType.CLASS,
             "cruise_control_tpu_torch.detector.detectors.PercentileMetricAnomalyFinder",
             Importance.LOW, "MetricAnomalyFinder implementation.", None, G)
    d.define("metric.anomaly.percentile.upper.threshold", ConfigType.DOUBLE,
             95.0, Importance.LOW, "History percentile a latest-window "
             "metric must exceed to be anomalous.", between(0, 100), G)
    d.define("metric.anomaly.percentile.margin", ConfigType.DOUBLE, 1.5,
             Importance.LOW, "Multiplier over the history percentile before "
             "flagging.", at_least(1), G)
    d.define("metric.anomaly.min.windows", ConfigType.INT, 3,
             Importance.LOW, "Minimum windows of history before metric "
             "anomalies are considered.", at_least(1), G)
    d.define("metric.anomaly.percentile.lower.threshold", ConfigType.DOUBLE,
             0.0, Importance.LOW, "History percentile a latest-window "
             "metric must COLLAPSE below (by the margin) to be anomalous "
             "— a broker gone quiet is as suspicious as one gone hot; "
             "0 disables the lower-side check.", between(0, 100), G)
    d.define("goal.violation.distribution.threshold.multiplier",
             ConfigType.DOUBLE, 1.0, Importance.MEDIUM,
             "Widen every balance-threshold gap by this factor during "
             "goal-violation DETECTION only (upstream "
             "AnomalyDetectorConfig), so a cluster balanced to the "
             "optimizer's threshold doesn't re-trigger self-healing on "
             "drift noise.", at_least(1), G)
    d.define("topic.anomaly.min.bad.partitions", ConfigType.INT, 1,
             Importance.LOW, "Under-replicated partitions tolerated "
             "before the topic-anomaly RF repair fires.", at_least(1), G)
    d.define("disk.failure.min.offline.dirs", ConfigType.INT, 1,
             Importance.LOW, "Offline log dirs a broker must accumulate "
             "before the disk-failure detector reports it.", at_least(1), G)
    d.define("self.healing.target.topic.replication.factor", ConfigType.INT,
             None, Importance.LOW, "Target RF for the topic-anomaly "
             "detector; None reads cluster.configs.file.", None, G)
    d.define("maintenance.event.reader.class", ConfigType.CLASS, None,
             Importance.LOW, "MaintenanceEventReader implementation.",
             None, G)
    d.define("anomaly.detector.history.size", ConfigType.INT, 100,
             Importance.LOW, "Recent anomalies retained in state().",
             at_least(1), G)
    d.define("broker.failures.persistence.path", ConfigType.STRING, None,
             Importance.LOW, "File persisting first-seen failure times.",
             None, G)

    G = "webserver"
    d.define("webserver.http.port", ConfigType.INT, 9090,
             Importance.HIGH, "REST listen port.", at_least(0), G)
    d.define("webserver.http.address", ConfigType.STRING, "127.0.0.1",
             Importance.MEDIUM, "REST bind address.", None, G)
    d.define("webserver.api.urlprefix", ConfigType.STRING,
             "/kafkacruisecontrol", Importance.LOW, "API path prefix.",
             None, G)
    d.define("webserver.http.cors.enabled", ConfigType.BOOLEAN, False,
             Importance.LOW, "Emit CORS headers on REST responses.", None, G)
    d.define("webserver.http.cors.origin", ConfigType.STRING, "*",
             Importance.LOW, "Access-Control-Allow-Origin value when CORS "
             "is enabled.", None, G)
    d.define("webserver.accesslog.enabled", ConfigType.BOOLEAN, True,
             Importance.LOW, "Log one line per HTTP request.", None, G)
    d.define("webserver.security.enable", ConfigType.BOOLEAN, False,
             Importance.HIGH, "Require authentication on REST requests.",
             None, G)
    d.define("webserver.security.provider", ConfigType.CLASS, None,
             Importance.MEDIUM, "SecurityProvider implementation; None with "
             "security enabled selects HTTP Basic from the credentials "
             "file.", None, G)
    d.define("basic.auth.credentials.file", ConfigType.STRING, None,
             Importance.MEDIUM, "user:password lines for HTTP Basic auth.",
             None, G)
    d.define("webserver.security.jwt.secret.file", ConfigType.STRING, None,
             Importance.LOW, "HS256 secret file for the JWT provider.",
             None, G)
    d.define("webserver.security.jwt.audience", ConfigType.STRING, None,
             Importance.LOW, "Required JWT audience claim; None skips the "
             "check.", None, G)
    d.define("trusted.proxy.ip.addresses", ConfigType.LIST, "",
             Importance.LOW, "IPs allowed to assert identity via the "
             "trusted-proxy provider.", None, G)
    d.define("trusted.proxy.user.header", ConfigType.STRING,
             "X-Forwarded-User", Importance.LOW,
             "Header carrying the proxied identity.", None, G)
    d.define("spnego.principal", ConfigType.STRING, None,
             Importance.LOW, "SPNEGO service principal (provider is an "
             "explicit stub in this build — no Kerberos stack).", None, G)
    d.define("spnego.keytab.file", ConfigType.STRING, None,
             Importance.LOW, "SPNEGO keytab path (stub provider).", None, G)
    d.define("two.step.verification.enabled", ConfigType.BOOLEAN, False,
             Importance.MEDIUM, "Route mutating endpoints through the "
             "review purgatory.", None, G)
    d.define("two.step.purgatory.retention.time.ms", ConfigType.LONG,
             86_400_000, Importance.LOW,
             "Retention of pending/finished review requests.",
             at_least(0), G)
    d.define("webserver.ui.path", ConfigType.STRING, None,
             Importance.LOW, "Directory or HTML file served at /ui; None "
             "serves the built-in dashboard.", None, G)
    d.define("max.active.user.tasks", ConfigType.INT, 25,
             Importance.MEDIUM, "Concurrent async user tasks.", at_least(1), G)
    d.define("completed.user.task.retention.time.ms", ConfigType.LONG,
             86_400_000, Importance.LOW,
             "TTL of finished task results.", at_least(0), G)
    d.define("max.cached.completed.user.tasks", ConfigType.INT, 100,
             Importance.LOW, "Completed tasks kept regardless of TTL.",
             at_least(0), G)
    d.define("user.task.executor.threads", ConfigType.INT, 4,
             Importance.LOW, "Worker threads running async user tasks.",
             at_least(1), G)
    d.define("webserver.request.get.max.concurrent", ConfigType.INT, 16,
             Importance.MEDIUM, "Concurrent read requests (GET + async "
             "polls) admitted; beyond this requests wait in the bounded "
             "admission queue.", at_least(1), G)
    d.define("webserver.request.compute.max.concurrent", ConfigType.INT, 4,
             Importance.MEDIUM, "Concurrent analyzer-bound requests "
             "(async POST submissions) admitted.", at_least(1), G)
    d.define("webserver.request.queue.size", ConfigType.INT, 16,
             Importance.MEDIUM, "Bounded admission queue in front of the "
             "per-class concurrency limits; a full queue load-sheds with "
             "429 + Retry-After.", at_least(0), G)
    d.define("webserver.request.queue.timeout.ms", ConfigType.LONG, 2000,
             Importance.LOW, "Max admission-queue wait before a request "
             "is shed (clipped by the request's own deadline-ms).",
             at_least(0), G)
    d.define("webserver.request.default.deadline.ms", ConfigType.LONG, 0,
             Importance.LOW, "Default per-request deadline when the "
             "client sends no deadline-ms header (0 = none).",
             at_least(0), G)
    d.define("webserver.request.max.body.bytes", ConfigType.INT, 1_048_576,
             Importance.LOW, "POST bodies declared larger than this are "
             "rejected with 413 before anything reads them (0 disables).",
             at_least(0), G)
    d.define("webserver.request.read.timeout.ms", ConfigType.LONG, 10_000,
             Importance.LOW, "Per-connection socket read timeout: a "
             "slow-loris client trickling bytes is disconnected (thread "
             "reaped) after this.", at_least(1), G)
    d.define("webserver.request.drain.timeout.ms", ConfigType.LONG, 5_000,
             Importance.LOW, "Graceful-shutdown bound: in-flight requests "
             "are joined at most this long after the server stops "
             "accepting.", at_least(0), G)
    d.define("webserver.request.max.inflight", ConfigType.INT, 0,
             Importance.MEDIUM, "Global in-flight request ceiling — a "
             "storm beyond it is shed with 429 + Retry-After at the door "
             "(0 = auto: per-class limits + queue + headroom).",
             at_least(0), G)

    # framework-specific: the cuda search engine (no upstream equivalent —
    # replaces AnalyzerConfig's greedy-recursion knobs); the kernels it
    # launches are cached by source hash, so no compilation-cache key
    G = "cuda.engine"
    d.define("cuda.mesh.devices", ConfigType.INT, 0,
             Importance.MEDIUM, "Shard the search over this many devices "
             "(0 = single device; requires that many cards).",
             at_least(0), G)
    d.define("cuda.search.max.rounds", ConfigType.INT, 150,
             Importance.MEDIUM, "Score-only search round budget.",
             at_least(1), G)
    d.define("cuda.search.candidate.budget", ConfigType.INT, 1 << 23,
             Importance.MEDIUM, "K x D candidate budget per round.",
             at_least(1), G)
    d.define("cuda.search.max.source.replicas", ConfigType.INT, 8192,
             Importance.MEDIUM, "Source-pool cap K.", at_least(1), G)
    d.define("cuda.search.max.dest.brokers", ConfigType.INT, 1024,
             Importance.MEDIUM, "Destination-pool cap D.", at_least(1), G)
    d.define("cuda.search.topk.per.round", ConfigType.INT, 2048,
             Importance.LOW, "Candidates returned per score-only round.",
             at_least(1), G)
    d.define("cuda.search.max.moves.per.round", ConfigType.INT, 4096,
             Importance.LOW, "Host-commit cap per score-only round.",
             at_least(1), G)
    d.define("cuda.search.improvement.tolerance", ConfigType.DOUBLE, -1e-4,
             Importance.LOW, "Per-action commit threshold (negative delta).",
             None, G)
    d.define("cuda.search.weight.util.variance", ConfigType.DOUBLE, 1.0,
             Importance.LOW, "Soft-cost weight: utilization spread.",
             at_least(0), G)
    d.define("cuda.search.weight.balance.bound", ConfigType.DOUBLE, 8.0,
             Importance.LOW, "Soft-cost weight: balance-bound overruns.",
             at_least(0), G)
    d.define("cuda.search.weight.replica.count", ConfigType.DOUBLE, 0.25,
             Importance.LOW, "Soft-cost weight: replica-count balance.",
             at_least(0), G)
    d.define("cuda.search.weight.leader.count", ConfigType.DOUBLE, 0.25,
             Importance.LOW, "Soft-cost weight: leader-count balance.",
             at_least(0), G)
    d.define("cuda.search.weight.leader.nwin", ConfigType.DOUBLE, 0.5,
             Importance.LOW, "Soft-cost weight: leader bytes-in balance.",
             at_least(0), G)
    d.define("cuda.search.weight.potential.nwout", ConfigType.DOUBLE, 1.0,
             Importance.LOW, "Soft-cost weight: potential NW-out overrun.",
             at_least(0), G)
    d.define("cuda.search.weight.move.size", ConfigType.DOUBLE, 1e-3,
             Importance.LOW, "Movement friction per normalized disk MB.",
             at_least(0), G)
    d.define("cuda.search.scoring", ConfigType.STRING, "auto",
             Importance.LOW, "Move scorer: auto/grid/columnar.",
             one_of("auto", "grid", "columnar"), G)
    d.define("cuda.search.steps.per.call", ConfigType.INT, 512,
             Importance.MEDIUM, "Device-resident steps per call (0 = "
             "score-only rounds).", at_least(0), G)
    d.define("cuda.search.repool.steps", ConfigType.INT, 128,
             Importance.LOW, "Steps between on-device candidate-pool "
             "rebuilds.", at_least(1), G)
    d.define("cuda.search.repool.incremental", ConfigType.BOOLEAN, True,
             Importance.LOW,
             "Pool-rebuild diet: carry the move-pool row tables in the "
             "search loop and refresh only the partitions the applied "
             "batches touched since the last repool (exact; bit-identical "
             "tables), falling back to a full rebuild when the touched set "
             "outgrows cuda.search.repool.rows.budget.", None, G)
    d.define("cuda.search.repool.rows.budget", ConfigType.INT, 8192,
             Importance.LOW,
             "Touched-partition rows refreshed per incremental pool "
             "rebuild before falling back to a full rebuild.",
             at_least(1), G)
    d.define("cuda.search.pipeline.depth", ConfigType.INT, 1,
             Importance.MEDIUM,
             "Drive-loop pipelining: speculative device calls kept in "
             "flight beyond the one whose result the host is processing.  "
             "The port runs the drive loop serially and accepts only the "
             "default until ROADMAP A4.", at_least(0), G)
    d.define("cuda.search.incremental.rescore", ConfigType.BOOLEAN, False,
             Importance.LOW,
             "Patch only staleness-touched grid entries between repools "
             "instead of full per-step rescores (off by default: measured "
             "step-cost-neutral at north-star scale and thins per-step "
             "commit availability).", None, G)
    d.define("cuda.search.rescore.rows.budget", ConfigType.INT, 512,
             Importance.LOW, "Partition-touched rows rescored per step "
             "before falling back to a full rescore.", at_least(1), G)
    d.define("cuda.search.rescore.cols.budget", ConfigType.INT, 128,
             Importance.LOW, "Stale destination columns rescored per step "
             "before falling back to a full rescore.", at_least(1), G)
    d.define("cuda.search.rescore.lead.budget", ConfigType.INT, 2048,
             Importance.LOW, "Stale leadership entries rescored per step "
             "before falling back to a full rescore.", at_least(1), G)
    d.define("cuda.search.rescore.refresh.steps", ConfigType.INT, 8,
             Importance.LOW,
             "Force a full rescore every this many steps when incremental "
             "rescore is on (bounds alternate-depth thinning; 0 = never).",
             at_least(0), G)
    d.define("cuda.search.cohort.mode", ConfigType.STRING, "budget",
             Importance.LOW,
             "Multi-accept cohort rule: water-filling budgets or "
             "exact-conservative corrected stacking.",
             one_of("budget", "corrected"), G)
    d.define("cuda.search.device.batch.per.step", ConfigType.INT, 0,
             Importance.LOW, "Actions committed per device step (0 = "
             "auto-scale with broker count).", at_least(0), G)
    d.define("cuda.search.moves.per.src", ConfigType.INT, 4,
             Importance.LOW, "Move candidates offered per source broker "
             "per step.", at_least(1), G)
    d.define("cuda.search.time.budget.s", ConfigType.DOUBLE, 0.0,
             Importance.MEDIUM, "Anytime budget: stop soft-goal refinement "
             "after this many seconds (0 = unlimited; hard-goal repair "
             "always completes).", at_least(0), G)
    d.define("cuda.search.profiler.trace.dir", ConfigType.STRING, "",
             Importance.LOW, "Trace every search into this directory "
             "(a torch.profiler Chrome trace through the kernel "
             "observatory's one session, parsed like a capture; empty: no "
             "trace).", None, G)
    d.define("cuda.search.polish.rounds", ConfigType.INT, 0,
             Importance.LOW, "Score-only polish rounds after the resident "
             "search converges.", at_least(0), G)
    d.define("cuda.search.cohort.stack.tolerance", ConfigType.DOUBLE, 1.0,
             Importance.LOW, "Corrected-cohort commit-ordering guard: max "
             "fraction of a stacked row's own gain its stacking "
             "(convexity) gap may consume; >=1 (default) disables the "
             "guard.", at_least(0.0), G)
    d.define("cuda.search.selection.rows", ConfigType.INT, 1024,
             Importance.LOW, "Candidate rows kept after the per-step "
             "compaction (the cohort/auction problem size).",
             at_least(256), G)
    d.define("cuda.search.shard.tables", ConfigType.BOOLEAN, True,
             Importance.LOW, "Shard the [P, S] pool row tables and their "
             "priority build across the search mesh.  Needs a multi-card "
             "mesh: only the default is accepted until ROADMAP A11.",
             None, G)
    d.define("cuda.search.shard.donate", ConfigType.BOOLEAN, True,
             Importance.LOW, "Donate the sharded search call's carry "
             "buffers.  Needs a multi-card mesh: only the default is "
             "accepted until ROADMAP A11.", None, G)

    # framework-specific: structured tracing spans + /metrics exposition
    # (telemetry/).  The upstream analog is the always-on Dropwizard
    # registry behind JMX; the registry here is always on too — these keys
    # govern only the span layer.
    G = "telemetry"
    d.define("telemetry.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Record structured tracing spans through "
             "the request path (request/operation/engine-phase timing, "
             "GET /metrics phase timers, /state?verbose=true recent "
             "spans).  Disabled spans cost one guarded call.", None, G)
    d.define("telemetry.span.ring.size", ConfigType.INT, 256,
             Importance.LOW, "Completed root spans retained for "
             "/state?verbose=true.", at_least(1), G)
    d.define("telemetry.slow.span.log.ms", ConfigType.DOUBLE, 0.0,
             Importance.LOW, "Warn-log any span at least this slow "
             "(0 = off).", at_least(0), G)
    d.define("telemetry.recorder.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Run the flight recorder: a background "
             "thread sampling the metric registry into bounded time "
             "series, served as the cc-tpu-flight-recorder/1 artifact on "
             "GET /diagnostics and dumped to disk when a self-healing fix "
             "fails.", None, G)
    d.define("telemetry.recorder.interval.ms", ConfigType.DOUBLE, 5000.0,
             Importance.LOW, "Flight-recorder sampling interval.",
             at_least(10), G)
    d.define("telemetry.recorder.retention.samples", ConfigType.INT, 720,
             Importance.LOW, "Points retained per flight-recorder series "
             "(720 x 5s = one hour).", at_least(2), G)
    d.define("telemetry.recorder.dump.dir", ConfigType.STRING, None,
             Importance.LOW, "Directory for incident artifacts (dumped on "
             "anomaly FIX_FAILED); None disables dump-to-file.", None, G)
    d.define("telemetry.device.stats.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Build observability: per-function counts and "
             "seconds of the kernel libraries' builds and loads and of the "
             "step chunk's CUDA-graph captures, the shape-churn retrace "
             "detector over step-loop keys, and the card allocator's "
             "live-buffer count/bytes gauges.", None, G)
    d.define("telemetry.device.stats.retrace.threshold", ConfigType.INT, 8,
             Importance.LOW, "Distinct compiled argument shapes per "
             "logical function above which further compiles count as "
             "retraces (shape churn) and warn.", at_least(2), G)
    d.define("telemetry.events.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Record the structured decision journal "
             "(cc-tpu-events/1): optimize/execute lifecycle with per-goal "
             "summaries, executor batches and task deaths, detector "
             "decisions, startup config snapshot.  Served on GET /events "
             "and merged into the flight-recorder artifact.", None, G)
    d.define("telemetry.events.path", ConfigType.STRING, None,
             Importance.MEDIUM, "Append-only JSONL file for the event "
             "journal (a failed rebalance is reconstructable from this "
             "file alone).  None keeps the journal in-memory only.",
             None, G)
    d.define("telemetry.events.max.bytes", ConfigType.INT, 16_777_216,
             Importance.LOW, "Size-rotate the events file beyond this many "
             "bytes (file -> file.1 -> ...).", at_least(4096), G)
    d.define("telemetry.events.max.files", ConfigType.INT, 3,
             Importance.LOW, "Rotated event files kept (the live file plus "
             "max.files-1 predecessors).", at_least(1), G)
    d.define("telemetry.events.ring.size", ConfigType.INT, 2048,
             Importance.LOW, "Events retained in memory for GET /events "
             "and the flight-recorder merge.", at_least(16), G)
    d.define("telemetry.logging.json", ConfigType.BOOLEAN, False,
             Importance.LOW, "Emit application logs as structured JSON "
             "lines sharing the event-journal field names (ts/severity/"
             "kind), so grep/jq work across both files.", None, G)
    d.define("telemetry.slo.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Run the SLO observatory: periodic "
             "evaluation of the declarative SLO registry (heal-latency "
             "percentiles, serve p99s, warm-replan duty cycle, zero "
             "unhandled 5xx, bounded growth) over the event journal + "
             "metric registry, with slo.breach/slo.recovered journal "
             "events and the cc-tpu-slo/1 gate table on GET /slo.",
             None, G)
    d.define("telemetry.slo.interval.ms", ConfigType.DOUBLE, 30_000.0,
             Importance.LOW, "SLO evaluation period (the observatory's "
             "background tick; also pumps pending device-cost captures).",
             at_least(10), G)
    d.define("telemetry.slo.window.ms", ConfigType.INT, 600_000,
             Importance.LOW, "Sliding journal window each SLO is "
             "evaluated over (by record timestamp).", at_least(1000), G)
    d.define("telemetry.slo.breach.cycles", ConfigType.INT, 2,
             Importance.LOW, "Consecutive violating evaluations before a "
             "SLO transitions to BREACHED (hysteresis: one noisy window "
             "must not page).", at_least(1), G)
    d.define("telemetry.slo.recover.cycles", ConfigType.INT, 2,
             Importance.LOW, "Consecutive passing evaluations before a "
             "breached SLO transitions back to OK.", at_least(1), G)
    d.define("telemetry.slo.objectives", ConfigType.STRING, None,
             Importance.LOW, "Objective overrides as "
             "'name=value,name=value' (e.g. "
             "'serve.cached_get.p99.ms=25,replan.warm.duty.cycle=0.8'); "
             "unnamed SLOs keep their registry defaults.", None, G)
    d.define("telemetry.trace.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Retain completed request-correlated span "
             "trees in the bounded trace store: one X-Trace-Id per "
             "request, stamped on every span and journal event it "
             "produces, reconstructable as Chrome-trace JSON on "
             "GET /trace?id=.", None, G)
    d.define("telemetry.trace.max.traces", ConfigType.INT, 64,
             Importance.LOW, "Distinct trace ids retained (oldest "
             "evicted).", at_least(1), G)
    d.define("telemetry.trace.spans.per.trace", ConfigType.INT, 512,
             Importance.LOW, "Root span trees retained per trace id.",
             at_least(1), G)
    d.define("telemetry.device.cost.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Capture each built executable's cost (a "
             "captured step chunk, a round, a what-if call: work-model "
             "operations and bytes a call, static, output and capture "
             "memory) off the request path, exported as cc_device_* gauges "
             "and the live HBM-bandwidth utilization estimate.", None, G)
    d.define("telemetry.device.cost.hbm.gbps", ConfigType.DOUBLE, 3350.0,
             Importance.LOW, "Assumed per-device HBM bandwidth (GB/s) for "
             "the utilization estimate (an H100 SXM's HBM3: 3 350).",
             at_least(0.001), G)
    d.define("telemetry.kernel.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Kernel observatory "
             "(telemetry/kernel_budget.py): allow on-demand device-kernel "
             "captures (GET /profile/kernels?arm=true) around drive-loop "
             "scan calls, parsed off the request thread into the "
             "cc-tpu-kernel-budget/2 artifact, cc_kernel_*/cc_shard_* "
             "metric families, and the /diagnostics kernelBudget block. "
             "Disarmed cost is one attribute check per scan call.",
             None, G)
    d.define("telemetry.kernel.capture.scans", ConfigType.INT, 3,
             Importance.LOW, "Drive-loop scan calls traced per capture "
             "when the arm request names no count.", at_least(1), G)
    d.define("telemetry.kernel.trace.dir", ConfigType.STRING, None,
             Importance.LOW, "Parent directory for capture traces (a "
             "per-capture temp subdirectory is created and removed after "
             "parsing); empty = the system temp dir.", None, G)
    d.define("telemetry.mesh.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Mesh observatory "
             "(telemetry/mesh_budget.py): ride armed kernel captures to "
             "decompose wall time into busy / collective-wait / transfer "
             "/ host-gap per device, account collective HLOs and H2D/D2H "
             "transfers, and audit replicated vs sharded bytes across "
             "live arrays (GET /profile/mesh, cc_collective_*/"
             "cc_transfer_*/cc_mesh_* families, /diagnostics meshBudget "
             "block). No profiler session of its own — observes the "
             "kernel observatory's captures.", None, G)
    d.define("telemetry.mesh.ledger.enabled", ConfigType.BOOLEAN, True,
             Importance.LOW, "Count bytes through the instrumented "
             "transfer entry points (mesh_budget.device_put/fetch) into "
             "the per-function transfer ledger; disabling keeps the "
             "trace-derived transfer accounting only.", None, G)
    d.define("telemetry.mesh.audit.max.arrays", ConfigType.INT, 4096,
             Importance.LOW, "Live arrays the replication audit walks "
             "before truncating (bounds audit cost on huge states).",
             at_least(1), G)
    d.define("telemetry.host.enabled", ConfigType.BOOLEAN, True,
             Importance.MEDIUM, "Host observatory "
             "(telemetry/host_profile.py): an always-on sampling "
             "profiler walks every thread's stack on a daemon tick, "
             "aggregating folded stacks per thread role into a bounded "
             "rolling window; GET /profile/host?arm=true captures the "
             "next N ticks into a cc-tpu-host-profile/1 artifact "
             "(flame-graph folded lines), built off-thread on the SLO "
             "maintenance tick. Also gates the named-lock contention "
             "detector and the cc_host_* metric families. Always-on "
             "cost is gated at <=1% (bench.py "
             "host_profiler_overhead_pct).", None, G)
    d.define("telemetry.host.sample.interval.ms", ConfigType.DOUBLE, 50.0,
             Importance.LOW, "Sampling-profiler tick interval "
             "(milliseconds between stack walks).", at_least(1), G)
    d.define("telemetry.host.capture.samples", ConfigType.INT, 100,
             Importance.LOW, "Sampling ticks per capture when the arm "
             "request names no count.", at_least(1), G)
    d.define("telemetry.host.contention.threshold.ms", ConfigType.DOUBLE,
             250.0, Importance.LOW, "Named-lock wait accumulated in one "
             "contention-check window (the SLO maintenance tick) above "
             "which the lock counts as hot; two consecutive hot windows "
             "journal contention.hot_lock.", at_least(1), G)
    d.define("telemetry.host.contention.sustain.windows", ConfigType.INT,
             2, Importance.LOW, "Consecutive hot windows before a "
             "contention.hot_lock event is journaled (cooldown-limited "
             "per lock).", at_least(1), G)
    d.define("telemetry.host.lock.order.witness", ConfigType.BOOLEAN,
             False, Importance.LOW, "Record runtime lock-acquisition "
             "ORDER on the named-lock registry (utils/locks.py): thread "
             "holds A, acquires B => edge A->B into a bounded edge map, "
             "read back via ContentionRegistry.order_witness(). The "
             "reconciliation test validates observed edges against the "
             "static cc-tpu-lock-graph/1 artifact (cclint lock-order). "
             "Off by default; the off path is one attribute check "
             "(bench.py lock_witness_overhead_pct).", None, G)

    # the build environment has no Kafka: the standalone server manages a
    # simulated cluster whose shape these keys control (bootstrap.py); a
    # real-Kafka deployment swaps the backend and ignores them
    G = "simulation"
    d.define("simulation.num.brokers", ConfigType.INT, 12,
             Importance.LOW, "Simulated cluster broker count.", at_least(1), G)
    d.define("simulation.num.partitions", ConfigType.INT, 120,
             Importance.LOW, "Simulated partition count.", at_least(1), G)
    d.define("simulation.replication.factor", ConfigType.INT, 2,
             Importance.LOW, "Simulated replication factor.", at_least(1), G)
    d.define("simulation.num.racks", ConfigType.INT, 4,
             Importance.LOW, "Simulated rack count.", at_least(1), G)
    d.define("simulation.seed", ConfigType.INT, 42,
             Importance.LOW, "Workload RNG seed.", None, G)
    d.define("simulation.num.topics", ConfigType.INT, 4,
             Importance.LOW, "Simulated topic count.", at_least(1), G)
    d.define("simulation.workload.noise.std", ConfigType.DOUBLE, 0.0,
             Importance.LOW, "Relative noise on reported samples.",
             at_least(0), G)
    d.define("simulation.target.mean.utilization", ConfigType.DOUBLE, 0.45,
             Importance.LOW, "Auto-sized broker capacities aim for this "
             "mean utilization.", between(0.01, 1), G)
    # long-horizon soak driver (python -m cruise_control_tpu_torch.sim.soak):
    # a seeded fault-schedule day over the full stack, gated on SLOs
    d.define("sim.soak.profile", ConfigType.STRING, "soak_day",
             Importance.LOW, "Named soak the CLI runs by default "
             "(soak_smoke = the tier-1 fingerprinted variant, soak_day = "
             "the full simulated day).", None, G)
    d.define("sim.soak.seed", ConfigType.INT, 12,
             Importance.LOW, "Fault-schedule RNG seed: same seed, same "
             "day — byte for byte.", None, G)
    d.define("sim.soak.num.brokers", ConfigType.INT, 1024,
             Importance.LOW, "Soak cluster broker count (the committed "
             "SOAK artifact runs >= 1000).", at_least(4), G)
    d.define("sim.soak.num.partitions", ConfigType.INT, 4096,
             Importance.LOW, "Soak cluster partition count.",
             at_least(4), G)
    d.define("sim.soak.duration.minutes", ConfigType.INT, 1440,
             Importance.LOW, "Virtual soak horizon in minutes (1440 = one "
             "day).", at_least(10), G)
    d.define("sim.soak.engine", ConfigType.STRING, "cuda",
             Importance.LOW, "Analyzer engine the soak's facade heals and "
             "replans with (cuda | greedy).", None, G)
    d.define("sim.soak.slo.window.minutes", ConfigType.INT, 60,
             Importance.LOW, "Rolling SLO-engine window (virtual minutes) "
             "for the soak's hysteresis pass.", at_least(1), G)

    G = "logging"
    d.define("logging.level", ConfigType.STRING, "INFO",
             Importance.MEDIUM, "Root log level "
             "(DEBUG/INFO/WARNING/ERROR).", None, G)
    d.define("logging.file", ConfigType.STRING, None,
             Importance.MEDIUM, "Log file path; None logs to stderr.",
             None, G)
    return d


DEFAULT_CONFIG_DEF = default_config_def()

"""Real-Kafka adapter stack behind the framework's existing SPIs
(VERDICT round-1 item #2; upstream ``executor/Executor.java`` AdminClient
usage, ``CruiseControlMetricsReporterSampler.java``,
``KafkaSampleStore.java``).

Everything is written against the :class:`~.wire.KafkaWire` RPC seam and
fully exercised over the scripted :class:`~.wire.FakeKafkaWire`; a real
deployment supplies a wire over an actual client library
(:func:`~.wire.real_wire`)."""

from cruise_control_tpu_torch.kafka.backend import KafkaClusterBackend
from cruise_control_tpu_torch.kafka.metadata import KafkaMetadataClient
from cruise_control_tpu_torch.kafka.sample_store import KafkaSampleStore
from cruise_control_tpu_torch.kafka.sampler import (
    KafkaMetricsReporter,
    KafkaMetricsReporterSampler,
)
from cruise_control_tpu_torch.kafka.wire import (
    FakeKafkaWire,
    FatalWireError,
    KafkaWire,
    RetriableWireError,
    UnsupportedRpcError,
    WireError,
    WireTimeoutError,
    real_wire,
)


#: ``*.timeout.ms`` config key → wire RPC class (CONFIG_DELTA §1: the
#: upstream per-RPC timeout family, mapped onto the wire's surface)
RPC_TIMEOUT_KEYS = {
    "describe.cluster.timeout.ms": "describe_cluster",
    "list.partition.reassignments.timeout.ms": "reassignment",
    "logdir.response.timeout.ms": "logdirs",
    "metadata.timeout.ms": "metadata",
    "produce.timeout.ms": "produce",
    "consume.timeout.ms": "consume",
}


def rpc_timeouts_from_config(cfg):
    """Per-RPC-class timeout overrides (seconds) from the ``*.timeout.ms``
    keys; a key left at 0 inherits ``default.api.timeout.ms``."""
    out = {}
    for key, rpc_class in RPC_TIMEOUT_KEYS.items():
        ms = cfg.get_int(key)
        if ms > 0:
            out[rpc_class] = ms / 1000.0
    return out


def build_kafka_stack(cfg, wire=None):
    """(backend, metadata, sampler, sample_store, wire) for a Kafka
    deployment.

    Consumes the Kafka-facing config keys: ``bootstrap.servers`` (used to
    dial a real wire when none is supplied), ``default.api.timeout.ms``
    plus the per-RPC ``*.timeout.ms`` family (:data:`RPC_TIMEOUT_KEYS`),
    ``metric.reporter.topic``,
    ``partition.metric.sample.store.topic``,
    ``broker.metric.sample.store.topic``,
    ``sample.store.topic.replication.factor``,
    ``num.sample.loading.threads``,
    ``execution.progress.check.interval.ms``, ``metadata.max.age.ms``.

    The wire is returned so callers needing per-consumer state (e.g. one
    sampler per metric fetcher, each with its own offset cursor) can build
    more clients over the same connection.
    """
    if wire is None:
        wire = real_wire(
            cfg.get("bootstrap.servers"),
            timeout_s=cfg.get_int("default.api.timeout.ms") / 1000.0,
            timeouts=rpc_timeouts_from_config(cfg),
        )
    backend = KafkaClusterBackend(
        wire,
        progress_check_interval_ms=cfg.get_int(
            "execution.progress.check.interval.ms"
        ),
    )
    metadata = KafkaMetadataClient(
        backend, max_age_ms=cfg.get_int("metadata.max.age.ms")
    )
    sampler = KafkaMetricsReporterSampler(
        wire, topic=cfg.get("metric.reporter.topic"),
        # the backend resolves envelope (topic, partition) addresses to
        # dense ids and provides leadership for topic-rate distribution
        metadata=backend,
    )
    # store-topic retention must cover the window history the aggregators
    # keep (+1 window of slack), or replay after restart comes up short;
    # anything longer only grows the topics and the startup replay.  The
    # partition and broker aggregators have independent window spans —
    # cover whichever history is longer.
    retention_ms = max(
        int(cfg.get("partition.metrics.window.ms"))
        * (cfg.get_int("num.partition.metrics.windows") + 1),
        int(cfg.get("broker.metrics.window.ms"))
        * (cfg.get_int("num.broker.metrics.windows") + 1),
    )
    store = KafkaSampleStore(
        wire,
        partition_topic=cfg.get("partition.metric.sample.store.topic"),
        broker_topic=cfg.get("broker.metric.sample.store.topic"),
        topic_replication_factor=cfg.get_int(
            "sample.store.topic.replication.factor"
        ),
        loading_threads=cfg.get_int("num.sample.loading.threads"),
        retention_ms=retention_ms,
    )
    return backend, metadata, sampler, store, wire

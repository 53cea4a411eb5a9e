"""Kafka-backed sample store (upstream
``monitor/sampling/KafkaSampleStore.java``): samples persist to two internal
topics and replay from offset 0 at startup, so the workload model survives
restarts (the LOADING state, SURVEY.md §5.4).

The store topics are RETENTION-bounded (``cleanup.policy=delete`` with
``retention.ms`` sized to the aggregators' window history): every sample is
unique per (entity, window), so compaction could never delete anything —
time-based retention is what bounds the topics and the startup replay
(upstream sizes its sample-store retention the same way)."""

from __future__ import annotations

import json
from typing import List, Tuple

from cruise_control_tpu_torch.kafka.wire import KafkaWire
from cruise_control_tpu_torch.monitor.sample_store import SampleStore
from cruise_control_tpu_torch.monitor.sampling import (
    BrokerMetricSample,
    PartitionMetricSample,
)

PARTITION_SAMPLES_TOPIC = "__KafkaCruiseControlPartitionMetricSamples"
BROKER_SAMPLES_TOPIC = "__KafkaCruiseControlModelTrainingSamples"


class KafkaSampleStore(SampleStore):
    def __init__(
        self,
        wire: KafkaWire,
        partition_topic: str = PARTITION_SAMPLES_TOPIC,
        broker_topic: str = BROKER_SAMPLES_TOPIC,
        topic_replication_factor: int = 2,
        loading_threads: int = 1,
        retention_ms: int = 24 * 60 * 60 * 1000,
    ):
        self.wire = wire
        self.partition_topic = partition_topic
        self.broker_topic = broker_topic
        #: num.sample.loading.threads — replay the two store topics on
        #: concurrent consumers when > 1 (network-bound on a real wire)
        self.loading_threads = loading_threads
        for t in (partition_topic, broker_topic):
            wire.create_topic(
                t, replication_factor=topic_replication_factor,
                configs={
                    "cleanup.policy": "delete",
                    "retention.ms": str(retention_ms),
                },
            )

    def store_samples(self, partition_samples, broker_samples) -> None:
        # records are keyed by (entity, window): unique per sample, so even
        # a PRE-EXISTING topic stuck on cleanup.policy=compact (created by
        # an older version; create_topic is idempotent and won't re-config)
        # can never compact the window history away
        if partition_samples:
            self.wire.produce(
                self.partition_topic,
                [
                    json.dumps(
                        [s.partition, s.time_ms, list(s.values)]
                    ).encode()
                    for s in partition_samples
                ],
                keys=[
                    f"{s.partition}:{s.time_ms}".encode()
                    for s in partition_samples
                ],
            )
        if broker_samples:
            self.wire.produce(
                self.broker_topic,
                [
                    json.dumps(
                        [s.broker_id, s.time_ms, list(s.values)]
                    ).encode()
                    for s in broker_samples
                ],
                keys=[
                    f"{s.broker_id}:{s.time_ms}".encode()
                    for s in broker_samples
                ],
            )

    def _load_partition_samples(self) -> List[PartitionMetricSample]:
        praw, _ = self.wire.consume(self.partition_topic, 0)
        return [
            PartitionMetricSample(p, t, tuple(v))
            for p, t, v in (json.loads(r) for r in praw)
        ]

    def _load_broker_samples(self) -> List[BrokerMetricSample]:
        braw, _ = self.wire.consume(self.broker_topic, 0)
        return [
            BrokerMetricSample(b, t, tuple(v))
            for b, t, v in (json.loads(r) for r in braw)
        ]

    def load_samples(
        self,
    ) -> Tuple[List[PartitionMetricSample], List[BrokerMetricSample]]:
        psamples, bsamples = self._replay_parallel(
            [self._load_partition_samples, self._load_broker_samples],
            self.loading_threads,
        )
        return psamples, bsamples

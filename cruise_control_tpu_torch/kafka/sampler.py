"""Kafka-backed metrics path: the ``__CruiseControlMetrics`` producer twin
and the consumer-side sampler (upstream
``cruise-control-metrics-reporter/.../CruiseControlMetricsReporter.java`` +
``monitor/sampling/CruiseControlMetricsReporterSampler.java``).

Records cross the wire in the upstream BINARY envelope by default
(:mod:`~cruise_control_tpu_torch.kafka.envelope` — versioned per-record layout,
(topic, partition-number) addressing), so the sampler can consume a topic
written by the real Java broker plugin and the twin's records are readable
by a real Cruise Control.  The compact JSON row format remains as a debug
encoding (``encoding="json"``); the sampler auto-detects per record, so
mixed topics and migrations just work.

Two interop behaviors beyond plain decoding:

* upstream reports *topic*-scope bytes rates (type ids 2/3), not
  partition-scope — the sampler DISTRIBUTES those over the topic's leader
  partitions on the reporting broker, weighted by the batch's
  ``PARTITION_SIZE`` records (even split when sizes are absent), the same
  estimation upstream's processor performs;
* envelope records address partitions as (topic, partition number); the
  sampler resolves them to the framework's dense ids through the backend
  ``metadata`` (``key((topic, p))``), skipping records for partitions the
  metadata does not know (counted, debug-logged).

Processing reuses the exact
:class:`~cruise_control_tpu_torch.monitor.sampling.MetricsProcessor` pipeline —
including the per-partition CPU estimation — so Kafka-fed and simulated
models are built by identical code.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.kafka.envelope import (
    _CLASS_FOR_TYPE,
    TOPIC_BYTES_IN_ID,
    TOPIC_BYTES_OUT_ID,
    UPSTREAM_TYPE_IDS,
    EnvelopeError,
    EnvelopeRecord,
    MetricClassId,
    decode_record,
    encode_record,
    is_envelope,
)
from cruise_control_tpu_torch.kafka.wire import KafkaWire
from cruise_control_tpu_torch.monitor.sampling import (
    CruiseControlMetric,
    MetricSampler,
    MetricsProcessor,
    RawMetricType,
)
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("kafka")

DEFAULT_METRICS_TOPIC = "__CruiseControlMetrics"


def encode_metric_json(m: CruiseControlMetric) -> bytes:
    """Debug JSON row (round-1 private format)."""
    return json.dumps(
        [m.metric_type.value, m.time_ms, m.broker_id, m.value, m.partition]
    ).encode()


def decode_metric_json(raw: bytes) -> CruiseControlMetric:
    t, time_ms, broker, value, partition = json.loads(raw)
    return CruiseControlMetric(
        RawMetricType(t), int(time_ms), int(broker), float(value),
        int(partition),
    )


# round-2 names, kept for compatibility
encode_metric = encode_metric_json
decode_metric = decode_metric_json


class KafkaMetricsReporter:
    """Producer side (what the broker plugin does): serialize raw metrics to
    the metrics topic, auto-creating it first (upstream
    ``CruiseControlMetricsUtils`` topic management).

    ``tp_of`` names partitions for the envelope: dense id → (topic,
    partition number), e.g. ``KafkaClusterBackend.tp``.  Without it,
    partition-scope records are written with topic ``""`` and the dense id
    as the partition number — a PRIVATE addressing the sampler recognizes,
    readable only by this framework (simulation/test rigs); supply
    ``tp_of`` wherever real-cluster compatibility matters."""

    def __init__(self, wire: KafkaWire, topic: str = DEFAULT_METRICS_TOPIC,
                 topic_replication_factor: int = 2,
                 encoding: str = "binary",
                 tp_of: Optional[Callable[[int], Tuple[str, int]]] = None):
        if encoding not in ("binary", "json"):
            raise ValueError(f"unknown metrics encoding {encoding!r}")
        self.wire = wire
        self.topic = topic
        self.encoding = encoding
        self.tp_of = tp_of
        wire.create_topic(
            topic, replication_factor=topic_replication_factor,
            configs={"retention.ms": str(60 * 60 * 1000)},
        )

    def _encode(self, m: CruiseControlMetric) -> bytes:
        if self.encoding == "json":
            return encode_metric_json(m)
        cls = _CLASS_FOR_TYPE[m.metric_type]
        topic = partition = None
        if cls == MetricClassId.PARTITION:
            topic, partition = (
                self.tp_of(m.partition) if self.tp_of else ("", m.partition)
            )
        return encode_record(EnvelopeRecord(
            cls, UPSTREAM_TYPE_IDS[m.metric_type], m.time_ms, m.broker_id,
            m.value, topic, partition,
        ))

    def report(self, records: Sequence[CruiseControlMetric]) -> None:
        self.wire.produce(self.topic, [self._encode(m) for m in records])


class KafkaMetricsReporterSampler(MetricSampler):
    """Consumer side: tail the metrics topic from the last consumed offset
    and run the shared processor.  Records timestamped at/after a poll's
    ``end_ms`` are held for the next poll (same late-record semantics as the
    in-process sampler, which the aggregator's window accounting relies
    on).

    ``metadata`` resolves envelope (topic, partition) addresses to dense
    ids and provides leadership for topic-scope distribution — any object
    with ``key(tp)``, ``partitions`` and ``partition_topic_names()``
    (:class:`~cruise_control_tpu_torch.kafka.backend.KafkaClusterBackend`
    qualifies).  Without it, only private dense-addressed records (topic
    ``""``) and broker-scope records are usable."""

    def __init__(self, wire: KafkaWire, topic: str = DEFAULT_METRICS_TOPIC,
                 processor: Optional[MetricsProcessor] = None,
                 metadata=None):
        self.wire = wire
        self.topic = topic
        self.processor = processor or MetricsProcessor()
        self.metadata = metadata
        self._offset = 0
        self._pending: List[CruiseControlMetric] = []
        #: records dropped because they could not be decoded / resolved —
        #: genuine problems worth a warning
        self.skipped = 0
        #: well-formed records whose type id this framework does not model
        #: (a real Java reporter emits dozens of request-time metrics we
        #: don't consume) — expected on a real cluster, debug-level only
        self.unmodeled = 0
        self._warned_at = 0
        self._batch_refreshed = False

    # ---- envelope → framework records --------------------------------------
    def _dense_key(self, topic: str, partition: int) -> Optional[int]:
        if topic == "":
            return partition  # private dense addressing (reporter twin)
        if self.metadata is None:
            return None
        tp = (topic, partition)
        try_key = getattr(self.metadata, "try_key", None)
        if try_key is not None:
            # refresh the metadata mapping at most ONCE per batch: a topic
            # full of stale records must not become one full-cluster
            # describe RPC per record
            k = try_key(tp, refresh=not self._batch_refreshed)
            if k is None:
                self._batch_refreshed = True
            return k
        try:
            return self.metadata.key(tp)
        except KeyError:
            return None

    def _convert(
        self, envelopes: List[EnvelopeRecord]
    ) -> List[CruiseControlMetric]:
        out: List[CruiseControlMetric] = []
        # batch PARTITION_SIZE by dense key: the weights for topic-scope
        # distribution
        sizes: Dict[int, float] = {}
        topic_rates: List[EnvelopeRecord] = []
        for r in envelopes:
            if r.metric_class == MetricClassId.BROKER:
                if r.metric_type is None:
                    self.unmodeled += 1
                    continue
                out.append(CruiseControlMetric(
                    r.metric_type, r.time_ms, r.broker_id, r.value))
            elif r.metric_class == MetricClassId.PARTITION:
                if r.metric_type is None:
                    self.unmodeled += 1
                    continue
                dense = self._dense_key(r.topic, r.partition)
                if dense is None:
                    self.skipped += 1
                    continue
                if r.metric_type == RawMetricType.PARTITION_SIZE:
                    sizes[dense] = r.value
                out.append(CruiseControlMetric(
                    r.metric_type, r.time_ms, r.broker_id, r.value, dense))
            else:  # TOPIC scope
                if r.type_id in (TOPIC_BYTES_IN_ID, TOPIC_BYTES_OUT_ID):
                    topic_rates.append(r)
                else:
                    self.unmodeled += 1
        out.extend(self._distribute_topic_rates(topic_rates, sizes))
        return out

    def _distribute_topic_rates(
        self, topic_rates: List[EnvelopeRecord], sizes: Dict[int, float]
    ) -> List[CruiseControlMetric]:
        """Topic-scope bytes rates → per-partition rates over the topic's
        leader partitions on the reporting broker (upstream derives
        partition rates from topic metrics the same way)."""
        if not topic_rates:
            return []
        if self.metadata is None:
            self.skipped += len(topic_rates)
            return []
        topic_of = self.metadata.partition_topic_names()
        states = self.metadata.partitions
        # one pass over the cluster: (topic, leader broker) → members.
        # A dense id the fresh describe no longer knows (topic deleted
        # since the backend learned it) is skipped, not a crash.
        members_of: Dict[Tuple[str, int], List[int]] = {}
        for dense, t in topic_of.items():
            st = states.get(dense)
            if st is not None:
                members_of.setdefault((t, st.leader), []).append(dense)
        out: List[CruiseControlMetric] = []
        for r in topic_rates:
            members = members_of.get((r.topic, r.broker_id), [])
            if not members:
                self.skipped += 1
                continue
            total_size = sum(sizes.get(d, 0.0) for d in members)
            mtype = (
                RawMetricType.PARTITION_BYTES_IN
                if r.type_id == TOPIC_BYTES_IN_ID
                else RawMetricType.PARTITION_BYTES_OUT
            )
            for d in members:
                share = (
                    sizes.get(d, 0.0) / total_size if total_size > 0
                    else 1.0 / len(members)
                )
                out.append(CruiseControlMetric(
                    mtype, r.time_ms, r.broker_id, r.value * share, d))
        return out

    # ---- sampling ----------------------------------------------------------
    def get_samples(self, start_ms: int, end_ms: int):
        raw, self._offset = self.wire.consume(self.topic, self._offset)
        self._batch_refreshed = False
        skipped_before = self.skipped
        decode_failed = 0
        envelopes: List[EnvelopeRecord] = []
        records: List[CruiseControlMetric] = list(self._pending)
        for r in raw:
            try:
                if is_envelope(r):
                    envelopes.append(decode_record(r))
                else:
                    records.append(decode_metric_json(r))
            except (EnvelopeError, ValueError, KeyError, TypeError):
                self.skipped += 1
                decode_failed += 1
        records.extend(self._convert(envelopes))
        if raw and self.skipped - skipped_before >= len(raw):
            # every record of a non-empty batch was dropped: that is not
            # noise — without this the monitor sits in LOADING forever
            # behind a rate-limited warning.  Name the actual cause: a
            # batch that failed to DECODE points at the wire format; a
            # batch that decoded but could not be RESOLVED points at
            # missing/stale metadata.
            cause = (
                "likely envelope-format divergence between the reporter "
                "and this sampler"
                if decode_failed >= len(raw) else
                "records decoded but their partitions could not be "
                "resolved (metadata missing or stale)"
            )
            LOG.error(
                "metrics sampler dropped the ENTIRE batch (%d records) "
                "from topic %r — %s; the load monitor will make no "
                "progress until this is resolved",
                len(raw), self.topic, cause,
            )
        if self.unmodeled:
            LOG.debug("metrics sampler: %d records of unmodeled type ids "
                      "so far (expected on a real cluster)", self.unmodeled)
        if self.skipped > self._warned_at:
            # surfacing matters: a topic full of undecodable records
            # otherwise looks like "no metrics" and the monitor never
            # leaves LOADING with no visible error
            LOG.warning(
                "metrics sampler has skipped %d unusable records so far "
                "(undecodable, unknown type, or unresolvable partition)",
                self.skipped,
            )
            self._warned_at = self.skipped * 2
        ready = [r for r in records if r.time_ms < end_ms]
        self._pending = [r for r in records if r.time_ms >= end_ms]
        return self.processor.process(ready)

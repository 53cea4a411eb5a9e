"""Upstream-compatible binary metrics envelope (VERDICT round-2 item #4).

A real cluster runs the *Java* broker plugin
(``cruise-control-metrics-reporter``), which writes a versioned binary
record per metric to ``__CruiseControlMetrics``; a sampler that can only
read a private JSON row format cannot consume that topic.  This module
implements the upstream byte layout so the consumer-side sampler decodes a
real reporter's records, and the in-process reporter twin produces records
a real Cruise Control could read back.

PROVENANCE FLAG: the byte layout and type ids below derive from knowledge
of upstream ``cruise-control-metrics-reporter/.../metric/*.java``
(``MetricSerde``, ``CruiseControlMetric``/``BrokerMetric``/``TopicMetric``/
``PartitionMetric``, ``RawMetricType``) — the reference mount at
``/root/reference/`` is empty, so this MUST be diffed against the fork's
actual serde the moment the mount is populated.  Golden-byte fixtures in
``tests/test_envelope.py`` pin the layout against accidental drift.

Layout (all big-endian, as Java ``ByteBuffer`` defaults):

=========== =================================================================
class       bytes
=========== =================================================================
BROKER (0)  class_id u8 | version u8 | type_id u8 | time i64 | broker i32
            | value f64
TOPIC (1)   class_id u8 | version u8 | type_id u8 | time i64 | broker i32
            | topic_len i32 | topic utf8 | value f64
PARTITION   class_id u8 | version u8 | type_id u8 | time i64 | broker i32
(2)         | topic_len i32 | topic utf8 | partition i32 | value f64
=========== =================================================================

Type ids 0–5 are the upstream load-model set; ids ≥ 100 are PRIVATE
extensions of this framework's reporter twin (partition-level bytes rates,
which upstream derives from topic-level metrics instead) — a real Cruise
Control ignores unknown ids the same way :func:`decode_record` preserves
them for the caller to skip.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Dict, Optional

from cruise_control_tpu_torch.monitor.sampling import RawMetricType


class MetricClassId(enum.IntEnum):
    """Upstream ``MetricClassId``: the record's addressing scope."""

    BROKER = 0
    TOPIC = 1
    PARTITION = 2


VERSION = 0

#: upstream RawMetricType ids (load-model subset) — see provenance flag
UPSTREAM_TYPE_IDS: Dict[RawMetricType, int] = {
    RawMetricType.ALL_TOPIC_BYTES_IN: 0,
    RawMetricType.ALL_TOPIC_BYTES_OUT: 1,
    # TOPIC_BYTES_IN / TOPIC_BYTES_OUT (topic-scope, ids 2 / 3) have no
    # one-to-one member in the abridged RawMetricType: the sampler
    # DISTRIBUTES them over the topic's leader partitions instead
    RawMetricType.PARTITION_SIZE: 4,
    RawMetricType.BROKER_CPU_UTIL: 5,
    # private extension ids (never produced by the Java plugin):
    RawMetricType.PARTITION_BYTES_IN: 100,
    RawMetricType.PARTITION_BYTES_OUT: 101,
}
TYPE_FOR_ID: Dict[int, RawMetricType] = {
    v: k for k, v in UPSTREAM_TYPE_IDS.items()
}
TOPIC_BYTES_IN_ID = 2
TOPIC_BYTES_OUT_ID = 3

#: scope per type id, for encoding (topic-scope ids handled explicitly)
_CLASS_FOR_TYPE: Dict[RawMetricType, MetricClassId] = {
    RawMetricType.ALL_TOPIC_BYTES_IN: MetricClassId.BROKER,
    RawMetricType.ALL_TOPIC_BYTES_OUT: MetricClassId.BROKER,
    RawMetricType.BROKER_CPU_UTIL: MetricClassId.BROKER,
    RawMetricType.PARTITION_SIZE: MetricClassId.PARTITION,
    RawMetricType.PARTITION_BYTES_IN: MetricClassId.PARTITION,
    RawMetricType.PARTITION_BYTES_OUT: MetricClassId.PARTITION,
}


class EnvelopeError(ValueError):
    """Malformed envelope bytes."""


@dataclasses.dataclass(frozen=True)
class EnvelopeRecord:
    """One decoded wire record, upstream-shaped: partitions are addressed
    as (topic name, partition NUMBER) — never this framework's dense ids."""

    metric_class: MetricClassId
    type_id: int
    time_ms: int
    broker_id: int
    value: float
    topic: Optional[str] = None
    partition: Optional[int] = None

    @property
    def metric_type(self) -> Optional[RawMetricType]:
        """The framework's type, None for ids we don't model."""
        return TYPE_FOR_ID.get(self.type_id)


_HEAD = struct.Struct(">BBBqi")          # class, version, type, time, broker
_I32 = struct.Struct(">i")
_F64 = struct.Struct(">d")


def encode_record(rec: EnvelopeRecord) -> bytes:
    out = bytearray(
        _HEAD.pack(rec.metric_class, VERSION, rec.type_id, rec.time_ms,
                   rec.broker_id)
    )
    if rec.metric_class in (MetricClassId.TOPIC, MetricClassId.PARTITION):
        topic = (rec.topic or "").encode()
        out += _I32.pack(len(topic)) + topic
    if rec.metric_class == MetricClassId.PARTITION:
        out += _I32.pack(rec.partition if rec.partition is not None else -1)
    out += _F64.pack(rec.value)
    return bytes(out)


def decode_record(raw: bytes) -> EnvelopeRecord:
    try:
        cls, version, type_id, time_ms, broker = _HEAD.unpack_from(raw, 0)
        if version > VERSION:
            raise EnvelopeError(
                f"envelope version {version} is newer than supported "
                f"{VERSION}"
            )
        cls = MetricClassId(cls)
        pos = _HEAD.size
        topic = None
        partition = None
        if cls in (MetricClassId.TOPIC, MetricClassId.PARTITION):
            (tlen,) = _I32.unpack_from(raw, pos)
            pos += _I32.size
            topic = raw[pos:pos + tlen].decode()
            if len(topic.encode()) != tlen:
                raise EnvelopeError("truncated topic name")
            pos += tlen
        if cls == MetricClassId.PARTITION:
            (partition,) = _I32.unpack_from(raw, pos)
            pos += _I32.size
        (value,) = _F64.unpack_from(raw, pos)
        pos += _F64.size
        if pos != len(raw):
            raise EnvelopeError(
                f"{len(raw) - pos} trailing bytes after record"
            )
    except (struct.error, UnicodeDecodeError, ValueError) as e:
        if isinstance(e, EnvelopeError):
            raise
        raise EnvelopeError(f"malformed envelope record: {e!r}") from e
    return EnvelopeRecord(cls, type_id, time_ms, broker, value, topic,
                          partition)


def is_envelope(raw: bytes) -> bool:
    """Cheap discriminator: binary records open with a valid class id; the
    JSON debug rows always open with ``[`` (0x5B).  Deliberately does NOT
    check the version byte — a newer-than-supported envelope must reach
    :func:`decode_record` and raise its explicit version error, not be
    silently misrouted to the JSON decoder."""
    return len(raw) >= _HEAD.size + _F64.size and raw[0] in (0, 1, 2)

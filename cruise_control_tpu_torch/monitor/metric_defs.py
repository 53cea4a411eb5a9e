"""Metric definitions (upstream ``cruise-control-core``
``metricdef/MetricDef.java`` / ``MetricInfo.java`` and the raw metric types of
the metrics reporter (``metricsreporter/metric/RawMetricType.java``);
SURVEY.md §2.1–2.2).

A MetricDef is a registry mapping metric ids → (name, aggregation function,
group).  The TPU twist: metric ids double as indices into the trailing axis
of sample tensors, so "aggregate by def" is a vectorized reduce with a
per-metric combine function, not a per-object dispatch.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np


class AggregationFunction(enum.Enum):
    AVG = "AVG"
    MAX = "MAX"
    LATEST = "LATEST"


@dataclasses.dataclass(frozen=True)
class MetricInfo:
    name: str
    metric_id: int
    aggregation: AggregationFunction
    group: Optional[str] = None


class MetricDef:
    """Registry of metric definitions; immutable after freeze()."""

    def __init__(self) -> None:
        self._by_name: Dict[str, MetricInfo] = {}
        self._frozen = False

    def define(
        self,
        name: str,
        aggregation: AggregationFunction,
        group: Optional[str] = None,
    ) -> MetricInfo:
        if self._frozen:
            raise RuntimeError("MetricDef is frozen")
        if name in self._by_name:
            raise ValueError(f"duplicate metric {name}")
        info = MetricInfo(name, len(self._by_name), aggregation, group)
        self._by_name[name] = info
        return info

    def freeze(self) -> "MetricDef":
        self._frozen = True
        return self

    def metric_info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def info_by_id(self, metric_id: int) -> MetricInfo:
        return self.all_metrics()[metric_id]

    def all_metrics(self) -> List[MetricInfo]:
        return sorted(self._by_name.values(), key=lambda m: m.metric_id)

    @property
    def num_metrics(self) -> int:
        return len(self._by_name)

    def aggregation_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(is_avg[M], is_max[M]) masks for vectorized window aggregation;
        LATEST is neither."""
        infos = self.all_metrics()
        is_avg = np.array(
            [m.aggregation == AggregationFunction.AVG for m in infos]
        )
        is_max = np.array(
            [m.aggregation == AggregationFunction.MAX for m in infos]
        )
        return is_avg, is_max


def partition_metric_def() -> MetricDef:
    """The per-partition metric vocabulary (upstream KafkaMetricDef
    commonMetricDef: CPU_USAGE, DISK_USAGE, LEADER_BYTES_IN, LEADER_BYTES_OUT,
    PRODUCE_RATE, FETCH_RATE, MESSAGES_IN_RATE, REPLICATION_BYTES_IN/OUT)."""
    d = MetricDef()
    d.define("CPU_USAGE", AggregationFunction.AVG, "CPU")
    d.define("DISK_USAGE", AggregationFunction.LATEST, "DISK")
    d.define("LEADER_BYTES_IN", AggregationFunction.AVG, "NW_IN")
    d.define("LEADER_BYTES_OUT", AggregationFunction.AVG, "NW_OUT")
    d.define("PRODUCE_RATE", AggregationFunction.AVG)
    d.define("FETCH_RATE", AggregationFunction.AVG)
    d.define("MESSAGES_IN_RATE", AggregationFunction.AVG)
    d.define("REPLICATION_BYTES_IN_RATE", AggregationFunction.AVG)
    d.define("REPLICATION_BYTES_OUT_RATE", AggregationFunction.AVG)
    return d.freeze()


def broker_metric_def() -> MetricDef:
    """Per-broker metrics (upstream BrokerMetricSample vocabulary, abridged to
    the load-model-relevant set)."""
    d = MetricDef()
    d.define("BROKER_CPU_UTIL", AggregationFunction.AVG, "CPU")
    d.define("ALL_TOPIC_BYTES_IN", AggregationFunction.AVG, "NW_IN")
    d.define("ALL_TOPIC_BYTES_OUT", AggregationFunction.AVG, "NW_OUT")
    d.define("REPLICATION_BYTES_IN_RATE", AggregationFunction.AVG)
    d.define("REPLICATION_BYTES_OUT_RATE", AggregationFunction.AVG)
    d.define("BROKER_PRODUCE_REQUEST_RATE", AggregationFunction.AVG)
    d.define("BROKER_CONSUMER_FETCH_REQUEST_RATE", AggregationFunction.AVG)
    d.define("BROKER_FOLLOWER_FETCH_REQUEST_RATE", AggregationFunction.AVG)
    d.define("BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT", AggregationFunction.AVG)
    d.define("BROKER_DISK_UTIL", AggregationFunction.LATEST, "DISK")
    return d.freeze()

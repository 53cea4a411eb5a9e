"""Prometheus metric sampler (upstream
``monitor/sampling/prometheus/PrometheusMetricSampler.java``; SURVEY.md §2.3).

Scrapes a Prometheus endpoint's text exposition format and maps configured
metric names to the raw reporter vocabulary, then runs the standard
MetricsProcessor so CPU attribution and sample shapes match the reporter
path exactly.  The HTTP transport is a pluggable ``http_get(url) -> str``
callable — the build environment has no network, so production would inject
``urllib``; tests inject a fake returning canned exposition text.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.monitor.sampling import (
    CruiseControlMetric,
    MetricSampler,
    MetricsProcessor,
    RawMetricType,
)

#: default metric-name mapping (kafka_server exporter conventions)
DEFAULT_QUERIES: Dict[RawMetricType, str] = {
    RawMetricType.BROKER_CPU_UTIL: "kafka_server_broker_cpu_util",
    RawMetricType.ALL_TOPIC_BYTES_IN: "kafka_server_brokertopicmetrics_bytesin_total",
    RawMetricType.ALL_TOPIC_BYTES_OUT: "kafka_server_brokertopicmetrics_bytesout_total",
    RawMetricType.PARTITION_SIZE: "kafka_log_log_size",
    RawMetricType.PARTITION_BYTES_IN: "kafka_partition_bytesin_rate",
    RawMetricType.PARTITION_BYTES_OUT: "kafka_partition_bytesout_rate",
}

_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+"
    r"(?P<value>[-+0-9.eEnaifNI]+)"
    r"(?:\s+(?P<ts>\d+))?\s*$"
)
_LABEL = re.compile(r'(\w+)="([^"]*)"')


def parse_exposition(text: str) -> List[Tuple[str, Dict[str, str], float, Optional[int]]]:
    """Text exposition → (name, labels, value, timestamp_ms) tuples."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        labels = dict(_LABEL.findall(m.group("labels") or ""))
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        ts = int(m.group("ts")) if m.group("ts") else None
        out.append((m.group("name"), labels, value, ts))
    return out


class PrometheusMetricSampler(MetricSampler):
    def __init__(
        self,
        http_get: Callable[[str], str],
        endpoint: str = "http://localhost:9090/metrics",
        queries: Optional[Dict[RawMetricType, str]] = None,
        broker_label: str = "broker",
        partition_label: str = "partition",
        processor: Optional[MetricsProcessor] = None,
    ):
        self.http_get = http_get
        self.endpoint = endpoint
        self.queries = queries or dict(DEFAULT_QUERIES)
        self._by_name = {name: t for t, name in self.queries.items()}
        self.broker_label = broker_label
        self.partition_label = partition_label
        self.processor = processor or MetricsProcessor()

    def get_samples(self, start_ms: int, end_ms: int):
        text = self.http_get(self.endpoint)
        records: List[CruiseControlMetric] = []
        for name, labels, value, ts in parse_exposition(text):
            mtype = self._by_name.get(name)
            if mtype is None or self.broker_label not in labels:
                continue
            time_ms = ts if ts is not None else end_ms - 1
            if not (start_ms <= time_ms < end_ms):
                continue
            partition = int(labels.get(self.partition_label, -1))
            records.append(
                CruiseControlMetric(
                    mtype, time_ms, int(labels[self.broker_label]), value,
                    partition,
                )
            )
        return self.processor.process(records)

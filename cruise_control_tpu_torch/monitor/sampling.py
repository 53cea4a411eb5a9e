"""Metric sampling pipeline: raw broker metrics → typed samples.

Covers three upstream pieces (SURVEY.md §2.2–2.3, call stack §3.3):

* the broker-side metrics reporter plugin
  (``metricsreporter/CruiseControlMetricsReporter.java``) — here a
  :class:`SimulatedMetricsReporter` that computes each broker's observable
  metrics from a ground-truth workload and produces them to an in-memory
  :class:`MetricsTopic` (the ``__CruiseControlMetrics`` stand-in; the build
  environment has no Kafka);
* the sample processor (``monitor/sampling/CruiseControlMetricsProcessor.java``
  + ``model/ModelUtils.java``) — converts raw metrics into
  ``PartitionMetricSample`` / ``BrokerMetricSample``, **estimating
  per-partition CPU** from broker CPU × traffic shares (linear model);
* the ``MetricSampler`` SPI (``monitor/sampling/MetricSampler.java``) with the
  reporter-consuming implementation
  (``CruiseControlMetricsReporterSampler.java``).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from cruise_control_tpu_torch.monitor.metric_defs import (
    broker_metric_def,
    partition_metric_def,
)

PARTITION_DEF = partition_metric_def()
BROKER_DEF = broker_metric_def()

# column indices into sample value vectors
P_CPU = PARTITION_DEF.metric_info("CPU_USAGE").metric_id
P_DISK = PARTITION_DEF.metric_info("DISK_USAGE").metric_id
P_NW_IN = PARTITION_DEF.metric_info("LEADER_BYTES_IN").metric_id
P_NW_OUT = PARTITION_DEF.metric_info("LEADER_BYTES_OUT").metric_id
B_CPU = BROKER_DEF.metric_info("BROKER_CPU_UTIL").metric_id
B_BYTES_IN = BROKER_DEF.metric_info("ALL_TOPIC_BYTES_IN").metric_id
B_BYTES_OUT = BROKER_DEF.metric_info("ALL_TOPIC_BYTES_OUT").metric_id
B_DISK = BROKER_DEF.metric_info("BROKER_DISK_UTIL").metric_id


class RawMetricType(enum.Enum):
    """Raw reporter vocabulary (upstream ``RawMetricType.java``, abridged to
    the load-model-relevant set)."""

    BROKER_CPU_UTIL = "BROKER_CPU_UTIL"
    ALL_TOPIC_BYTES_IN = "ALL_TOPIC_BYTES_IN"
    ALL_TOPIC_BYTES_OUT = "ALL_TOPIC_BYTES_OUT"
    PARTITION_SIZE = "PARTITION_SIZE"
    PARTITION_BYTES_IN = "PARTITION_BYTES_IN"
    PARTITION_BYTES_OUT = "PARTITION_BYTES_OUT"


@dataclasses.dataclass(frozen=True)
class CruiseControlMetric:
    """One raw metric record (upstream ``CruiseControlMetric`` hierarchy;
    ``partition`` is -1 for broker-scoped metrics)."""

    metric_type: RawMetricType
    time_ms: int
    broker_id: int
    value: float
    partition: int = -1


class MetricsTopic:
    """In-memory ``__CruiseControlMetrics``: append-only log with offset-based
    consumption so multiple samplers can tail it independently.

    Like its real-Kafka namesake the log has **retention**: only the newest
    ``max_records`` records are kept (a 1000-broker reporter produces ~15k
    records per interval — an unbounded log is a multi-GB leak over a
    simulated day, the exact failure mode the long-horizon soak gates on).
    Offsets are absolute and survive trimming; a consumer that fell behind
    retention simply resumes from the oldest retained record, exactly like
    a Kafka consumer whose offset aged out.
    """

    def __init__(self, name: str = "__CruiseControlMetrics",
                 max_records: Optional[int] = 1_000_000) -> None:
        self.name = name
        self.max_records = max_records
        self._records: List[CruiseControlMetric] = []
        #: absolute offset of ``_records[0]`` (> 0 once retention trimmed)
        self._base = 0

    def produce(self, records: Iterable[CruiseControlMetric]) -> None:
        self._records.extend(records)
        if self.max_records is not None \
                and len(self._records) > self.max_records:
            drop = len(self._records) - self.max_records
            del self._records[:drop]
            self._base += drop

    def consume_from(self, offset: int) -> Tuple[List[CruiseControlMetric], int]:
        start = max(int(offset) - self._base, 0)
        records = self._records[start:]
        return records, self._base + len(self._records)

    def __len__(self) -> int:
        return self._base + len(self._records)


# ---------------------------------------------------------------------------------
# Simulated broker-side reporter
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class WorkloadModel:
    """Ground truth the simulated brokers observe: per-partition rates plus
    topology.  Arrays are float64 [P]."""

    bytes_in: np.ndarray      # leader produce rate (KB/s)
    bytes_out: np.ndarray     # leader consume rate (KB/s)
    size_mb: np.ndarray       # on-disk size per replica (MB)
    assignment: Dict[int, List[int]]   # partition → replica brokers
    leaders: Dict[int, int]            # partition → leader broker
    #: linear CPU cost coefficients (percent CPU per KB/s)
    cpu_per_bytes_in: float = 0.005
    cpu_per_bytes_out: float = 0.003
    cpu_per_replication_in: float = 0.002
    base_cpu: float = 2.0

    def broker_ids(self) -> List[int]:
        out = set(self.leaders.values())
        for reps in self.assignment.values():
            out.update(reps)
        return sorted(out)


class SimulatedMetricsReporter:
    """Computes what each broker's metrics reporter would see from the
    ground-truth workload and produces raw records to the metrics topic.
    One call to :meth:`report` = one reporting interval on every broker."""

    def __init__(
        self,
        workload: WorkloadModel,
        topic: MetricsTopic,
        noise_std: float = 0.0,
        seed: int = 0,
    ):
        self.workload = workload
        self.topic = topic
        self.noise_std = noise_std
        self._rng = np.random.default_rng(seed)

    def _noisy(self, v: float) -> float:
        if self.noise_std <= 0:
            return max(v, 0.0)
        return max(v * (1.0 + self._rng.normal(0.0, self.noise_std)), 0.0)

    def report(self, time_ms: int) -> None:
        w = self.workload
        records: List[CruiseControlMetric] = []
        leader_in: Dict[int, float] = {}
        leader_out: Dict[int, float] = {}
        repl_in: Dict[int, float] = {}
        for p, leader in w.leaders.items():
            leader_in[leader] = leader_in.get(leader, 0.0) + float(w.bytes_in[p])
            leader_out[leader] = leader_out.get(leader, 0.0) + float(w.bytes_out[p])
            for b in w.assignment[p]:
                if b != leader:
                    repl_in[b] = repl_in.get(b, 0.0) + float(w.bytes_in[p])
            # leader-side per-partition metrics
            records.append(CruiseControlMetric(
                RawMetricType.PARTITION_BYTES_IN, time_ms, leader,
                self._noisy(float(w.bytes_in[p])), p))
            records.append(CruiseControlMetric(
                RawMetricType.PARTITION_BYTES_OUT, time_ms, leader,
                self._noisy(float(w.bytes_out[p])), p))
            records.append(CruiseControlMetric(
                RawMetricType.PARTITION_SIZE, time_ms, leader,
                self._noisy(float(w.size_mb[p])), p))
        for b in w.broker_ids():
            lin = leader_in.get(b, 0.0)
            lout = leader_out.get(b, 0.0)
            rin = repl_in.get(b, 0.0)
            cpu = (w.base_cpu + w.cpu_per_bytes_in * lin
                   + w.cpu_per_bytes_out * lout
                   + w.cpu_per_replication_in * rin)
            records.append(CruiseControlMetric(
                RawMetricType.BROKER_CPU_UTIL, time_ms, b, self._noisy(cpu)))
            records.append(CruiseControlMetric(
                RawMetricType.ALL_TOPIC_BYTES_IN, time_ms, b,
                self._noisy(lin + rin)))
            records.append(CruiseControlMetric(
                RawMetricType.ALL_TOPIC_BYTES_OUT, time_ms, b,
                self._noisy(lout)))
        self.topic.produce(records)


# ---------------------------------------------------------------------------------
# Samples + processor
# ---------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionMetricSample:
    partition: int
    time_ms: int
    values: Tuple[float, ...]  # indexed by PARTITION_DEF metric ids


@dataclasses.dataclass(frozen=True)
class BrokerMetricSample:
    broker_id: int
    time_ms: int
    values: Tuple[float, ...]  # indexed by BROKER_DEF metric ids


@dataclasses.dataclass
class ModelParameters:
    """Coefficients of the partition-CPU linear model (upstream
    ``ModelParameters``): a leader partition's CPU share of its broker is
    split between its bytes-in and bytes-out shares."""

    cpu_weight_bytes_in: float = 0.6
    cpu_weight_bytes_out: float = 0.4


class LinearRegressionModelParameters:
    """Trainable CPU model (upstream ``LinearRegressionModelParameters``,
    driven by the TRAIN endpoint): least-squares fit of broker CPU against
    broker bytes-in/bytes-out over the aggregated windows, normalized into
    the attribution weights the processor uses."""

    @staticmethod
    def fit(broker_values: "np.ndarray") -> Optional[ModelParameters]:
        """``broker_values``: f32 [B, W, M] aggregated broker windows.
        Returns fitted params, or None when the history can't support a fit
        (fewer than two windows or four positive samples)."""
        if broker_values.size == 0 or broker_values.shape[1] < 2:
            return None
        x = broker_values[:, :, [B_BYTES_IN, B_BYTES_OUT]].reshape(-1, 2)
        y = broker_values[:, :, B_CPU].reshape(-1)
        mask = (x.sum(axis=1) > 0) & (y > 0)
        if mask.sum() < 4:
            return None
        w, *_ = np.linalg.lstsq(x[mask], y[mask], rcond=None)
        w = np.maximum(w, 0.0)
        total = float(w.sum()) or 1.0
        return ModelParameters(
            cpu_weight_bytes_in=float(w[0] / total),
            cpu_weight_bytes_out=float(w[1] / total),
        )


class MetricsProcessor:
    """Raw records for one sampling interval → typed samples (upstream
    ``CruiseControlMetricsProcessor.process``)."""

    def __init__(self, params: Optional[ModelParameters] = None):
        self.params = params or ModelParameters()

    def process(
        self, records: Sequence[CruiseControlMetric]
    ) -> Tuple[List[PartitionMetricSample], List[BrokerMetricSample]]:
        by_broker: Dict[int, Dict[RawMetricType, float]] = {}
        part_raw: Dict[int, Dict[RawMetricType, float]] = {}
        part_broker: Dict[int, int] = {}
        times: Dict[int, int] = {}
        for r in records:
            if r.partition >= 0:
                part_raw.setdefault(r.partition, {})[r.metric_type] = r.value
                part_broker[r.partition] = r.broker_id
                times[r.partition] = max(times.get(r.partition, 0), r.time_ms)
            else:
                by_broker.setdefault(r.broker_id, {})[r.metric_type] = r.value

        # broker totals of leader traffic, for CPU attribution shares
        tot_in: Dict[int, float] = {}
        tot_out: Dict[int, float] = {}
        for p, m in part_raw.items():
            b = part_broker[p]
            tot_in[b] = tot_in.get(b, 0.0) + m.get(RawMetricType.PARTITION_BYTES_IN, 0.0)
            tot_out[b] = tot_out.get(b, 0.0) + m.get(RawMetricType.PARTITION_BYTES_OUT, 0.0)

        psamples: List[PartitionMetricSample] = []
        for p, m in sorted(part_raw.items()):
            b = part_broker[p]
            bm = by_broker.get(b, {})
            bytes_in = m.get(RawMetricType.PARTITION_BYTES_IN, 0.0)
            bytes_out = m.get(RawMetricType.PARTITION_BYTES_OUT, 0.0)
            cpu = estimate_partition_cpu(
                broker_cpu=bm.get(RawMetricType.BROKER_CPU_UTIL, 0.0),
                bytes_in=bytes_in, bytes_out=bytes_out,
                broker_bytes_in=tot_in.get(b, 0.0),
                broker_bytes_out=tot_out.get(b, 0.0),
                params=self.params,
            )
            values = [0.0] * PARTITION_DEF.num_metrics
            values[P_CPU] = cpu
            values[P_DISK] = m.get(RawMetricType.PARTITION_SIZE, 0.0)
            values[P_NW_IN] = bytes_in
            values[P_NW_OUT] = bytes_out
            psamples.append(
                PartitionMetricSample(p, times.get(p, 0), tuple(values))
            )

        bsamples: List[BrokerMetricSample] = []
        bt = max((r.time_ms for r in records), default=0)
        for b, m in sorted(by_broker.items()):
            values = [0.0] * BROKER_DEF.num_metrics
            values[B_CPU] = m.get(RawMetricType.BROKER_CPU_UTIL, 0.0)
            values[B_BYTES_IN] = m.get(RawMetricType.ALL_TOPIC_BYTES_IN, 0.0)
            values[B_BYTES_OUT] = m.get(RawMetricType.ALL_TOPIC_BYTES_OUT, 0.0)
            values[B_DISK] = sum(
                pm.get(RawMetricType.PARTITION_SIZE, 0.0)
                for p, pm in part_raw.items() if part_broker[p] == b
            )
            bsamples.append(BrokerMetricSample(b, bt, tuple(values)))
        return psamples, bsamples


def estimate_partition_cpu(
    broker_cpu: float,
    bytes_in: float,
    bytes_out: float,
    broker_bytes_in: float,
    broker_bytes_out: float,
    params: ModelParameters,
) -> float:
    """Leader-partition CPU estimate (upstream ``ModelUtils``): the broker's
    CPU is attributed to partitions by a weighted mix of their bytes-in and
    bytes-out shares."""
    share = 0.0
    if broker_bytes_in > 0:
        share += params.cpu_weight_bytes_in * (bytes_in / broker_bytes_in)
    if broker_bytes_out > 0:
        share += params.cpu_weight_bytes_out * (bytes_out / broker_bytes_out)
    return broker_cpu * share


# ---------------------------------------------------------------------------------
# Sample validation / quarantine (ISSUE 13: the data-integrity front door)
# ---------------------------------------------------------------------------------

#: the closed reject-reason vocabulary (journal payloads, metric labels)
VALIDATION_REASONS = (
    "non-finite", "negative", "unknown-broker", "unknown-partition",
    "stale", "spike",
)

#: static meter names per reason (obs-dynamic-name: no runtime formatting)
_REASON_METERS = {
    r: "monitor.sample.quarantined." + r for r in VALIDATION_REASONS
}


@dataclasses.dataclass
class SampleValidationConfig:
    """The ``monitor.sample.validation.*`` key surface (upstream
    ``CruiseControlMetricsProcessor`` sanity checks, SURVEY §2.2)."""

    enabled: bool = True
    #: >1 arms the absurd-spike rate limit on BROKER samples: a metric
    #: more than ``spike_factor``× the broker's last accepted value is
    #: quarantined (partition samples are not spike-checked — per-entity
    #: last-value state at the 1M-partition scale is not worth one bad
    #: sample's damage, which the finiteness checks already bound)
    spike_factor: float = 0.0
    #: >0 quarantines samples timestamped more than this many ms before
    #: the poll's ``now_ms`` (a wedged reporter replaying ancient data)
    max_age_ms: int = 0
    # quarantine-storm detection: a broker whose samples are
    # PERSISTENTLY bad is itself an anomaly (surfaced through the
    # metric-anomaly detector as an alert-only finding)
    storm_ratio: float = 0.5
    storm_min_samples: int = 4
    storm_window_batches: int = 8


@dataclasses.dataclass
class ValidationBatchReport:
    """What one ingest batch quarantined (the journal-event payload)."""

    accepted: int = 0
    quarantined: int = 0
    reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    brokers: List[int] = dataclasses.field(default_factory=list)
    partitions: List[int] = dataclasses.field(default_factory=list)


class SampleValidator:
    """Validation stage between the sampler and the aggregator.

    Clean samples pass through **bit-identically** (the exact input list
    objects, untouched) — the stage must not perturb a single pinned
    scenario or soak fingerprint.  Rejects are routed to a per-broker
    quarantine ledger that feeds ``monitor.sample_quarantined`` journal
    events (emitted by the LoadMonitor), ``cc_monitor_quarantined_total
    {reason=}`` metric rows, the ``monitor.sample.quarantine.ratio`` SLO
    (via the ``monitor.sample.accepted``/``.quarantined`` meters), and
    the quarantine-storm findings the metric-anomaly detector surfaces.

    Thread-safe: the ledger lock covers every mutable attribute (ingest
    runs on the fetcher thread, storm findings are read on the detector
    scheduler thread).
    """

    def __init__(self, config: Optional[SampleValidationConfig] = None,
                 registry=None):
        self.config = config or SampleValidationConfig()
        #: metric registry for the accepted/quarantined meters; None
        #: defers to the process default at first use
        if registry is None:
            from cruise_control_tpu_torch.utils.metrics import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        self.registry = registry
        self._lock = threading.Lock()
        #: lifetime reason → count (the labeled-metric rows)
        self._reason_totals: Dict[str, int] = {}
        self.total_accepted = 0
        self.total_quarantined = 0
        #: broker → last ACCEPTED value vector (spike baseline)
        self._last_broker_values: Dict[int, np.ndarray] = {}
        #: broker → deque[(accepted, quarantined)] per batch — tracked
        #: only once a broker misbehaves, so a clean fleet costs nothing
        self._storm: Dict[int, deque] = {}

    # ---- the validation pass ----------------------------------------------------
    def validate(
        self,
        psamples: List["PartitionMetricSample"],
        bsamples: List["BrokerMetricSample"],
        known_brokers: Set[int],
        known_partitions: Set[int],
        now_ms: int,
    ) -> Tuple[List["PartitionMetricSample"], List["BrokerMetricSample"],
               Optional[ValidationBatchReport]]:
        """``(clean_p, clean_b, report)``; report is None when nothing
        was quarantined (the bit-identical clean path)."""
        cfg = self.config
        if not cfg.enabled:
            return psamples, bsamples, None
        report = ValidationBatchReport()
        bad_p: Dict[int, str] = {}   # sample index → reason
        bad_b: Dict[int, str] = {}
        #: per-broker (accepted, quarantined) for storm accounting —
        #: broker-attributed samples only (partition samples carry no
        #: broker id once processed)
        ok_by_broker: Dict[int, int] = {}
        bad_by_broker: Dict[int, int] = {}

        if psamples:
            vals = np.asarray([s.values for s in psamples], np.float64)
            ids = np.fromiter((s.partition for s in psamples), np.int64,
                              len(psamples))
            finite = np.isfinite(vals).all(axis=1)
            neg = ~(vals >= 0).all(axis=1) & finite
            known = np.isin(
                ids, np.fromiter(known_partitions, np.int64,
                                 len(known_partitions))
            ) if known_partitions else np.zeros(len(psamples), bool)
            bad_mask = ~finite | neg | ~known
            if cfg.max_age_ms > 0:
                ts = np.fromiter((s.time_ms for s in psamples), np.int64,
                                 len(psamples))
                stale = (now_ms - ts) > cfg.max_age_ms
                bad_mask |= stale
            else:
                stale = None
            for i in np.nonzero(bad_mask)[0]:
                i = int(i)
                if not finite[i]:
                    bad_p[i] = "non-finite"
                elif neg[i]:
                    bad_p[i] = "negative"
                elif not known[i]:
                    bad_p[i] = "unknown-partition"
                else:
                    bad_p[i] = "stale"

        for i, s in enumerate(bsamples):
            v = np.asarray(s.values, np.float64)
            if not np.isfinite(v).all():
                bad_b[i] = "non-finite"
            elif (v < 0).any():
                bad_b[i] = "negative"
            elif s.broker_id not in known_brokers:
                bad_b[i] = "unknown-broker"
            elif cfg.max_age_ms > 0 and now_ms - s.time_ms > cfg.max_age_ms:
                bad_b[i] = "stale"
            elif cfg.spike_factor > 1.0:
                prev = self._last_broker_values.get(s.broker_id)
                if prev is not None and bool(
                    np.any((prev > 0) & (v > cfg.spike_factor * prev))
                ):
                    bad_b[i] = "spike"
            if i in bad_b:
                bad_by_broker[s.broker_id] = \
                    bad_by_broker.get(s.broker_id, 0) + 1
            else:
                ok_by_broker[s.broker_id] = \
                    ok_by_broker.get(s.broker_id, 0) + 1

        n_bad = len(bad_p) + len(bad_b)
        n_ok = len(psamples) + len(bsamples) - n_bad
        with self._lock:
            # spike baselines advance on ACCEPTED samples only — a spike
            # must not become the next interval's normal
            if cfg.spike_factor > 1.0:
                for i, s in enumerate(bsamples):
                    if i not in bad_b:
                        self._last_broker_values[s.broker_id] = np.asarray(
                            s.values, np.float64
                        )
            self.total_accepted += n_ok
            self.total_quarantined += n_bad
            for reason in list(bad_p.values()) + list(bad_b.values()):
                self._reason_totals[reason] = \
                    self._reason_totals.get(reason, 0) + 1
            # storm window: start tracking a broker at its first reject;
            # every tracked broker gets one (ok, bad) point per batch so
            # the window drains once the broker behaves (or goes silent)
            for b in bad_by_broker:
                if b not in self._storm:
                    self._storm[b] = deque(
                        maxlen=max(1, int(cfg.storm_window_batches))
                    )
            for b, window in self._storm.items():
                window.append(
                    (ok_by_broker.get(b, 0), bad_by_broker.get(b, 0))
                )
        if self.registry is not None:
            self.registry.meter("monitor.sample.accepted").mark(n_ok)
            if n_bad:
                self.registry.meter("monitor.sample.quarantined").mark(n_bad)
                for reason, meter in _REASON_METERS.items():
                    n = sum(1 for r in bad_p.values() if r == reason) \
                        + sum(1 for r in bad_b.values() if r == reason)
                    if n:
                        self.registry.meter(meter).mark(n)
        if not n_bad:
            # THE clean-path contract: the exact input lists, untouched
            return psamples, bsamples, None
        report.accepted = n_ok
        report.quarantined = n_bad
        reasons: Dict[str, int] = {}
        for reason in list(bad_p.values()) + list(bad_b.values()):
            reasons[reason] = reasons.get(reason, 0) + 1
        report.reasons = {k: reasons[k] for k in sorted(reasons)}
        report.brokers = sorted(
            {bsamples[i].broker_id for i in bad_b}
        )[:16]
        report.partitions = sorted(
            {psamples[i].partition for i in bad_p}
        )[:16]
        clean_p = [s for i, s in enumerate(psamples) if i not in bad_p]
        clean_b = [s for i, s in enumerate(bsamples) if i not in bad_b]
        return clean_p, clean_b, report

    # ---- readers ----------------------------------------------------------------
    def reason_totals(self) -> Dict[str, int]:
        """Lifetime reject counts by reason (the
        ``cc_monitor_quarantined_total{reason=}`` rows)."""
        with self._lock:
            return dict(self._reason_totals)

    def storm_findings(self) -> List[Tuple[int, float, float]]:
        """``(broker, ratio, threshold)`` for brokers whose quarantine
        ratio over the rolling batch window crossed the storm threshold
        — persistent badness, not a single blip."""
        cfg = self.config
        out: List[Tuple[int, float, float]] = []
        with self._lock:
            for b, window in sorted(self._storm.items()):
                ok = sum(w[0] for w in window)
                bad = sum(w[1] for w in window)
                total = ok + bad
                if total < max(1, int(cfg.storm_min_samples)):
                    continue
                ratio = bad / total
                if ratio >= cfg.storm_ratio:
                    out.append((int(b), float(ratio),
                                float(cfg.storm_ratio)))
        return out

    def state_summary(self) -> dict:
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "accepted": self.total_accepted,
                "quarantined": self.total_quarantined,
                "reasons": {k: self._reason_totals[k]
                            for k in sorted(self._reason_totals)},
                "stormBrokers": sorted(self._storm),
            }


# ---------------------------------------------------------------------------------
# Sampler SPI
# ---------------------------------------------------------------------------------

class MetricSampler:
    """Pluggable sample source (upstream ``MetricSampler`` SPI)."""

    def get_samples(
        self, start_ms: int, end_ms: int
    ) -> Tuple[List[PartitionMetricSample], List[BrokerMetricSample]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MetricsReporterSampler(MetricSampler):
    """Tails the metrics topic and runs the processor (upstream
    ``CruiseControlMetricsReporterSampler``)."""

    def __init__(
        self,
        topic: MetricsTopic,
        processor: Optional[MetricsProcessor] = None,
    ):
        self.topic = topic
        self.processor = processor or MetricsProcessor()
        self._offset = 0
        # records consumed but timestamped at/after a poll's end_ms — held
        # for the next poll instead of being silently dropped
        self._pending: List[CruiseControlMetric] = []

    def get_samples(self, start_ms: int, end_ms: int):
        fresh, self._offset = self.topic.consume_from(self._offset)
        records = self._pending + fresh
        ready = [r for r in records if r.time_ms < end_ms]
        self._pending = [r for r in records if r.time_ms >= end_ms]
        return self.processor.process(ready)

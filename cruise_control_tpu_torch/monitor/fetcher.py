"""Periodic metric fetching (upstream ``monitor/task/MetricFetcherManager.java``
+ ``SamplingFetcher.java`` + ``MetricSamplerPartitionAssignor.java``;
SURVEY.md §2.3, call stack §3.3).

The partition universe is split across N fetchers by a deterministic
round-robin assignor; each fetcher pulls from its own sampler instance (the
in-memory metrics topic supports independent consumer offsets the way the
real ``__CruiseControlMetrics`` topic does) and feeds the shared LoadMonitor
aggregators.  Broker-scoped samples are ingested by fetcher 0 only, so N
fetchers never double-count a broker.  The manager runs either threaded
(``start``/``stop``) or by explicit ``fetch_once`` ticks (tests,
deterministic drives).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Set

from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.sampling import MetricSampler


class MetricSamplerPartitionAssignor:
    """Deterministic round-robin split of the partition universe."""

    def assign(
        self, partitions: Sequence[int], num_fetchers: int
    ) -> List[Set[int]]:
        out: List[Set[int]] = [set() for _ in range(max(num_fetchers, 1))]
        for i, p in enumerate(sorted(partitions)):
            out[i % len(out)].add(p)
        return out


class SamplingFetcher:
    """One fetcher's pass: pull from its sampler, keep its assigned
    partitions, hand the samples to the monitor."""

    def __init__(self, sampler: MetricSampler, monitor: LoadMonitor,
                 include_broker_samples: bool):
        self.sampler = sampler
        self.monitor = monitor
        self.include_broker_samples = include_broker_samples
        self._last_ms = 0

    def fetch(self, now_ms: int, assigned: Set[int],
              ingest_lock: Optional[threading.Lock] = None) -> int:
        """Pull + filter (safe to run concurrently across fetchers — each
        owns its sampler), then ingest under ``ingest_lock`` when given (the
        monitor's aggregators are a single shared mutable sink)."""
        psamples, bsamples = self.sampler.get_samples(self._last_ms, now_ms)
        self._last_ms = now_ms
        psamples = [s for s in psamples if s.partition in assigned]
        if not self.include_broker_samples:
            bsamples = []
        if ingest_lock is None:
            return self.monitor.ingest_samples(psamples, bsamples, now_ms)
        with ingest_lock:
            return self.monitor.ingest_samples(psamples, bsamples, now_ms)


class MetricFetcherManager:
    """Owns the fetcher pool + the sampling schedule."""

    def __init__(
        self,
        monitor: LoadMonitor,
        sampler_factory: Optional[Callable[[], MetricSampler]] = None,
        num_fetchers: int = 1,
        sampling_interval_ms: int = 60_000,
        assignor: Optional[MetricSamplerPartitionAssignor] = None,
        time_fn: Callable[[], float] = time.time,
    ):
        self.monitor = monitor
        self.assignor = assignor or MetricSamplerPartitionAssignor()
        self.sampling_interval_ms = sampling_interval_ms
        self.time_fn = time_fn
        if sampler_factory is None:
            samplers = [monitor.sampler]
            num_fetchers = 1
        else:
            samplers = [sampler_factory() for _ in range(max(num_fetchers, 1))]
        self.fetchers = [
            SamplingFetcher(s, monitor, include_broker_samples=(i == 0))
            for i, s in enumerate(samplers)
        ]
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._ingest_lock = threading.Lock()
        self.fetch_count = 0

    def fetch_once(self, now_ms: Optional[int] = None) -> int:
        """One full sampling interval across all fetchers → #samples.

        Fetchers run CONCURRENTLY (the point of ``num.metric.fetchers`` > 1
        is parallel network pulls; upstream's SamplingFetchers run on an
        executor); ingestion into the shared aggregators is serialized by
        ``_ingest_lock``.  Note the topic-transport samplers (reporter-topic
        consumers) each read the whole metrics topic and keep only their
        assigned partitions — the wire seam has no per-partition consume —
        so >1 fetcher buys wall-clock overlap, not less total decode work.
        """
        now_ms = int(self.time_fn() * 1000) if now_ms is None else now_ms
        universe = sorted(self.monitor.metadata.refresh().assignment)
        assigned = self.assignor.assign(universe, len(self.fetchers))
        if len(self.fetchers) == 1:
            total = self.fetchers[0].fetch(now_ms, assigned[0])
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=len(self.fetchers)
            ) as pool:
                futures = [
                    pool.submit(f.fetch, now_ms, mine, self._ingest_lock)
                    for f, mine in zip(self.fetchers, assigned)
                ]
                total = sum(f.result() for f in futures)
        self.fetch_count += 1
        return total

    # ---- background schedule ----------------------------------------------------
    def start(self, tick_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        interval_s = (
            tick_s if tick_s is not None else self.sampling_interval_ms / 1000
        )

        def loop() -> None:
            while not self._stop.wait(interval_s):
                self.fetch_once()

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="metric-fetcher-manager", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None

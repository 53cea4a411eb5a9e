"""Sample persistence + replay (upstream ``monitor/sampling/SampleStore.java``
/ ``KafkaSampleStore.java``; SURVEY.md §5.4).

Upstream persists every sample to two retention-bounded internal Kafka topics and
replays them on startup so the workload model survives restarts.  With no
Kafka in this environment, the store is an append-only JSONL pair on local
disk with the same contract: ``store_samples`` on every fetch,
``load_samples`` replayed into the aggregators while the monitor reports
``LOADING``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.monitor.sampling import (
    BrokerMetricSample,
    PartitionMetricSample,
)


class SampleStore:
    """SPI: persist and replay metric samples."""

    def store_samples(
        self,
        partition_samples: Sequence[PartitionMetricSample],
        broker_samples: Sequence[BrokerMetricSample],
    ) -> None:
        raise NotImplementedError

    def load_samples(
        self,
    ) -> Tuple[List[PartitionMetricSample], List[BrokerMetricSample]]:
        raise NotImplementedError

    def _replay_parallel(self, loaders, threads: int) -> list:
        """Run independent replay streams concurrently
        (``num.sample.loading.threads``).  Effective parallelism is
        ``min(threads, len(loaders))`` — a store has one independent stream
        per sample kind, so two streams cap the win regardless of the
        configured count."""
        if threads > 1 and len(loaders) > 1:
            from concurrent.futures import ThreadPoolExecutor

            workers = min(threads, len(loaders))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futures = [pool.submit(fn) for fn in loaders]
                return [f.result() for f in futures]
        return [fn() for fn in loaders]

    def close(self) -> None:
        pass


class NoopSampleStore(SampleStore):
    def store_samples(self, partition_samples, broker_samples) -> None:
        pass

    def load_samples(self):
        return [], []


class FileSampleStore(SampleStore):
    """Append-only JSONL files (``partition_samples.jsonl`` /
    ``broker_samples.jsonl``) under one directory."""

    def __init__(self, path: str, loading_threads: int = 1):
        self.path = path
        #: num.sample.loading.threads — replay the two sample files on
        #: concurrent readers when > 1
        self.loading_threads = loading_threads
        os.makedirs(path, exist_ok=True)
        self._pfile = os.path.join(path, "partition_samples.jsonl")
        self._bfile = os.path.join(path, "broker_samples.jsonl")

    def store_samples(self, partition_samples, broker_samples) -> None:
        if partition_samples:
            with open(self._pfile, "a") as f:
                for s in partition_samples:
                    f.write(json.dumps(
                        [s.partition, s.time_ms, list(s.values)]) + "\n")
        if broker_samples:
            with open(self._bfile, "a") as f:
                for s in broker_samples:
                    f.write(json.dumps(
                        [s.broker_id, s.time_ms, list(s.values)]) + "\n")

    def _load_partition_samples(self) -> List[PartitionMetricSample]:
        psamples: List[PartitionMetricSample] = []
        if os.path.exists(self._pfile):
            with open(self._pfile) as f:
                for line in f:
                    p, t, v = json.loads(line)
                    psamples.append(PartitionMetricSample(p, t, tuple(v)))
        return psamples

    def _load_broker_samples(self) -> List[BrokerMetricSample]:
        bsamples: List[BrokerMetricSample] = []
        if os.path.exists(self._bfile):
            with open(self._bfile) as f:
                for line in f:
                    b, t, v = json.loads(line)
                    bsamples.append(BrokerMetricSample(b, t, tuple(v)))
        return bsamples

    def load_samples(self):
        psamples, bsamples = self._replay_parallel(
            [self._load_partition_samples, self._load_broker_samples],
            self.loading_threads,
        )
        return psamples, bsamples

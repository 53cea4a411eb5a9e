"""Kafka-backed MetadataClient: topology snapshots straight from the wire
(upstream ``MetadataClient.java`` over the Kafka Metadata API)."""

from __future__ import annotations

from typing import Dict

from cruise_control_tpu_torch.kafka.backend import KafkaClusterBackend
from cruise_control_tpu_torch.monitor.load_monitor import (
    CachingMetadataClient,
    ClusterTopology,
)


class KafkaMetadataClient(CachingMetadataClient):
    """Builds :class:`ClusterTopology` (dense int partition keys) from the
    backend's live metadata.  Rack strings map to dense rack ids; JBOD dirs
    and offline replicas come from describeLogDirs the way the disk-failure
    detector expects."""

    def __init__(self, backend: KafkaClusterBackend, max_age_ms: int = 0):
        super().__init__(max_age_ms=max_age_ms)
        self.backend = backend

    def _refresh(self) -> ClusterTopology:
        b = self.backend
        b.refresh_mapping()
        parts = b.partitions
        racks = b.broker_racks()
        rack_ids: Dict[str, int] = {}
        broker_rack = {
            broker: rack_ids.setdefault(r, len(rack_ids))
            for broker, r in sorted(racks.items())
        }
        # one describeLogDirs serves the whole refresh: the replica->dir
        # mapping (needed on healthy JBOD clusters too, or intra-broker
        # disk goals see every replica on an unknown disk), the offline-dir
        # map, and the offline-replica set
        log_dirs = b.wire.describe_log_dirs()
        offline_dirs = b.offline_log_dirs(log_dirs)
        replica_dirs = {}
        offline_replicas: Dict[int, list] = {}
        for broker, dirs in log_dirs.items():
            for d, meta in dirs.items():
                for tp in meta["replicas"]:
                    k = b.key(tuple(tp))
                    replica_dirs[(k, broker)] = d
                    if meta["offline"]:
                        offline_replicas.setdefault(k, []).append(broker)
        return ClusterTopology(
            assignment={k: list(st.replicas) for k, st in parts.items()},
            leaders={k: st.leader for k, st in parts.items()},
            broker_rack=broker_rack,
            partition_topic=b.partition_topic_names(),
            alive_brokers=b.alive_brokers(),
            offline_replicas=offline_replicas or None,
            replica_dirs=replica_dirs or None,
            offline_dirs=offline_dirs or None,
        )

"""KafkaClusterBackend — the executor's ClusterBackend over the Kafka wire.

Implements the same admin seam the simulated backend does (upstream
``executor/Executor.java``'s AdminClient usage: alterPartitionReassignments,
electLeaders, alterReplicaLogDirs, incrementalAlterConfigs for throttles;
SURVEY.md §2.6), so the executor, the throttle helper, the detectors, and
the metadata client run unchanged against a real cluster.

Kafka addresses partitions as (topic, partition) pairs; the framework's
tensors use dense integer keys.  This backend owns the mapping: external
key = insertion order of (topic, partition) discovered from metadata,
stable for the life of the backend (new partitions append).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.executor.backend import (
    ClusterBackend,
    PartitionState,
    StaleControllerEpochError,
)
from cruise_control_tpu_torch.kafka.wire import KafkaWire, TopicPartition
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("kafka")

#: upstream ReplicationThrottleHelper's dynamic-config keys
LEADER_RATE = "leader.replication.throttled.rate"
FOLLOWER_RATE = "follower.replication.throttled.rate"
LEADER_REPLICAS = "leader.replication.throttled.replicas"
FOLLOWER_REPLICAS = "follower.replication.throttled.replicas"

#: cluster-default dynamic config carrying the execution-fencing epoch
#: (Kafka has no first-class controller-epoch claim for external tools,
#: so the epoch rides the cluster-default broker config scope — entity
#: name "" — which every controller instance reads and writes through
#: the same AdminClient surface)
CONTROLLER_EPOCH_KEY = "cruise.control.controller.epoch"


class KafkaClusterBackend(ClusterBackend):
    def __init__(self, wire: KafkaWire,
                 progress_check_interval_ms: int = 10_000):
        self.wire = wire
        self.progress_check_interval_ms = progress_check_interval_ms
        self._key_of: Dict[TopicPartition, int] = {}
        self._tp_of: List[TopicPartition] = []
        #: one describe_topics snapshot per progress-check interval — the
        #: executor reads partition state once per in-flight task per tick,
        #: which must not become one full-cluster metadata RPC each
        self._topo: Optional[Dict[str, List[dict]]] = None
        #: bumped by _dirty(): a describe RPC only memoizes its result if
        #: no invalidation happened while it was in flight, so a mutation
        #: (reassignment, leader election) can never be papered over by a
        #: pre-mutation snapshot that finishes late
        self._topo_gen = 0
        #: The dense-id mapping is reachable from N fetcher threads
        #: (MetricFetcherManager runs samplers on a pool, and in Kafka mode
        #: every sampler shares this backend as metadata): an unguarded
        #: check-then-append could hand one dense id to two different
        #: TopicPartitions, desynchronizing _tp_of from _key_of — and dense
        #: ids feed tp(key), which the executor uses to issue reassignments.
        #: Resolved lookups stay lock-free (GIL-atomic dict reads); only
        #: mapping/topology WRITES take the lock, and the describe RPC runs
        #: outside it, so a slow refresh never stalls other threads.
        self._lock = threading.RLock()
        self.refresh_mapping()

    def _describe(self) -> Dict[str, List[dict]]:
        topo = self._topo
        if topo is None:
            with self._lock:
                gen = self._topo_gen
            # the describe RPC (up to timeout_s) runs OUTSIDE the lock so a
            # refresh never stalls other threads' already-resolved lookups;
            # two racing refreshes cost a duplicate RPC, which is fine
            fresh = self.wire.describe_topics()
            with self._lock:
                if self._topo is None and self._topo_gen == gen:
                    self._topo = fresh
            # always return OUR OWN fetch, never a racer's memoized result
            # (which may predate the _dirty() that sent us here)
            return fresh
        return topo

    def _dirty(self) -> None:
        with self._lock:
            self._topo = None
            self._topo_gen += 1

    # ---- id mapping ------------------------------------------------------------
    def refresh_mapping(self) -> None:
        self._dirty()
        # post-dirty, _describe can only hand back a snapshot fetched
        # after the generation bump (the gen guard rejects older in-flight
        # memoizations), so it necessarily reflects the partition whose
        # lookup triggered this refresh
        topo = self._describe()
        with self._lock:
            for topic, rows in sorted(topo.items()):
                for row in rows:
                    tp = (topic, row["partition"])
                    if tp not in self._key_of:
                        # append FIRST: a lock-free reader that sees the
                        # _key_of entry must be able to resolve tp(key)
                        self._tp_of.append(tp)
                        self._key_of[tp] = len(self._tp_of) - 1

    def key(self, tp: TopicPartition) -> int:
        k = self._key_of.get(tp)  # lock-free fast path (GIL-atomic read)
        if k is None:
            self.refresh_mapping()
            with self._lock:
                k = self._key_of[tp]
        return k

    def try_key(self, tp: TopicPartition,
                refresh: bool = True) -> Optional[int]:
        """``key`` without the exception — and with the metadata refresh
        under the CALLER's control, so a batch decoding thousands of
        records for a stale topic refreshes once, not per record."""
        k = self._key_of.get(tp)  # lock-free fast path
        if k is None and refresh:
            self.refresh_mapping()
            with self._lock:
                k = self._key_of.get(tp)
        return k

    def tp(self, key: int) -> TopicPartition:
        return self._tp_of[key]

    # ---- topology reads (BackendMetadataClient duck-type surface) --------------
    @property
    def partitions(self) -> Dict[int, PartitionState]:
        out: Dict[int, PartitionState] = {}
        for topic, rows in self._describe().items():
            for row in rows:
                k = self.key((topic, row["partition"]))
                out[k] = PartitionState(
                    replicas=list(row["replicas"]),
                    leader=row["leader"],
                    catching_up=set(row["replicas"]) - set(row["isr"]),
                )
        return out

    def partition_topic_names(self) -> Dict[int, str]:
        return {k: t for k, (t, _) in enumerate(self._tp_of)}

    def broker_racks(self) -> Dict[int, str]:
        return {
            b: meta.get("rack", "") or ""
            for b, meta in self.wire.describe_cluster().items()
        }

    def alive_brokers(self) -> Set[int]:
        return set(self.wire.describe_cluster())

    def partition_state(self, partition: int) -> PartitionState:
        topic, p = self.tp(partition)
        row = next(
            r for r in self._describe()[topic]
            if r["partition"] == p
        )
        return PartitionState(
            replicas=list(row["replicas"]),
            leader=row["leader"],
            catching_up=set(row["replicas"]) - set(row["isr"]),
        )

    def under_replicated_partitions(self) -> Set[int]:
        out = set()
        for topic, rows in self._describe().items():
            for row in rows:
                if set(row["isr"]) != set(row["replicas"]):
                    out.add(self.key((topic, row["partition"])))
        return out

    # ---- plan egress -----------------------------------------------------------
    def alter_partition_reassignments(
        self, reassignments: Dict[int, Sequence[int]]
    ) -> None:
        self._dirty()
        self.wire.alter_partition_reassignments(
            {self.tp(k): list(v) for k, v in reassignments.items()}
        )

    def elect_leaders(self, partitions: Dict[int, int]) -> None:
        # Kafka's electLeaders promotes the PREFERRED leader — the first
        # replica of the partition's CURRENT replica list.  Leadership-only
        # proposals never reassign, so first put the desired leader at the
        # head via a same-set reassignment (metadata-only, no data moves),
        # then run the preferred election.
        snapshot = self.partitions  # one describe for the whole batch
        reorders = {}
        for k, leader in partitions.items():
            st = snapshot[k]
            if st.replicas and st.replicas[0] != leader \
                    and leader in st.replicas:
                reorders[self.tp(k)] = [leader] + [
                    b for b in st.replicas if b != leader
                ]
        if reorders:
            self.wire.alter_partition_reassignments(reorders)
            # A real wire applies the metadata-only reorder asynchronously;
            # electing before the new head is visible would promote the OLD
            # preferred leader.  Poll until every reorder has settled (same
            # replica set ⇒ no data movement, so this converges in one
            # metadata round on a real cluster; FakeKafkaWire is synchronous
            # and passes the first check).
            self._await_replica_order(reorders)
        self.wire.elect_leaders([self.tp(k) for k in partitions])
        self._dirty()

    def _await_replica_order(
        self, desired: Dict[TopicPartition, List[int]],
        timeout_s: float = 30.0,
    ) -> None:
        deadline = time.monotonic() + timeout_s
        delay = 0.1
        while True:
            self._dirty()
            topo = self._describe()
            in_flight = set(self.wire.list_partition_reassignments())
            settled = all(
                tp not in in_flight and next(
                    (r["replicas"] for r in topo.get(tp[0], ())
                     if r["partition"] == tp[1]), None
                ) == order
                for tp, order in desired.items()
            )
            if settled:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "replica-order staging for preferred-leader election "
                    f"did not settle within {timeout_s}s: {desired}"
                )
            # each poll is a full-cluster describe: back off so a slow
            # settle costs a handful of metadata rounds, not hundreds
            time.sleep(delay)
            delay = min(delay * 2, 1.0)

    def ongoing_reassignments(self) -> Set[int]:
        return {
            self.key(tp)
            for tp in self.wire.list_partition_reassignments()
        }

    def reassignment_targets(self) -> Dict[int, List[int]]:
        """Target replica list per in-flight reassignment: the listed
        replicas minus the ones being removed (upstream
        listPartitionReassignments semantics)."""
        out: Dict[int, List[int]] = {}
        for tp, meta in self.wire.list_partition_reassignments().items():
            removing = set(meta.get("removing", ()))
            out[self.key(tp)] = [
                b for b in meta.get("replicas", ()) if b not in removing
            ]
        return out

    # ---- execution fencing ------------------------------------------------------
    def controller_epoch(self) -> int:
        cfg = self.wire.describe_configs("broker", "")
        try:
            return int(cfg.get(CONTROLLER_EPOCH_KEY) or 0)
        except (TypeError, ValueError):
            return 0

    def claim_controller_epoch(self, expected: Optional[int] = None) -> int:
        current = self.controller_epoch()
        if expected is not None and current != expected:
            raise StaleControllerEpochError(
                "claim_controller_epoch", expected, current
            )
        claimed = current + 1
        self.wire.incremental_alter_configs(
            "broker", "", {CONTROLLER_EPOCH_KEY: str(claimed)}
        )
        LOG.warning("claimed controller epoch %d (was %d)", claimed, current)
        return claimed

    def verify_controller_epoch(self, epoch: int) -> None:
        registered = self.controller_epoch()
        if epoch < registered:
            raise StaleControllerEpochError("verify", epoch, registered)

    def cancel_reassignments(self, partitions: Sequence[int]) -> None:
        self._dirty()
        self.wire.alter_partition_reassignments(
            {self.tp(k): None for k in partitions}
        )

    # ---- JBOD ------------------------------------------------------------------
    def alter_replica_log_dirs(
        self, moves: Dict[int, Dict[int, str]]
    ) -> None:
        flat = {}
        for k, by_broker in moves.items():
            t, p = self.tp(k)
            for b, d in by_broker.items():
                flat[(t, p, b)] = d
        self.wire.alter_replica_log_dirs(flat)
        self._dirty()

    def replica_log_dir(self, partition: int, broker: int) -> Optional[str]:
        t, p = self.tp(partition)
        for d, meta in self.wire.describe_log_dirs().get(broker, {}).items():
            if (t, p) in meta["replicas"]:
                return d
        return None

    def offline_log_dirs(
        self, log_dirs: Optional[Dict[int, Dict[str, dict]]] = None
    ) -> Dict[int, List[str]]:
        dirs_by_broker = (
            log_dirs if log_dirs is not None
            else self.wire.describe_log_dirs()
        )
        return {
            b: [d for d, meta in dirs.items() if meta["offline"]]
            for b, dirs in dirs_by_broker.items()
            if any(meta["offline"] for meta in dirs.values())
        }

    # ---- throttles (upstream ReplicationThrottleHelper wire format) ------------
    def set_throttles(self, rate: float, partitions: Sequence[int]) -> None:
        rate_s = str(int(rate))
        alive = sorted(self.alive_brokers())
        for b in alive:
            self.wire.incremental_alter_configs(
                "broker", str(b),
                {LEADER_RATE: rate_s, FOLLOWER_RATE: rate_s},
            )
        snapshot = self.partitions  # one describe for the whole batch
        by_topic: Dict[str, List[str]] = {}
        for k in partitions:
            t, p = self.tp(k)
            for b in snapshot[k].replicas:
                by_topic.setdefault(t, []).append(f"{p}:{b}")
        for t, entries in by_topic.items():
            v = ",".join(sorted(set(entries)))
            self.wire.incremental_alter_configs(
                "topic", t, {LEADER_REPLICAS: v, FOLLOWER_REPLICAS: v},
            )
        LOG.info("throttles set: %s B/s on %d brokers / %d topics",
                 rate_s, len(alive), len(by_topic))

    def clear_throttles(self) -> None:
        for b in sorted(self.alive_brokers()):
            self.wire.incremental_alter_configs(
                "broker", str(b), {LEADER_RATE: None, FOLLOWER_RATE: None},
            )
        for t in self.wire.describe_topics():
            self.wire.incremental_alter_configs(
                "topic", t,
                {LEADER_REPLICAS: None, FOLLOWER_REPLICAS: None},
            )
        LOG.info("throttles cleared")

    def describe_config(self, scope: str, entity) -> Dict[str, str]:
        return self.wire.describe_configs(scope, str(entity))

    def alter_config(self, scope: str, entity,
                     updates: Dict[str, Optional[str]]) -> None:
        self.wire.incremental_alter_configs(scope, str(entity), updates)

    # ---- pacing ----------------------------------------------------------------
    def tick(self) -> None:
        """One executor progress-check interval.

        Over a scripted wire, advance its clock; over a real cluster, wait
        ``execution.progress.check.interval.ms`` of wall time (upstream's
        metadata poll cadence)."""
        self._dirty()
        advance = getattr(self.wire, "advance", None)
        if advance is not None:
            advance()
        else:  # pragma: no cover - real deployments only
            time.sleep(self.progress_check_interval_ms / 1000.0)

"""The Kafka wire seam: the minimal admin/produce/consume RPC surface the
adapter needs, plus a scripted in-process implementation.

The build environment has no Kafka broker and no network, so the adapter
stack (``kafka.backend`` / ``kafka.sampler`` / ``kafka.sample_store`` /
``kafka.metadata``) is written against this seam and proven over
:class:`FakeKafkaWire` — a deterministic single-process broker model with
the same observable semantics the real protocol gives the upstream Java
code: reassignments progress over time and are listable while in flight,
preferred-leader election only promotes ISR members, dynamic configs are
incremental with delete-on-None, and topics are append-only offset-addressed
logs (upstream ``executor/Executor.java`` + ``AdminClient`` usage,
SURVEY.md §2.6).

A production deployment implements this same class over a real client
(``confluent_kafka``/``kafka-python``); :func:`real_wire` builds one when
such a client is importable and raises a clear error here, where none is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

TopicPartition = Tuple[str, int]


class WireError(Exception):
    """A Kafka RPC failed (base of the wire's typed error hierarchy)."""


class RetriableWireError(WireError):
    """Transient failure — safe to retry the same RPC."""


class WireTimeoutError(RetriableWireError):
    """The RPC (or its future) timed out."""


class FatalWireError(WireError):
    """The client instance is unusable (e.g. fenced producer) — rebuild
    the wire before retrying."""


class UnsupportedRpcError(WireError):
    """The underlying client library does not implement this RPC."""


class KafkaWire:
    """One method per Kafka RPC the framework uses."""

    # ---- metadata -------------------------------------------------------------
    def describe_cluster(self) -> Dict[int, dict]:
        """broker id → {"rack": str}; only live brokers appear."""
        raise NotImplementedError

    def describe_topics(self) -> Dict[str, List[dict]]:
        """topic → [{"partition", "leader", "replicas", "isr"}]."""
        raise NotImplementedError

    # ---- reassignment ---------------------------------------------------------
    def alter_partition_reassignments(
        self, targets: Dict[TopicPartition, Optional[Sequence[int]]]
    ) -> None:
        """target replica list per partition; None cancels an in-flight
        reassignment (the AdminClient empty-target form)."""
        raise NotImplementedError

    def list_partition_reassignments(self) -> Dict[TopicPartition, dict]:
        """in-flight reassignments: tp → {"replicas", "adding", "removing"}."""
        raise NotImplementedError

    def elect_leaders(self, partitions: Sequence[TopicPartition]) -> None:
        """Preferred leader election (first in-sync replica of the list)."""
        raise NotImplementedError

    # ---- configs --------------------------------------------------------------
    def describe_configs(self, rtype: str, name: str) -> Dict[str, str]:
        raise NotImplementedError

    def incremental_alter_configs(
        self, rtype: str, name: str, updates: Dict[str, Optional[str]]
    ) -> None:
        raise NotImplementedError

    # ---- log dirs (JBOD) ------------------------------------------------------
    def alter_replica_log_dirs(
        self, moves: Dict[Tuple[str, int, int], str]
    ) -> None:
        """(topic, partition, broker) → target log dir."""
        raise NotImplementedError

    def describe_log_dirs(self) -> Dict[int, Dict[str, dict]]:
        """broker → {dir → {"offline": bool, "replicas": [(topic, p)...]}}."""
        raise NotImplementedError

    # ---- topics as logs -------------------------------------------------------
    def create_topic(self, name: str, num_partitions: int = 1,
                     replication_factor: int = 1,
                     configs: Optional[Dict[str, str]] = None) -> None:
        """Idempotent create (the reporter/sample-store auto-create path)."""
        raise NotImplementedError

    def produce(self, topic: str, records: Sequence[bytes],
                keys: Optional[Sequence[bytes]] = None) -> None:
        """Append ``records``; ``keys`` (same length, when given) are the
        record keys — REQUIRED by compacted topics (a real broker rejects
        keyless writes once ``cleanup.policy=compact``), used for
        partitioning otherwise."""
        raise NotImplementedError

    def consume(self, topic: str, offset: int) -> Tuple[List[bytes], int]:
        """Records from ``offset`` on → (records, next offset).

        THREAD-SAFETY CONTRACT: callers issue concurrent ``consume`` calls
        (the sample-store replay reads its two topics in parallel; the
        fetcher pool pulls on N threads).  An implementation over a client
        library whose consumers are not thread-safe must create one
        consumer per call (the call is stateless — seek to ``offset``,
        drain, close) rather than share one.

        CURSOR CONTRACT: the returned "next offset" is an OPAQUE resume
        token — pass it back to ``consume`` unmodified.  Implementations
        may return an ``int`` subclass carrying extra resume state (e.g.
        ``ConfluentKafkaWire``'s ``VirtualOffset`` holds exact
        per-partition positions for multi-partition topics); arithmetic
        on it (``offset + n``) or a JSON/DB round-trip strips that state
        and silently degrades resume precision to the implementation's
        fallback.  Callers that must persist a cursor should treat the
        loss as implementation-defined, and alternative wire
        implementations must tolerate receiving a plain ``int`` from such
        a round-trip."""
        raise NotImplementedError


@dataclasses.dataclass
class _FakePartition:
    replicas: List[int]
    leader: int
    isr: List[int]
    adding: List[int] = dataclasses.field(default_factory=list)
    removing: List[int] = dataclasses.field(default_factory=list)
    target: Optional[List[int]] = None
    progress: int = 0


class FakeKafkaWire(KafkaWire):
    """Deterministic scripted broker (see module doc).

    ``advance()`` moves time forward one step: every unblocked in-flight
    reassignment's progress increments, and reassignments reaching
    ``move_latency_steps`` complete (adding replicas join the ISR, removed
    replicas leave).  ``failed_brokers`` never catch up — their
    reassignments stay listed forever, which is exactly what the executor's
    timeout path needs to observe.
    """

    def __init__(
        self,
        assignment: Dict[TopicPartition, Sequence[int]],
        leaders: Optional[Dict[TopicPartition, int]] = None,
        broker_racks: Optional[Dict[int, str]] = None,
        move_latency_steps: int = 1,
        failed_brokers: Optional[Set[int]] = None,
    ):
        leaders = leaders or {}
        self.partitions: Dict[TopicPartition, _FakePartition] = {}
        for tp, reps in assignment.items():
            reps = list(reps)
            self.partitions[tp] = _FakePartition(
                replicas=reps, leader=leaders.get(tp, reps[0]),
                isr=list(reps),
            )
        brokers = {b for reps in assignment.values() for b in reps}
        self.broker_racks = dict(
            broker_racks
            or {b: f"rack_{b % 3}" for b in brokers}
        )
        self.move_latency_steps = move_latency_steps
        self.failed_brokers = set(failed_brokers or ())
        self.configs: Dict[Tuple[str, str], Dict[str, str]] = {}
        self.log_dirs: Dict[int, Dict[str, dict]] = {}
        self.replica_dirs: Dict[Tuple[str, int, int], str] = {}
        self.logs: Dict[str, List[bytes]] = {}
        self.topic_configs: Dict[str, Dict[str, str]] = {}
        #: every admin RPC issued, in order — tests script against this the
        #: way upstream tests assert on MockAdminClient invocations
        self.rpc_log: List[tuple] = []

    # ---- metadata -------------------------------------------------------------
    def describe_cluster(self) -> Dict[int, dict]:
        return {
            b: {"rack": r} for b, r in self.broker_racks.items()
            if b not in self.failed_brokers
        }

    def describe_topics(self) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for (t, p), st in self.partitions.items():
            out.setdefault(t, []).append({
                "partition": p,
                "leader": st.leader,
                "replicas": list(st.replicas),
                "isr": list(st.isr),
            })
        for rows in out.values():
            rows.sort(key=lambda r: r["partition"])
        return out

    # ---- reassignment ---------------------------------------------------------
    def alter_partition_reassignments(
        self, targets: Dict[TopicPartition, Optional[Sequence[int]]]
    ) -> None:
        self.rpc_log.append(("alter_partition_reassignments", dict(targets)))
        for tp, new in targets.items():
            st = self.partitions[tp]
            if new is None:  # cancel: revert to the original replica set
                if st.target is not None:
                    st.replicas = [
                        b for b in st.replicas if b not in st.adding
                    ]
                    st.isr = [b for b in st.isr if b in st.replicas]
                    st.target = None
                    st.adding = []
                    st.removing = []
                continue
            new = list(new)
            st.adding = [b for b in new if b not in st.replicas]
            st.removing = [b for b in st.replicas if b not in new]
            if not st.adding and not st.removing:
                # pure reorder: no replica catches up, Kafka applies the new
                # order immediately (metadata-only change)
                st.replicas = new
                st.isr = [b for b in new if b in st.isr]
                st.target = None
                continue
            st.replicas = list(dict.fromkeys(st.replicas + st.adding))
            st.target = new
            st.progress = 0

    def list_partition_reassignments(self) -> Dict[TopicPartition, dict]:
        return {
            tp: {
                "replicas": list(st.replicas),
                "adding": list(st.adding),
                "removing": list(st.removing),
            }
            for tp, st in self.partitions.items()
            if st.target is not None
        }

    def elect_leaders(self, partitions: Sequence[TopicPartition]) -> None:
        self.rpc_log.append(("elect_leaders", list(partitions)))
        for tp in partitions:
            st = self.partitions[tp]
            for b in st.replicas:  # preferred order
                if b in st.isr and b not in self.failed_brokers:
                    st.leader = b
                    break

    # ---- configs --------------------------------------------------------------
    def describe_configs(self, rtype: str, name: str) -> Dict[str, str]:
        return dict(self.configs.get((rtype, name), {}))

    def incremental_alter_configs(
        self, rtype: str, name: str, updates: Dict[str, Optional[str]]
    ) -> None:
        self.rpc_log.append(("incremental_alter_configs", rtype, name,
                             dict(updates)))
        cfg = self.configs.setdefault((rtype, name), {})
        for k, v in updates.items():
            if v is None:
                cfg.pop(k, None)
            else:
                cfg[k] = v
        if not cfg:
            self.configs.pop((rtype, name), None)

    # ---- log dirs -------------------------------------------------------------
    def alter_replica_log_dirs(
        self, moves: Dict[Tuple[str, int, int], str]
    ) -> None:
        self.rpc_log.append(("alter_replica_log_dirs", dict(moves)))
        for (t, p, b), d in moves.items():
            if b in self.partitions.get((t, p), _FakePartition([], -1, [])).replicas:
                if not self.log_dirs.get(b, {}).get(d, {}).get("offline"):
                    self.replica_dirs[(t, p, b)] = d

    def describe_log_dirs(self) -> Dict[int, Dict[str, dict]]:
        out: Dict[int, Dict[str, dict]] = {}
        for b, dirs in self.log_dirs.items():
            out[b] = {
                d: {
                    "offline": bool(meta.get("offline")),
                    "replicas": [
                        (t, p) for (t, p, rb), rd in self.replica_dirs.items()
                        if rb == b and rd == d
                    ],
                }
                for d, meta in dirs.items()
            }
        return out

    # ---- topics as logs -------------------------------------------------------
    def create_topic(self, name, num_partitions=1, replication_factor=1,
                     configs=None) -> None:
        self.rpc_log.append(("create_topic", name, num_partitions,
                             replication_factor))
        self.logs.setdefault(name, [])
        if configs:
            self.topic_configs.setdefault(name, {}).update(configs)

    def produce(self, topic: str, records: Sequence[bytes],
                keys: Optional[Sequence[bytes]] = None) -> None:
        if self.topic_configs.get(topic, {}).get(
                "cleanup.policy") == "compact" and keys is None:
            # faithful to the real broker: compacted topics reject
            # keyless records (INVALID_RECORD)
            raise ValueError(
                f"compacted topic {topic!r} rejects records without keys"
            )
        self.logs.setdefault(topic, []).extend(records)

    def consume(self, topic: str, offset: int) -> Tuple[List[bytes], int]:
        log = self.logs.get(topic, [])
        return list(log[offset:]), len(log)

    # ---- scripted time --------------------------------------------------------
    def advance(self, steps: int = 1) -> None:
        for _ in range(steps):
            for st in self.partitions.values():
                if st.target is None:
                    continue
                if any(b in self.failed_brokers for b in st.adding):
                    continue  # catch-up blocked: stays listed forever
                st.progress += 1
                if st.progress >= self.move_latency_steps:
                    st.replicas = list(st.target)
                    st.isr = [
                        b for b in st.replicas
                        if b not in self.failed_brokers
                    ]
                    if st.leader not in st.replicas and st.isr:
                        st.leader = st.isr[0]
                    st.target = None
                    st.adding = []
                    st.removing = []


def real_wire(bootstrap_servers: str,
              client_config=None, timeout_s: float = 30.0,
              timeouts=None) -> KafkaWire:
    """The production wire: :class:`~.confluent_wire.ConfluentKafkaWire`
    over ``confluent_kafka`` when the client library is importable.

    The build environment ships no client library and no network, so here
    this raises a clear error; the implementation itself is fully
    unit-tested against a mocked ``confluent_kafka`` module
    (``tests/test_confluent_wire.py``).
    """
    try:
        import confluent_kafka  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "no Kafka client library available in this environment; "
            "install confluent_kafka to connect to "
            f"{bootstrap_servers!r} (the wire implementation is bundled: "
            "cruise_control_tpu_torch.kafka.confluent_wire)"
        ) from None
    from cruise_control_tpu_torch.kafka.confluent_wire import ConfluentKafkaWire

    return ConfluentKafkaWire(
        bootstrap_servers, client_config=client_config, timeout_s=timeout_s,
        timeouts=timeouts,
    )

"""Cluster backend SPI + in-process simulated implementation.

The reference executes plans through the Kafka admin protocol
(``alterPartitionReassignments`` / ``electLeaders`` / dynamic-config
throttles; upstream ``executor/Executor.java``, SURVEY.md §2.6).  Here the
admin surface is an explicit interface; the build environment has no Kafka and
no network, so the first-class implementation is a **simulated cluster** — a
deterministic state machine that applies reassignments with configurable
latency and failure injection (SURVEY.md §4 tier-3 "embedded cluster"
equivalent).  A real-Kafka adapter implements the same interface out of tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


class StaleControllerEpochError(RuntimeError):
    """A mutating admin call presented a controller epoch older than the
    cluster-registered one: another controller took over since this
    process claimed ownership.  The caller is a zombie and must stop —
    loudly — instead of double-moving replicas."""

    def __init__(self, op: str, presented: int, registered: int):
        super().__init__(
            f"stale controller epoch on {op}: presented {presented}, "
            f"cluster has {registered}"
        )
        self.op = op
        self.presented = presented
        self.registered = registered


@dataclasses.dataclass
class PartitionState:
    replicas: List[int]
    leader: int
    #: replicas still catching up (in-flight adds); subset of ``replicas``
    catching_up: Set[int] = dataclasses.field(default_factory=set)

    @property
    def isr(self) -> List[int]:
        return [b for b in self.replicas if b not in self.catching_up]


class ClusterBackend:
    """Admin-protocol seam (one method per upstream AdminClient call)."""

    def alter_partition_reassignments(
        self, reassignments: Dict[int, Sequence[int]]
    ) -> None:
        raise NotImplementedError

    def elect_leaders(self, partitions: Dict[int, int]) -> None:
        """partition → preferred leader broker."""
        raise NotImplementedError

    def alter_replica_log_dirs(
        self, moves: Dict[int, Dict[int, str]]
    ) -> None:
        """partition → {broker → target log dir} (JBOD intra-broker moves;
        upstream AdminClient.alterReplicaLogDirs)."""
        raise NotImplementedError

    def replica_log_dir(self, partition: int, broker: int) -> Optional[str]:
        """Current log dir of a replica (upstream describeReplicaLogDirs);
        None when unknown."""
        raise NotImplementedError

    def ongoing_reassignments(self) -> Set[int]:
        raise NotImplementedError

    def cancel_reassignments(self, partitions: Sequence[int]) -> None:
        """Revert in-flight reassignments (upstream
        alterPartitionReassignments with an empty target — the executor's
        startup stop path)."""
        raise NotImplementedError

    def partition_state(self, partition: int) -> PartitionState:
        raise NotImplementedError

    def set_throttles(self, rate: float, partitions: Sequence[int]) -> None:
        raise NotImplementedError

    def clear_throttles(self) -> None:
        raise NotImplementedError

    def describe_config(self, scope: str, entity: int) -> Dict[str, str]:
        """Dynamic configs for ("broker", id) or ("partition", id) — the
        upstream AdminClient.describeConfigs surface the throttle helper
        reads to preserve user-set throttles."""
        raise NotImplementedError

    def alter_config(
        self, scope: str, entity: int, updates: Dict[str, Optional[str]]
    ) -> None:
        """Apply dynamic-config updates; a ``None`` value deletes the key
        (upstream incrementalAlterConfigs DELETE op)."""
        raise NotImplementedError

    def alive_brokers(self) -> Set[int]:
        raise NotImplementedError

    def under_replicated_partitions(self) -> Set[int]:
        raise NotImplementedError

    # ---- execution fencing (optional capability) --------------------------------
    # A cluster-side controller epoch (the moral equivalent of Kafka's
    # controller epoch / ZK czxid fencing): claiming bumps it atomically,
    # every mutating admin call presents the claimant's epoch, and a
    # presented epoch older than the registered one is refused.  Backends
    # without the capability leave these unimplemented — the fenced
    # wrapper then degrades to unfenced (single-writer-by-assumption)
    # operation.
    def controller_epoch(self) -> int:
        """The currently registered controller epoch (0 = never claimed)."""
        raise NotImplementedError

    def claim_controller_epoch(self, expected: Optional[int] = None) -> int:
        """Atomically bump and return the controller epoch.  With
        ``expected``, the claim is conditional (compare-and-swap): it
        succeeds only while the registered epoch still equals
        ``expected`` — the seam that refuses a zombie resume after a
        newer process already took the checkpoint over."""
        raise NotImplementedError

    def verify_controller_epoch(self, epoch: int) -> None:
        """Refuse (raise StaleControllerEpochError) when ``epoch`` is
        older than the registered controller epoch."""
        raise NotImplementedError

    def reassignment_targets(self) -> Dict[int, List[int]]:
        """partition → target replica list of every in-flight reassignment
        (upstream listPartitionReassignments exposes adding/removing
        replicas, from which the target is derivable).  Optional: the
        executor's foreign-conflict detection degrades to mismatch-only
        without it."""
        raise NotImplementedError


class FencedClusterBackend:
    """The executor's write path: every MUTATING admin call first presents
    the owner's controller epoch to the inner backend
    (:meth:`ClusterBackend.verify_controller_epoch`), so a zombie process
    — one that claimed the epoch long ago and thawed after a newer
    process took over — is refused at the cluster seam instead of
    double-moving replicas.  Refusals journal ``executor.fenced`` before
    raising.  Reads delegate unchanged; inner backends without the epoch
    capability degrade to unfenced pass-through.

    The project discipline (cclint ``fenced-backend-discipline``): outside
    the backend implementations themselves, mutating admin calls may only
    be made through an instance of this wrapper (the executor's
    ``self.backend``)."""

    def __init__(self, inner: ClusterBackend,
                 epoch_source: Callable[[], int]):
        self.inner = inner
        #: the owner's current epoch (the executor's claim)
        self.epoch_source = epoch_source
        self._fence_supported: Optional[bool] = None

    def __getattr__(self, name: str):
        # read-only surface (partition_state, alive_brokers, tick, the
        # scripted backend's fault hooks, ...) delegates untouched; only
        # the mutating methods defined below go through the fence
        return getattr(self.inner, name)

    def _present(self, op: str) -> None:
        """Present the owner's epoch; StaleControllerEpochError journals
        ``executor.fenced`` and propagates (the zombie must stop)."""
        if self._fence_supported is None:
            self._fence_supported = hasattr(
                type(self.inner), "verify_controller_epoch"
            ) and type(self.inner).verify_controller_epoch is not (
                ClusterBackend.verify_controller_epoch
            )
        if not self._fence_supported:
            return
        from cruise_control_tpu_torch.telemetry import events

        try:
            self.inner.verify_controller_epoch(self.epoch_source())
        except StaleControllerEpochError as e:
            events.emit(
                "executor.fenced", severity="ERROR", op=op,
                presentedEpoch=e.presented, clusterEpoch=e.registered,
            )
            raise

    def claim(self, expected: Optional[int] = None) -> Optional[int]:
        """Claim ownership: bump the cluster epoch (conditionally, with
        ``expected``).  Returns the claimed epoch, or None when the inner
        backend has no epoch capability.  A refused conditional claim
        journals ``executor.fenced`` and raises."""
        claim = getattr(self.inner, "claim_controller_epoch", None)
        if claim is None:
            return None
        from cruise_control_tpu_torch.telemetry import events

        try:
            return claim(expected)
        except StaleControllerEpochError as e:
            events.emit(
                "executor.fenced", severity="ERROR", op="claim",
                presentedEpoch=e.presented, clusterEpoch=e.registered,
            )
            raise
        except NotImplementedError:
            return None

    # ---- fenced mutations -------------------------------------------------------
    def alter_partition_reassignments(
        self, reassignments: Dict[int, Sequence[int]]
    ) -> None:
        self._present("alter_partition_reassignments")
        self.inner.alter_partition_reassignments(reassignments)

    def elect_leaders(self, partitions: Dict[int, int]) -> None:
        self._present("elect_leaders")
        self.inner.elect_leaders(partitions)

    def alter_replica_log_dirs(
        self, moves: Dict[int, Dict[int, str]]
    ) -> None:
        self._present("alter_replica_log_dirs")
        self.inner.alter_replica_log_dirs(moves)

    def cancel_reassignments(self, partitions: Sequence[int]) -> None:
        self._present("cancel_reassignments")
        self.inner.cancel_reassignments(partitions)

    def set_throttles(self, rate: float, partitions: Sequence[int]) -> None:
        self._present("set_throttles")
        self.inner.set_throttles(rate, partitions)

    def clear_throttles(self) -> None:
        self._present("clear_throttles")
        self.inner.clear_throttles()

    def alter_config(
        self, scope: str, entity: int, updates: Dict[str, Optional[str]]
    ) -> None:
        self._present("alter_config")
        self.inner.alter_config(scope, entity, updates)


class SimulatedClusterBackend(ClusterBackend):
    """Deterministic in-memory cluster.

    Reassignment model: when a reassignment arrives, new replicas enter
    ``catching_up``; each :meth:`tick` advances every catching-up replica's
    progress by one step; after ``move_latency_ticks`` steps the replica
    joins the ISR and dropped replicas leave.  Failure injection: brokers in
    ``failed_brokers`` never finish catch-up (their tasks eventually go DEAD
    via the executor's timeout), and ``fail_partitions`` aborts those
    reassignments outright.
    """

    def __init__(
        self,
        assignment: Dict[int, Sequence[int]],
        leaders: Dict[int, int],
        move_latency_ticks: int = 1,
        failed_brokers: Optional[Set[int]] = None,
        fail_partitions: Optional[Set[int]] = None,
        brokers: Optional[Set[int]] = None,
    ):
        self.partitions: Dict[int, PartitionState] = {
            p: PartitionState(list(reps), leaders[p]) for p, reps in assignment.items()
        }
        # liveness is an explicit broker set, not inferred from placement: a
        # live broker hosting zero replicas (e.g. freshly added) is still alive
        self.brokers: Set[int] = (
            set(brokers)
            if brokers is not None
            else {b for reps in assignment.values() for b in reps}
            | set(leaders.values())
        )
        self.move_latency_ticks = move_latency_ticks
        self.failed_brokers = failed_brokers or set()
        self.fail_partitions = fail_partitions or set()
        self._target: Dict[int, Tuple[List[int], List[int], List[int]]] = {}  # p -> (new, old, adds)
        self._progress: Dict[int, int] = {}
        self.throttle_rate: Optional[float] = None
        self.throttled_partitions: Set[int] = set()
        self.throttle_history: List[Tuple[str, float]] = []
        #: ("broker"|"partition", id) → dynamic config key/values
        self.dynamic_configs: Dict[Tuple[str, int], Dict[str, str]] = {}
        #: broker → offline log dirs (JBOD disk-failure injection; consumed by
        #: DiskFailureDetector the way upstream consumes describeLogDirs)
        self.offline_dirs: Dict[int, List[str]] = {}
        #: (partition, broker) → log dir hosting that replica.  Unmapped
        #: replicas on a broker with offline dirs are treated as offline
        #: (conservative, matches losing the whole JBOD mount set).
        self.replica_dir: Dict[Tuple[int, int], str] = {}
        #: cluster-registered controller epoch (execution fencing)
        self._controller_epoch = 0
        self.ticks = 0

    def offline_log_dirs(self) -> Dict[int, List[str]]:
        return {b: list(d) for b, d in self.offline_dirs.items() if d}

    def offline_replicas(self) -> Dict[int, List[int]]:
        """partition → brokers whose replica sits on an offline dir."""
        out: Dict[int, List[int]] = {}
        for p, st in self.partitions.items():
            for b in st.replicas:
                dead_dirs = self.offline_dirs.get(b)
                if not dead_dirs:
                    continue
                d = self.replica_dir.get((p, b))
                if d is None or d in dead_dirs:
                    out.setdefault(p, []).append(b)
        return out

    def _healthy_dirs(self, broker: int) -> Set[str]:
        known = {d for (_, rb), d in self.replica_dir.items() if rb == broker}
        known.update(self.offline_dirs.get(broker, []))
        return known - set(self.offline_dirs.get(broker, []))

    def degraded_brokers(self) -> Set[int]:
        """Brokers with offline dirs and no known healthy dir left — they
        must not receive new replicas until the disk is replaced."""
        return {
            b for b, dead in self.offline_dirs.items()
            if dead and not self._healthy_dirs(b)
        }

    # ---- execution fencing ------------------------------------------------------
    def controller_epoch(self) -> int:
        return self._controller_epoch

    def claim_controller_epoch(self, expected: Optional[int] = None) -> int:
        if expected is not None and self._controller_epoch != expected:
            raise StaleControllerEpochError(
                "claim_controller_epoch", expected, self._controller_epoch
            )
        self._controller_epoch += 1
        return self._controller_epoch

    def verify_controller_epoch(self, epoch: int) -> None:
        if epoch < self._controller_epoch:
            raise StaleControllerEpochError(
                "verify", epoch, self._controller_epoch
            )

    def reassignment_targets(self) -> Dict[int, List[int]]:
        return {p: list(new) for p, (new, _, _) in self._target.items()}

    # ---- topology mutation (create/delete topic drift) --------------------------
    def create_partitions(
        self, assignment: Dict[int, Sequence[int]], leaders: Dict[int, int]
    ) -> None:
        """New partitions appear in metadata (topic creation mid-flight)."""
        for p, reps in assignment.items():
            self.partitions[p] = PartitionState(list(reps), leaders[p])

    def delete_partitions(self, partitions: Sequence[int]) -> None:
        """Partitions vanish from metadata (topic deletion mid-flight):
        any in-flight reassignment for them evaporates with the data."""
        for p in list(partitions):
            self.partitions.pop(p, None)
            self._target.pop(p, None)
            self._progress.pop(p, None)
            self.fail_partitions.discard(p)
            for key in [k for k in self.replica_dir if k[0] == p]:
                del self.replica_dir[key]

    # ---- admin surface ----------------------------------------------------------
    def alter_partition_reassignments(
        self, reassignments: Dict[int, Sequence[int]]
    ) -> None:
        for p, new_replicas in reassignments.items():
            st = self.partitions.get(p)
            if st is None:
                continue  # upstream: UNKNOWN_TOPIC_OR_PARTITION, per-partition
            if p in self.fail_partitions:
                continue  # silently dropped; executor will time out → DEAD
            new = list(new_replicas)
            adds = [b for b in new if b not in st.replicas]
            st.replicas = list(dict.fromkeys(st.replicas + adds))
            st.catching_up.update(adds)
            self._target[p] = (
                new, [b for b in st.replicas if b not in new], adds
            )
            self._progress[p] = 0

    def _promote_leader(self, st: PartitionState) -> None:
        """Leader election after a membership change: prefer a LIVE
        replica (what the Kafka controller does) — promoting a dead
        broker leaves a partition leaderless-in-practice while live
        replicas exist, the placement violation ISSUE 12's soak caught."""
        if st.leader in st.replicas and st.leader not in self.failed_brokers:
            return
        live = [b for b in st.replicas if b not in self.failed_brokers]
        if live:
            st.leader = live[0]
        elif st.replicas and st.leader not in st.replicas:
            st.leader = st.replicas[0]

    def elect_leaders(self, partitions: Dict[int, int]) -> None:
        for p, leader in partitions.items():
            st = self.partitions[p]
            if leader in st.isr:
                st.leader = leader

    def alter_replica_log_dirs(
        self, moves: Dict[int, Dict[int, str]]
    ) -> None:
        for p, by_broker in moves.items():
            st = self.partitions[p]
            for b, target in by_broker.items():
                if b not in st.replicas:
                    continue  # upstream: ReplicaNotAvailable, move skipped
                if target in self.offline_dirs.get(b, ()):
                    continue  # cannot land on a dead dir
                self.replica_dir[(p, b)] = target

    def replica_log_dir(self, partition: int, broker: int) -> Optional[str]:
        return self.replica_dir.get((partition, broker))

    def ongoing_reassignments(self) -> Set[int]:
        return set(self._target)

    def cancel_reassignments(self, partitions: Sequence[int]) -> None:
        # Kafka cancellation reverts the in-flight adds (adding replicas
        # leave the replica set); dropped-replica removal never happened
        # yet, so the original set is restored
        for p in list(partitions):
            tgt = self._target.pop(p, None)
            self._progress.pop(p, None)
            if tgt is None:
                continue
            _, _, adds = tgt
            st = self.partitions[p]
            # strip only the replicas THIS reassignment added — an
            # originally-assigned replica that happens to lag keeps its
            # membership and its catching-up (URP) status
            st.replicas = [b for b in st.replicas if b not in adds]
            st.catching_up -= set(adds)
            self._promote_leader(st)

    def partition_state(self, partition: int) -> PartitionState:
        return self.partitions[partition]

    def set_throttles(self, rate: float, partitions: Sequence[int]) -> None:
        self.throttle_rate = rate
        self.throttled_partitions = set(partitions)
        self.throttle_history.append(("set", rate))

    def clear_throttles(self) -> None:
        self.throttle_rate = None
        self.throttled_partitions = set()
        self.throttle_history.append(("clear", 0.0))

    def describe_config(self, scope: str, entity: int) -> Dict[str, str]:
        return dict(self.dynamic_configs.get((scope, entity), {}))

    def alter_config(
        self, scope: str, entity: int, updates: Dict[str, Optional[str]]
    ) -> None:
        cfg = self.dynamic_configs.setdefault((scope, entity), {})
        for k, v in updates.items():
            if v is None:
                cfg.pop(k, None)
            else:
                cfg[k] = v
        if not cfg:
            self.dynamic_configs.pop((scope, entity), None)

    def alive_brokers(self) -> Set[int]:
        return self.brokers - self.failed_brokers

    def under_replicated_partitions(self) -> Set[int]:
        return {p for p, st in self.partitions.items() if st.catching_up}

    # ---- simulation -------------------------------------------------------------
    def tick(self) -> None:
        self.ticks += 1
        done: List[int] = []
        for p, (new, dropped, _adds) in self._target.items():
            st = self.partitions[p]
            blocked = any(b in self.failed_brokers for b in st.catching_up)
            if blocked:
                continue
            self._progress[p] += 1
            if self._progress[p] >= self.move_latency_ticks:
                st.catching_up -= set(new)
                old = st.replicas
                st.replicas = list(new)
                self._promote_leader(st)
                # keep the replica→dir map honest: dropped replicas free
                # their dir entry; arrivals land on a healthy dir when the
                # broker has one (upstream: alterReplicaLogDirs picks a
                # live log dir)
                for b in old:
                    if b not in new:
                        self.replica_dir.pop((p, b), None)
                for b in new:
                    if (p, b) not in self.replica_dir:
                        healthy = self._healthy_dirs(b)
                        if healthy:
                            self.replica_dir[(p, b)] = sorted(healthy)[0]
                done.append(p)
        for p in done:
            del self._target[p]
            del self._progress[p]

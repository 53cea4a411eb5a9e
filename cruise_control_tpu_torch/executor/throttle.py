"""Replication throttling around an execution (upstream
``executor/ReplicationThrottleHelper.java``; SURVEY.md §2.6).

For the duration of a plan's replica movements the helper sets the Kafka
dynamic configs:

* per participating broker: ``leader.replication.throttled.rate`` /
  ``follower.replication.throttled.rate`` (bytes/s)
* per moving partition: ``leader.replication.throttled.replicas`` (the
  replicas serving the data — the old placement) and
  ``follower.replication.throttled.replicas`` (the catching-up adds)

and on completion removes **exactly what it set**: rates a user configured
before the execution are left untouched (upstream preserves pre-existing
throttles the same way).  The backend's coarse ``set_throttles`` /
``clear_throttles`` seam is also driven for observability parity.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.executor.backend import ClusterBackend

LEADER_RATE = "leader.replication.throttled.rate"
FOLLOWER_RATE = "follower.replication.throttled.rate"
LEADER_REPLICAS = "leader.replication.throttled.replicas"
FOLLOWER_REPLICAS = "follower.replication.throttled.replicas"


class ReplicationThrottleHelper:
    def __init__(self, backend: ClusterBackend, rate: float):
        self.backend = backend
        self.rate = rate
        self._set_broker_keys: List[Tuple[int, str]] = []
        self._set_partition_keys: List[Tuple[int, str]] = []

    # -- backend dynamic-config seam (optional on the ClusterBackend SPI) ----
    def _describe(self, scope: str, entity: int) -> Dict[str, str]:
        fn = getattr(self.backend, "describe_config", None)
        return dict(fn(scope, entity)) if fn else {}

    def _alter(self, scope: str, entity: int,
               updates: Dict[str, Optional[str]]) -> None:
        fn = getattr(self.backend, "alter_config", None)
        if fn:
            fn(scope, entity, updates)

    # -- lifecycle -----------------------------------------------------------
    def set_throttles(self, proposals: Sequence) -> None:
        """``proposals``: ExecutionProposals whose moves are about to start."""
        moving = [p for p in proposals if p.has_replica_change]
        brokers: Set[int] = set()
        for pr in moving:
            brokers.update(pr.old_replicas)
            brokers.update(pr.new_replicas)
        for b in sorted(brokers):
            existing = self._describe("broker", b)
            for key in (LEADER_RATE, FOLLOWER_RATE):
                if key in existing:
                    continue  # pre-existing user throttle — preserve
                self._alter("broker", b, {key: str(self.rate)})
                self._set_broker_keys.append((b, key))
        for pr in moving:
            leaders = ",".join(str(b) for b in pr.old_replicas)
            followers = ",".join(
                str(b) for b in pr.new_replicas if b not in pr.old_replicas
            )
            existing = self._describe("partition", pr.partition)
            if LEADER_REPLICAS not in existing:
                self._alter("partition", pr.partition,
                            {LEADER_REPLICAS: leaders})
                self._set_partition_keys.append((pr.partition, LEADER_REPLICAS))
            if FOLLOWER_REPLICAS not in existing and followers:
                self._alter("partition", pr.partition,
                            {FOLLOWER_REPLICAS: followers})
                self._set_partition_keys.append(
                    (pr.partition, FOLLOWER_REPLICAS)
                )
        # coarse seam for observability/legacy parity
        self.backend.set_throttles(self.rate, [p.partition for p in moving])

    def adopt_existing(self, proposals: Sequence,
                       rate: Optional[float] = None) -> None:
        """Register throttle configs a DEAD run of this plan left behind
        (crash between ``set_throttles`` and cleanup) as ours, so
        :meth:`clear_throttles` removes them — the resume-after-crash
        leak fix.  Adoption is value-matched: only keys whose value
        equals exactly what ``set_throttles`` would have written for
        this plan at this rate are claimed; anything else is a genuine
        user throttle and stays untouched."""
        moving = [p for p in proposals if p.has_replica_change]
        brokers: Set[int] = set()
        for pr in moving:
            brokers.update(pr.old_replicas)
            brokers.update(pr.new_replicas)
        rate_s = str(self.rate if rate is None else rate)
        for b in sorted(brokers):
            existing = self._describe("broker", b)
            for key in (LEADER_RATE, FOLLOWER_RATE):
                if existing.get(key) == rate_s \
                        and (b, key) not in self._set_broker_keys:
                    self._set_broker_keys.append((b, key))
        for pr in moving:
            leaders = ",".join(str(b) for b in pr.old_replicas)
            followers = ",".join(
                str(b) for b in pr.new_replicas if b not in pr.old_replicas
            )
            existing = self._describe("partition", pr.partition)
            for key, expect in ((LEADER_REPLICAS, leaders),
                                (FOLLOWER_REPLICAS, followers)):
                if expect and existing.get(key) == expect \
                        and (pr.partition, key) not in self._set_partition_keys:
                    self._set_partition_keys.append((pr.partition, key))

    def clear_throttles(self) -> None:
        """Remove only the configs this helper added."""
        for b, key in self._set_broker_keys:
            self._alter("broker", b, {key: None})
        for p, key in self._set_partition_keys:
            self._alter("partition", p, {key: None})
        self._set_broker_keys.clear()
        self._set_partition_keys.clear()
        self.backend.clear_throttles()

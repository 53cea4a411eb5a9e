"""Execution task machinery (upstream ``executor/ExecutionTask*.java``,
SURVEY.md §2.6): proposal → per-move tasks with a state machine, batching
under per-broker concurrency caps, and pluggable movement ordering."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set

from cruise_control_tpu_torch.analyzer.goal_optimizer import ExecutionProposal


class TaskState(enum.Enum):
    PENDING = "PENDING"
    IN_PROGRESS = "IN_PROGRESS"
    COMPLETED = "COMPLETED"
    ABORTING = "ABORTING"
    ABORTED = "ABORTED"
    DEAD = "DEAD"


class TaskType(enum.Enum):
    INTER_BROKER_REPLICA_ACTION = "INTER_BROKER_REPLICA_ACTION"
    LEADER_ACTION = "LEADER_ACTION"
    INTRA_BROKER_REPLICA_ACTION = "INTRA_BROKER_REPLICA_ACTION"


_VALID_TRANSITIONS = {
    TaskState.PENDING: {TaskState.IN_PROGRESS, TaskState.ABORTED},
    TaskState.IN_PROGRESS: {
        TaskState.COMPLETED,
        TaskState.ABORTING,
        TaskState.DEAD,
    },
    TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
    TaskState.COMPLETED: set(),
    TaskState.ABORTED: set(),
    TaskState.DEAD: set(),
}


@dataclasses.dataclass
class ExecutionTask:
    task_id: int
    task_type: TaskType
    proposal: ExecutionProposal
    state: TaskState = TaskState.PENDING
    started_tick: int = -1
    finished_tick: int = -1
    #: failed dispatches so far (retry-with-backoff accounting)
    attempts: int = 0
    #: drive-loop tick before which the task must not (re-)dispatch —
    #: the executor sets it to now + backoff when scheduling a retry
    next_eligible_tick: int = 0

    def transition(self, new_state: TaskState) -> None:
        if new_state not in _VALID_TRANSITIONS[self.state]:
            raise ValueError(f"illegal transition {self.state} -> {new_state}")
        self.state = new_state

    def retry(self, eligible_tick: int) -> None:
        """The one deliberate side-door past the state machine: a failed
        IN_PROGRESS task goes back to PENDING for a re-dispatch after
        ``eligible_tick`` (instead of terminally DEAD).  Only the
        executor's bounded retry path calls this."""
        if self.state is not TaskState.IN_PROGRESS:
            raise ValueError(f"cannot retry a task in state {self.state}")
        self.state = TaskState.PENDING
        self.next_eligible_tick = int(eligible_tick)

    @property
    def added_brokers(self) -> Set[int]:
        return set(self.proposal.new_replicas) - set(self.proposal.old_replicas)

    @property
    def removed_brokers(self) -> Set[int]:
        return set(self.proposal.old_replicas) - set(self.proposal.new_replicas)

    @property
    def participating_brokers(self) -> Set[int]:
        return self.added_brokers | self.removed_brokers


# ---------------------------------------------------------------------------------
# Movement strategies (upstream executor/strategy/*.java)
# ---------------------------------------------------------------------------------

class ReplicaMovementStrategy:
    """Orders pending inter-broker tasks; chainable like upstream.

    ``rank()`` is the strategy's discriminating key alone; ``sort_key()``
    appends the task-id tie-break.  Chains concatenate ranks so a later
    strategy genuinely breaks the earlier one's ties (the id would otherwise
    make every component key unique and the rest of the chain dead).
    """

    name = "BaseReplicaMovementStrategy"

    def rank(self, task: ExecutionTask, sizes: Dict[int, float],
             urp: Set[int]) -> tuple:
        return ()

    def sort_key(self, task: ExecutionTask, sizes: Dict[int, float],
                 urp: Set[int]) -> tuple:
        return self.rank(task, sizes, urp) + (task.task_id,)

    def order(
        self,
        tasks: Sequence[ExecutionTask],
        sizes: Dict[int, float],
        urp: Set[int],
    ) -> List[ExecutionTask]:
        return sorted(tasks, key=lambda t: self.sort_key(t, sizes, urp))


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    name = "PrioritizeLargeReplicaMovementStrategy"

    def rank(self, task, sizes, urp):
        return (-sizes.get(task.proposal.partition, 0.0),)


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    name = "PrioritizeSmallReplicaMovementStrategy"

    def rank(self, task, sizes, urp):
        return (sizes.get(task.proposal.partition, 0.0),)


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move healthy partitions first; under-replicated ones last."""

    name = "PostponeUrpReplicaMovementStrategy"

    def rank(self, task, sizes, urp):
        return (task.proposal.partition in urp,)


class PrioritizeMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    """Fix at/under-min-ISR partitions with offline replicas first."""

    name = "PrioritizeMinIsrWithOfflineReplicasStrategy"

    def rank(self, task, sizes, urp):
        return (task.proposal.partition not in urp,)


class ChainedReplicaMovementStrategy(ReplicaMovementStrategy):
    """Chain strategies: earlier strategies dominate, later ones break ties
    (upstream ``chain(...)`` on ReplicaMovementStrategy)."""

    def __init__(self, strategies: Sequence[ReplicaMovementStrategy]):
        self.strategies = list(strategies)
        self.name = "+".join(s.name for s in self.strategies)

    def rank(self, task, sizes, urp):
        return tuple(
            k for s in self.strategies for k in s.rank(task, sizes, urp)
        )


def strategy_by_name(name: str) -> Optional[ReplicaMovementStrategy]:
    """Resolve a strategy (or a ``+``-joined chain) from its recorded
    name — the execution checkpoint persists names, not instances.  None
    for unknown names (recovery falls back to the executor default)."""
    classes = {
        cls.name: cls
        for cls in (
            ReplicaMovementStrategy,
            PrioritizeLargeReplicaMovementStrategy,
            PrioritizeSmallReplicaMovementStrategy,
            PostponeUrpReplicaMovementStrategy,
            PrioritizeMinIsrWithOfflineReplicasStrategy,
        )
    }
    parts = name.split("+") if name else []
    if not parts or any(p not in classes for p in parts):
        return None
    if len(parts) == 1:
        return classes[parts[0]]()
    return ChainedReplicaMovementStrategy([classes[p]() for p in parts])


# ---------------------------------------------------------------------------------
# Planner (upstream ExecutionTaskPlanner)
# ---------------------------------------------------------------------------------

class ExecutionTaskPlanner:
    """Splits proposals into typed tasks and serves broker-cap-respecting
    batches in strategy order."""

    def __init__(
        self,
        strategy: Optional[ReplicaMovementStrategy] = None,
    ):
        self.strategy = strategy or ReplicaMovementStrategy()
        self._next_id = 0
        self.replica_tasks: List[ExecutionTask] = []
        self.leader_tasks: List[ExecutionTask] = []
        self.intra_tasks: List[ExecutionTask] = []

    def add_proposals(self, proposals: Sequence[ExecutionProposal]) -> None:
        for prop in proposals:
            if prop.has_replica_change:
                self.replica_tasks.append(
                    ExecutionTask(
                        self._next_id, TaskType.INTER_BROKER_REPLICA_ACTION, prop
                    )
                )
                self._next_id += 1
            if prop.has_leader_change:
                # leadership lands after the replica phase (the new leader may
                # be a replica that is still catching up during the move)
                self.leader_tasks.append(
                    ExecutionTask(self._next_id, TaskType.LEADER_ACTION, prop)
                )
                self._next_id += 1
            if prop.has_disk_move:
                self.intra_tasks.append(
                    ExecutionTask(
                        self._next_id, TaskType.INTRA_BROKER_REPLICA_ACTION, prop
                    )
                )
                self._next_id += 1

    def next_replica_batch(
        self,
        in_flight_per_broker: Dict[int, int],
        cap_per_broker: int,
        sizes: Dict[int, float],
        urp: Set[int],
        max_batch: int = 1 << 30,
        now_tick: int = 1 << 62,
    ) -> List[ExecutionTask]:
        """Pending tasks whose participating brokers all have spare slots.
        ``now_tick`` filters out retrying tasks still inside their backoff
        window (``next_eligible_tick``)."""
        budget = dict(in_flight_per_broker)
        batch: List[ExecutionTask] = []
        pending = [
            t for t in self.replica_tasks
            if t.state == TaskState.PENDING and t.next_eligible_tick <= now_tick
        ]
        for task in self.strategy.order(pending, sizes, urp):
            brokers = task.participating_brokers
            if any(budget.get(b, 0) >= cap_per_broker for b in brokers):
                continue
            for b in brokers:
                budget[b] = budget.get(b, 0) + 1
            batch.append(task)
            if len(batch) >= max_batch:
                break
        return batch

    def next_leader_batch(self, max_batch: int) -> List[ExecutionTask]:
        pending = [t for t in self.leader_tasks if t.state == TaskState.PENDING]
        return pending[:max_batch]

    def next_intra_batch(self, max_batch: int) -> List[ExecutionTask]:
        pending = [t for t in self.intra_tasks if t.state == TaskState.PENDING]
        return pending[:max_batch]

    @property
    def all_tasks(self) -> List[ExecutionTask]:
        return self.replica_tasks + self.leader_tasks + self.intra_tasks

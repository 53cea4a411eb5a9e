"""Executor — applies an optimizer plan to the cluster (upstream
``executor/Executor.java`` + ``ReplicationThrottleHelper`` +
``ConcurrencyAdjuster``; SURVEY.md §2.6, call stack §3.2 tail).

Single-writer by design (upstream's ``hasOngoingExecution`` guard): one
execution at a time; state machine NO_TASK_IN_PROGRESS → STARTING_EXECUTION →
*_IN_PROGRESS → (STOPPING_EXECUTION) → NO_TASK_IN_PROGRESS.  The drive loop is
tick-based against the :class:`ClusterBackend` seam, so tests and the
simulated cluster advance deterministically; a real-Kafka adapter polls on
wall-clock ticks instead.

Crash safety (docs/ARCHITECTURE.md "Execution recovery"): with an
:class:`~cruise_control_tpu_torch.executor.journal.ExecutionJournal` attached,
every state transition of the drive loop is checkpointed write-ahead —
batch dispatches BEFORE the backend call, task completions/deaths/retries
as they land — and :meth:`resume` reconciles a loaded checkpoint against
live backend state so a restarted process continues the execution instead
of orphaning it.  Failed tasks get bounded exponential-backoff retries
with deterministic jitter; destinations that keep failing are excluded
and re-planned around; a stuck-execution watchdog escalates stop → abort
→ ``execution.unrecoverable``.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Set

from cruise_control_tpu_torch.analyzer.goal_optimizer import ExecutionProposal
from cruise_control_tpu_torch.executor.backend import (
    ClusterBackend,
    FencedClusterBackend,
    StaleControllerEpochError,
)
from cruise_control_tpu_torch.executor.concurrency import ConcurrencyAdjuster
from cruise_control_tpu_torch.executor.journal import (
    ExecutionCheckpoint,
    ExecutionJournal,
    ProcessCrash,
    proposal_to_record,
)
from cruise_control_tpu_torch.executor.notifier import ExecutorNotifier
from cruise_control_tpu_torch.executor.tasks import (
    ExecutionTask,
    ExecutionTaskPlanner,
    ReplicaMovementStrategy,
    TaskState,
    TaskType,
    strategy_by_name,
)
from cruise_control_tpu_torch.executor.throttle import ReplicationThrottleHelper
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("executor")


class ExecutorStateValue(enum.Enum):
    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    )
    INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    )
    LEADER_MOVEMENT_TASK_IN_PROGRESS = "LEADER_MOVEMENT_TASK_IN_PROGRESS"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


@dataclasses.dataclass
class ExecutorConfig:
    """Upstream ExecutorConfig keys (SURVEY.md §5.6)."""

    num_concurrent_partition_movements_per_broker: int = 5
    num_concurrent_intra_broker_partition_movements: int = 2
    num_concurrent_leader_movements: int = 1000
    #: ticks an in-progress move may take before being declared DEAD
    task_timeout_ticks: int = 100
    #: replication throttle rate (bytes/s) applied during execution; None = off
    replication_throttle: Optional[float] = None
    #: adaptive concurrency (ConcurrencyAdjuster): AIMD between the floor and
    #: ceiling, reacting to under-replicated partitions not caused by the
    #: execution's own moves.  Off by default (upstream
    #: concurrency.adjuster.enabled=false) — the configured cap is then a
    #: hard limit.
    concurrency_adjuster_enabled: bool = False
    concurrency_adjuster_min_cap: int = 1
    #: None → 2× the configured per-broker cap
    concurrency_adjuster_max_cap: Optional[int] = None
    concurrency_adjuster_healthy_ticks: int = 3
    #: legacy coarse back-off: halve caps when URP count exceeds this
    concurrency_adjuster_urp_threshold: int = 1 << 30
    #: safety ceiling for one execution's total moves
    max_inter_broker_moves: int = 1 << 30
    #: wall-clock between progress checks for real (non-simulated) backends;
    #: the simulated backend advances per tick and ignores it
    progress_check_interval_ms: int = 10_000
    #: ExecutionResults retained in ``Executor.history`` (the unbounded
    #: list leaked on a long-running server; mirrors the task-log bound)
    history_retention: int = 64
    #: execution.task.retry.*: bounded re-dispatch of DEAD/timed-out moves
    #: with exponential backoff (base * 2^attempt, capped) plus a
    #: deterministic jitter; 0 attempts = upstream behavior (no retry)
    task_retry_max_attempts: int = 0
    task_retry_backoff_base_ticks: int = 2
    task_retry_backoff_max_ticks: int = 64
    task_retry_jitter_ticks: int = 1
    #: DEAD outcomes charged to a destination broker before it is excluded
    #: from further dispatches and re-planned around (0 disables)
    dest_exclusion_threshold: int = 3
    #: stuck-execution watchdog: after this many ticks without any task
    #: completing or dispatching, stop dispatching new batches; after twice
    #: this many, abort in-flight moves and journal
    #: ``execution.unrecoverable`` (0 disables)
    watchdog_stuck_ticks: int = 0
    #: execution.foreign.conflict.policy: what a planned task does when a
    #: FOREIGN reassignment (another controller / kafka-reassign-partitions)
    #: touches its partition mid-flight.  "yield": the task steps aside —
    #: postponed (pre-dispatch) or retried after backoff (in-flight) while
    #: the foreign move drains, cancelled ``foreign-conflict`` when the
    #: retry budget is spent.  "abort": the whole plan aborts partial-
    #: gracefully on first conflict.  Disjoint foreign moves are always
    #: tolerated (journaled + fed to the ConcurrencyAdjuster as external
    #: URPs).
    foreign_conflict_policy: str = "yield"
    #: ticks a yielded (pre-dispatch) task waits before re-checking its
    #: partition for foreign activity
    foreign_yield_backoff_ticks: int = 4
    #: per-batch topology revalidation: verify each task's preconditions
    #: against live metadata before its alterPartitionReassignments
    #: (partition exists, RF unchanged, no foreign move in flight) and
    #: cancel stale tasks with categorical reasons instead of burning the
    #: retry budget on generic replica-mismatch failures
    revalidate_preconditions: bool = True


@dataclasses.dataclass
class ExecutionResult:
    completed: int
    dead: int
    aborted: int
    ticks: int
    stopped: bool

    @property
    def succeeded(self) -> bool:
        return not self.stopped and self.dead == 0 and self.aborted == 0


class OngoingExecutionError(RuntimeError):
    pass


class Executor:
    """Drives proposals to completion against a backend."""

    def __init__(
        self,
        backend: ClusterBackend,
        config: Optional[ExecutorConfig] = None,
        notifier=None,
        default_strategy: Optional[ReplicaMovementStrategy] = None,
        journal: Optional[ExecutionJournal] = None,
    ):
        #: every mutating admin call goes through the fenced wrapper: it
        #: presents ``self.epoch`` to the cluster so a zombie process is
        #: refused at the seam (reads delegate straight through)
        self.backend = (
            backend if isinstance(backend, FencedClusterBackend)
            else FencedClusterBackend(backend, lambda: self.epoch)
        )
        self.config = config or ExecutorConfig()
        self.notifier = notifier
        #: default.replica.movement.strategies: ordering used when the caller
        #: passes no explicit strategy
        self.default_strategy = default_strategy
        #: write-ahead execution checkpoint (None = durability disabled)
        self.journal = journal
        self.state = ExecutorStateValue.NO_TASK_IN_PROGRESS
        self._stop_requested = False
        self.planner: Optional[ExecutionTaskPlanner] = None
        #: bounded execution-result history (a long-running server used to
        #: grow this list forever); readers snapshot via list(history)
        self.history: deque = deque(
            maxlen=max(1, self.config.history_retention)
        )
        #: monotonic execution counter (history is bounded, so len() no
        #: longer identifies an execution)
        self._execution_seq = 0
        #: bounded per-execution task log (the UI's execution-history
        #: drill-in: every move's terminal state; upstream exposes the same
        #: via ExecutorState verbose substates).  A plain LIST on purpose:
        #: state_summary() slices it from HTTP worker threads while the
        #: executor appends — list append/del/slice are single C-level ops
        #: under the GIL, where iterating a deque mid-append raises
        self.execution_log: List[dict] = []
        #: running completed-movements total — /state must not re-scan the
        #: unbounded history list on every 5 s UI poll
        self._finished_movements = 0
        self.adopted_at_startup: Set[int] = set()
        self.adjuster: Optional[ConcurrencyAdjuster] = None
        self.throttle_helper: Optional[ReplicationThrottleHelper] = None
        #: DEAD outcomes charged per destination broker (retry feedback)
        self._dest_failures: Dict[int, int] = {}
        #: destinations excluded after repeated failures; re-planned around
        self.excluded_destinations: Set[int] = set()
        self._retries_scheduled = 0
        #: last recovery outcome for /state (None = never recovered)
        self._last_recovery: Optional[dict] = None
        #: controller epoch this process holds (0 = never claimed); minted
        #: cluster-side per execution/resume, stamped on every checkpoint
        #: record, presented on every mutating backend call
        self.epoch = 0
        #: epoch recorded in the checkpoint recovery last loaded — the
        #: "ours vs foreign" discriminator for detect_ongoing_at_startup
        self.last_checkpoint_epoch: Optional[int] = None
        #: per-execution topology-drift / foreign-activity counters
        #: (surfaced in executor.end and /state)
        self._drift: Dict[str, int] = {
            "deleted": 0, "rfChanged": 0, "foreignConflict": 0,
            "foreignObserved": 0,
        }
        #: foreign partitions already journaled this execution (one
        #: executor.foreign_reassignment record per partition, not per tick)
        self._foreign_seen: Set[int] = set()
        #: plan-abort reason (foreign-conflict) — the stop path journals it
        self._abort_reason: Optional[str] = None
        #: lazily probed: does the backend expose reassignment_targets()?
        self._targets_supported: Optional[bool] = None

    # ---- public API -------------------------------------------------------------
    @property
    def has_ongoing_execution(self) -> bool:
        return self.state != ExecutorStateValue.NO_TASK_IN_PROGRESS

    def stop_execution(self) -> None:
        """Upstream STOP_PROPOSAL_EXECUTION endpoint."""
        if self.has_ongoing_execution:
            self._stop_requested = True

    def _cluster_epoch(self) -> Optional[int]:
        """The cluster-registered controller epoch, or None when the
        backend has no fencing capability."""
        probe = getattr(self.backend, "controller_epoch", None)
        if probe is None:
            return None
        try:
            return int(probe())
        except NotImplementedError:
            return None

    def detect_ongoing_at_startup(
        self, stop: bool = False, checkpoint_epoch: Optional[int] = None,
    ) -> Set[int]:
        """Upstream executor recovery (SURVEY.md §5.4c): on startup, detect
        reassignments already in flight in the cluster.  Returns the
        partitions involved.

        Ours vs foreign is decided by CHECKPOINT EPOCH MATCH, not arrival
        order: when the cluster-registered controller epoch still equals
        the epoch recorded in our execution checkpoint
        (``checkpoint_epoch``, defaulting to the last loaded checkpoint's),
        no other controller claimed the cluster since our previous
        instance died — the moves are OURS.  A higher cluster epoch means
        another controller took over: the moves are FOREIGN.  Without
        epoch information on either side the legacy arrival-order
        behavior applies.

        The adopt/stop matrix:

        * ours, ``stop=False`` → adopt and gate until drained;
        * ours, ``stop=True`` → cancel (they are ours to kill);
        * foreign, ``stop=True`` → REFUSED: cancelling a live
          controller's work starts a reassignment war — adopt/gate and
          journal ``executor.foreign_reassignment`` instead;
        * foreign, ``stop=False`` → adopt/gate + journal;
        * unknown epoch → legacy: ``stop`` cancels, otherwise adopt.

        Checkpoint-based recovery (:meth:`resume`) runs BEFORE this: moves
        belonging to a recovered checkpoint are ours, not foreign.
        """
        ongoing = set(self.backend.ongoing_reassignments())
        if not ongoing:
            self.adopted_at_startup = set()
            return ongoing
        if checkpoint_epoch is None:
            checkpoint_epoch = self.last_checkpoint_epoch
        cluster_epoch = self._cluster_epoch()
        known = (checkpoint_epoch is not None and checkpoint_epoch > 0
                 and cluster_epoch is not None)
        ours = known and cluster_epoch == checkpoint_epoch
        foreign = known and not ours
        if foreign:
            events.emit(
                "executor.foreign_reassignment", severity="WARNING",
                conflict=False, origin="startup",
                policy=self.config.foreign_conflict_policy,
                partitions=sorted(ongoing)[:200],
            )
        if stop and not foreign:
            # cancelling is a WRITE: take ownership first (conditionally,
            # when we know the checkpoint epoch — the CAS proves nobody
            # else claimed the cluster between the epoch check above and
            # this cancel)
            self._claim_epoch(expected=checkpoint_epoch if ours else None)
            # probe support first so a method that EXISTS but raises (a real
            # backend bug, possibly AttributeError internally) still
            # propagates instead of being mistaken for "unsupported"
            cancel = getattr(self.backend, "cancel_reassignments", None)
            unsupported = cancel is None
            if not unsupported:
                try:
                    cancel(ongoing)
                except NotImplementedError:
                    unsupported = True
            if unsupported:
                # a minimal adapter may not support cancellation; leave the
                # reassignments to finish under the cluster's own control
                self.adopted_at_startup = ongoing
                return ongoing
            # cancelled work is not in flight: nothing to adopt or gate on
            self.adopted_at_startup = set()
            return ongoing
        self.adopted_at_startup = ongoing
        return ongoing

    def execute_proposals(
        self,
        proposals: Sequence[ExecutionProposal],
        strategy: Optional[ReplicaMovementStrategy] = None,
        partition_sizes: Optional[Dict[int, float]] = None,
        max_ticks: int = 10_000,
    ) -> ExecutionResult:
        """Run a plan to completion (or stop/abort).  Synchronous drive loop;
        async task submission lives in the server layer (UserTaskManager)."""
        if self.has_ongoing_execution:
            raise OngoingExecutionError("an execution is already in progress")
        if self.adopted_at_startup:
            # reassignments adopted from a previous instance: issuing a new
            # plan could produce conflicting targets for the same partitions;
            # refuse until the adopted set drains (refreshed live, so callers
            # can simply retry)
            self.adopted_at_startup &= set(self.backend.ongoing_reassignments())
            if self.adopted_at_startup:
                raise OngoingExecutionError(
                    "reassignments adopted at startup are still in flight: "
                    f"{sorted(self.adopted_at_startup)}"
                )
        self.state = ExecutorStateValue.STARTING_EXECUTION
        self._stop_requested = False
        self._reset_drift()
        # take ownership: mint a fresh controller epoch cluster-side (any
        # other controller still writing is fenced at its next call)
        self._claim_epoch()
        sizes = partition_sizes or {}
        planner = ExecutionTaskPlanner(strategy or self.default_strategy)
        planner.add_proposals(proposals)
        self._execution_seq += 1
        execution_id = self._execution_seq
        LOG.info(
            "execution starting: %d proposals -> %d replica / %d leadership "
            "/ %d intra-broker tasks (strategy=%s)",
            len(proposals), len(planner.replica_tasks),
            len(planner.leader_tasks), len(planner.intra_tasks),
            planner.strategy.name,
        )
        events.emit(
            "executor.start", numProposals=len(proposals),
            executionId=execution_id,
            replicaTasks=len(planner.replica_tasks),
            leaderTasks=len(planner.leader_tasks),
            intraTasks=len(planner.intra_tasks),
            strategy=planner.strategy.name,
        )
        # write-ahead: the full approved plan reaches the checkpoint before
        # anything touches the cluster
        self._jwrite(
            "start",
            executionId=execution_id,
            strategy=planner.strategy.name,
            maxTicks=max_ticks,
            proposals=[proposal_to_record(p) for p in proposals],
            sizes={int(k): float(v) for k, v in sizes.items()},
            config={
                "taskTimeoutTicks": self.config.task_timeout_ticks,
                "retryMaxAttempts": self.config.task_retry_max_attempts,
                "retryBackoffBaseTicks":
                    self.config.task_retry_backoff_base_ticks,
                "retryBackoffMaxTicks":
                    self.config.task_retry_backoff_max_ticks,
                "retryJitterTicks": self.config.task_retry_jitter_ticks,
                "destExclusionThreshold":
                    self.config.dest_exclusion_threshold,
                "watchdogStuckTicks": self.config.watchdog_stuck_ticks,
                "perBrokerCap":
                    self.config.num_concurrent_partition_movements_per_broker,
            },
        )
        # safety ceiling: replica moves beyond the cap are aborted up front
        # (in strategy order, so the cap keeps the highest-priority moves),
        # and the result reports a partial execution instead of ignoring it
        ordered = planner.strategy.order(
            planner.replica_tasks, sizes,
            self.backend.under_replicated_partitions(),
        )
        for t in ordered[self.config.max_inter_broker_moves:]:
            t.transition(TaskState.ABORTED)
            self._jwrite("task", taskId=t.task_id,
                         partition=t.proposal.partition, state="ABORTED",
                         reason="move-ceiling")
        return self._drive_to_completion(
            planner, sizes, max_ticks, len(proposals), execution_id,
        )

    def resume(self, checkpoint: ExecutionCheckpoint) -> ExecutionResult:
        """Adopt a loaded checkpoint: reconcile it against live backend
        state — moves that completed while we were down become COMPLETED,
        vanished destinations are re-planned, still-in-flight or
        never-dispatched moves are (re-)issued — then drive the remainder
        to completion under the checkpointed budget."""
        if self.has_ongoing_execution:
            raise OngoingExecutionError("an execution is already in progress")
        self.last_checkpoint_epoch = checkpoint.epoch
        # conditional claim (CAS on the checkpoint's recorded epoch): a
        # zombie resuming a checkpoint a newer process already took over
        # is refused HERE — before any reconciliation mutation — with
        # executor.fenced journaled by the wrapper
        self._claim_epoch(
            expected=checkpoint.epoch if checkpoint.epoch > 0 else None
        )
        self.state = ExecutorStateValue.STARTING_EXECUTION
        self._stop_requested = False
        self._reset_drift()
        if self.journal is not None:
            # the restarted process owns the checkpoint again
            self.journal.thaw()
        planner, recon = self._reconcile(checkpoint)
        self._execution_seq = max(self._execution_seq,
                                  checkpoint.execution_id)
        self._last_recovery = {
            "executionId": checkpoint.execution_id,
            "alreadyCompleted": len(recon["completed_prior"]),
            "completedWhileDown": len(recon["completed_down"]),
            "adopted": len(recon["adopted"]),
            "reissued": len(recon["reissued"]),
            "replanned": len(recon["replanned"]),
            "aborted": len(recon["aborted"]),
        }
        LOG.warning(
            "resuming execution %d from checkpoint: %d already completed, "
            "%d completed while down, %d adopted, %d reissued, "
            "%d replanned, %d aborted",
            checkpoint.execution_id, *[
                len(recon[k]) for k in (
                    "completed_prior", "completed_down", "adopted",
                    "reissued", "replanned", "aborted")
            ],
        )
        # the recovery story, journal-readable: which partitions must NOT
        # be re-moved (alreadyCompleted/completedWhileDown) and what the
        # reconciliation decided for the rest (lists capped like the
        # execution log's task drill-in)
        events.emit(
            "executor.resume", severity="WARNING",
            executionId=checkpoint.execution_id,
            phase=checkpoint.phase,
            alreadyCompleted=recon["completed_prior"][:200],
            completedWhileDown=recon["completed_down"][:200],
            adopted=recon["adopted"][:200],
            reissued=recon["reissued"][:200],
            replanned=recon["replanned"][:200],
            aborted=recon["aborted"][:200],
        )
        self._jwrite(
            "resume", executionId=checkpoint.execution_id,
            checkpointEpoch=checkpoint.epoch, claimedEpoch=self.epoch,
            completedPrior=len(recon["completed_prior"]),
            completedWhileDown=len(recon["completed_down"]),
            adopted=len(recon["adopted"]),
            reissued=len(recon["reissued"]),
            replanned=len(recon["replanned"]),
            aborted=len(recon["aborted"]),
        )
        orphaned_rate = None
        if (checkpoint.throttle or {}).get("state") in ("set", "adopted"):
            # the dead run crashed between set_throttles and cleanup: its
            # orphaned throttle configs must be re-scoped (adopted) so the
            # resumed execution's cleanup clears them
            orphaned_rate = float(checkpoint.throttle.get("rate") or 0.0)
        return self._drive_to_completion(
            planner, checkpoint.sizes, checkpoint.max_ticks,
            len(checkpoint.proposals), checkpoint.execution_id,
            resumed=True, orphaned_throttle_rate=orphaned_rate,
        )

    def _reconcile(self, checkpoint: ExecutionCheckpoint):
        """Checkpoint × live cluster → a planner holding the truth.

        Reconciliation rules, per replica task (docs/ARCHITECTURE.md):

        1. recorded terminal (COMPLETED/DEAD/ABORTED) → preserved verbatim;
        2. live placement already equals the planned replicas → COMPLETED
           (the move finished while we were down — never re-moved);
        3. a destination broker vanished (dead/degraded/excluded) → the
           proposal is re-planned onto live brokers, or ABORTED when none
           qualify;
        4. otherwise → PENDING: still-in-flight reassignments are re-issued
           (``alterPartitionReassignments`` is idempotent toward the same
           target; a new target cancels the stale one), never-dispatched
           ones dispatch normally.

        Leadership/intra-broker tasks are cheap and idempotent: recorded
        terminal states are preserved, the rest simply re-run.
        """
        strategy = strategy_by_name(checkpoint.strategy) \
            or self.default_strategy
        planner = ExecutionTaskPlanner(strategy)
        planner.add_proposals(checkpoint.proposals)
        by_id = {t.task_id: t for t in planner.all_tasks}
        # recorded re-planned destinations apply before any comparison
        for tid, rec in checkpoint.tasks.items():
            t = by_id.get(tid)
            new_reps = rec.get("newReplicas")
            if (t is not None and new_reps
                    and t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION):
                self._swap_proposal(
                    planner, t,
                    dataclasses.replace(t.proposal,
                                        new_replicas=tuple(new_reps)),
                )
        recon = {k: [] for k in ("completed_prior", "completed_down",
                                 "adopted", "reissued", "replanned",
                                 "aborted")}
        alive = self.backend.alive_brokers()
        ongoing = set(self.backend.ongoing_reassignments())
        for t in planner.all_tasks:
            rec = checkpoint.tasks.get(t.task_id, {})
            recorded = rec.get("state", "PENDING")
            t.attempts = int(rec.get("attempts", 0))
            p = t.proposal.partition
            if recorded in ("COMPLETED", "ABORTED", "DEAD"):
                # terminal before the crash: the checkpoint is authoritative
                # (direct assignment on purpose — transition() guards the
                # live drive loop, not checkpoint replay)
                t.state = TaskState[recorded]
                if (recorded == "COMPLETED"
                        and t.task_type
                        == TaskType.INTER_BROKER_REPLICA_ACTION):
                    recon["completed_prior"].append(p)
                continue
            if t.task_type != TaskType.INTER_BROKER_REPLICA_ACTION:
                continue  # leadership/intra: re-run from PENDING
            try:
                st = self.backend.partition_state(p)
            except KeyError:
                t.state = TaskState.ABORTED
                recon["aborted"].append(p)
                continue
            if list(st.replicas) == list(t.proposal.new_replicas):
                t.state = TaskState.COMPLETED
                recon["completed_down"].append(p)
                continue
            if any(b not in alive for b in t.added_brokers):
                if p in ongoing:
                    # clear the stale reassignment first: the dead
                    # destination's abandoned catch-up must not pollute
                    # the re-planned target on a minimal backend
                    cancel = getattr(self.backend, "cancel_reassignments",
                                     None)
                    if cancel is not None:
                        try:
                            cancel([p])
                        except NotImplementedError:
                            pass
                if self._replan_destinations(planner, t, include_dead=True):
                    recon["replanned"].append(p)
                else:
                    t.state = TaskState.ABORTED
                    recon["aborted"].append(p)
                    self._jwrite("task", taskId=t.task_id, partition=p,
                                 state="ABORTED", reason="no-destination")
                continue
            recon["adopted" if p in ongoing else "reissued"].append(p)
        for v in recon.values():
            v.sort()
        return planner, recon

    def _drive_to_completion(
        self,
        planner: ExecutionTaskPlanner,
        sizes: Dict[int, float],
        max_ticks: int,
        num_proposals: int,
        execution_id: int,
        resumed: bool = False,
        orphaned_throttle_rate: Optional[float] = None,
    ) -> ExecutionResult:
        self.planner = planner
        if (self.config.replication_throttle is not None
                or orphaned_throttle_rate is not None):
            self.throttle_helper = ReplicationThrottleHelper(
                self.backend,
                self.config.replication_throttle
                if self.config.replication_throttle is not None
                else orphaned_throttle_rate,
            )
            if orphaned_throttle_rate is not None:
                # value-matched re-scoping of the dead run's orphans: the
                # cleanup below now owns (and will clear) them
                self.throttle_helper.adopt_existing(
                    [t.proposal for t in planner.replica_tasks],
                    rate=orphaned_throttle_rate,
                )
                self._jwrite("throttle", state="adopted",
                             rate=orphaned_throttle_rate)
            if self.config.replication_throttle is not None:
                # write-ahead: the record gates the dynamic-config writes
                # (a crash right after them must leave a recoverable
                # trace — value-matched adoption makes the record safe
                # even when the crash landed BEFORE the cluster call)
                self._jwrite("throttle", state="set",
                             rate=self.config.replication_throttle)
                self.throttle_helper.set_throttles(
                    [
                        t.proposal
                        for t in planner.replica_tasks
                        if t.state == TaskState.PENDING
                    ]
                )
        if self.config.concurrency_adjuster_enabled:
            self.adjuster = ConcurrencyAdjuster(
                initial_cap=(
                    self.config.num_concurrent_partition_movements_per_broker
                ),
                min_cap=self.config.concurrency_adjuster_min_cap,
                max_cap=self.config.concurrency_adjuster_max_cap,
                healthy_ticks_before_increase=(
                    self.config.concurrency_adjuster_healthy_ticks
                ),
            )

        from cruise_control_tpu_torch.telemetry import tracing

        ticks = 0
        crashed = False
        fenced = False
        try:
            with tracing.span("executor.execute") as sp:
                sp.set("proposals", num_proposals)
                with tracing.span("executor.replica_moves"):
                    ticks = self._drive_replica_moves(
                        planner, sizes, max_ticks
                    )
                if not self._stop_requested:
                    with tracing.span("executor.leader_moves"):
                        self._drive_leader_moves(planner)
                if not self._stop_requested:
                    with tracing.span("executor.intra_moves"):
                        self._drive_intra_moves(planner)
        except ProcessCrash:
            # simulated process death (chaos tests): a real crash executes
            # nothing past this point, so every cleanup side effect below
            # is skipped — the checkpoint and event journal must reflect
            # exactly what a dead process left behind
            crashed = True
            raise
        except StaleControllerEpochError:
            # fenced mid-drive: another controller owns the cluster now.
            # The wrapper already journaled executor.fenced; everything
            # non-terminal aborts WITHOUT touching the cluster (cancel or
            # throttle-clear calls would just be fenced again) and the
            # error propagates — refused loudly, never double-moved.
            fenced = True
            raise
        finally:
            if not crashed:
                if self.throttle_helper is not None:
                    if not fenced:
                        self.throttle_helper.clear_throttles()
                        self._jwrite("throttle", state="cleared")
                    self.throttle_helper = None
                if fenced:
                    for t in planner.all_tasks:
                        if t.state == TaskState.PENDING:
                            t.transition(TaskState.ABORTED)
                        elif t.state == TaskState.IN_PROGRESS:
                            t.transition(TaskState.ABORTING)
                            t.transition(TaskState.ABORTED)
                        elif t.state == TaskState.ABORTING:
                            t.transition(TaskState.ABORTED)
                completed = sum(
                    1 for t in planner.all_tasks
                    if t.state == TaskState.COMPLETED
                )
                dead = sum(
                    1 for t in planner.all_tasks if t.state == TaskState.DEAD
                )
                aborted = sum(
                    1 for t in planner.all_tasks
                    if t.state == TaskState.ABORTED
                )
                result = ExecutionResult(
                    completed=completed,
                    dead=dead,
                    aborted=aborted,
                    ticks=ticks,
                    stopped=self._stop_requested,
                )
                self.history.append(result)
                self._finished_movements += completed
                # topology-drift / foreign-activity summary: only present
                # when something actually drifted, so clean executions'
                # journal records (and pinned fingerprints) stay byte-stable
                drift = {k: v for k, v in self._drift.items() if v}
                drift_fields = {"topologyDrift": drift} if drift else {}
                if fenced:
                    drift_fields["fenced"] = True
                self.execution_log.append({
                    "executionId": execution_id,
                    "endedS": round(time.time(), 1),
                    "strategy": planner.strategy.name,
                    "numProposals": num_proposals,
                    "resumed": resumed,
                    **drift_fields,
                    **dataclasses.asdict(result),
                    # per-move drill-in, bounded: terminal state of each task
                    "tasks": [
                        {
                            "taskId": t.task_id,
                            "type": t.task_type.value,
                            "partition": t.proposal.partition,
                            "state": t.state.value,
                            "from": sorted(t.removed_brokers),
                            "to": sorted(t.added_brokers),
                            "startedTick": t.started_tick,
                            "finishedTick": t.finished_tick,
                            "attempts": t.attempts,
                        }
                        for t in planner.all_tasks[:200]
                    ],
                })
                if len(self.execution_log) > 8:
                    del self.execution_log[0]
                self.state = ExecutorStateValue.NO_TASK_IN_PROGRESS
                log = LOG.warning if (dead or result.stopped) else LOG.info
                log(
                    "execution finished: %d completed / %d dead / %d aborted "
                    "in %d ticks%s", completed, dead, aborted, ticks,
                    " (STOPPED)" if result.stopped else "",
                )
                events.emit(
                    "executor.end",
                    severity="WARNING" if (dead or result.stopped) else "INFO",
                    executionId=execution_id, completed=completed,
                    dead=dead, aborted=aborted, ticks=ticks,
                    stopped=result.stopped, resumed=resumed,
                    **drift_fields,
                )
                # terminal checkpoint record; the journal truncates itself —
                # a finished execution needs no recovery state
                self._jwrite(
                    "end", executionId=execution_id, completed=completed,
                    dead=dead, aborted=aborted, ticks=ticks,
                    stopped=result.stopped, resumed=resumed,
                    **drift_fields,
                )
                self._notify(result)
        return result

    def _reset_drift(self) -> None:
        self._drift = {
            "deleted": 0, "rfChanged": 0, "foreignConflict": 0,
            "foreignObserved": 0,
        }
        self._foreign_seen = set()
        self._abort_reason = None

    def _claim_epoch(self, expected: Optional[int] = None) -> int:
        """Mint this process's controller epoch.  With ``expected`` the
        claim is CAS-conditional (resume path) and StaleControllerEpochError
        propagates; backends without fencing fall back to a local
        monotonic counter (single-writer-by-assumption, as before)."""
        claimed = self.backend.claim(expected) \
            if isinstance(self.backend, FencedClusterBackend) else None
        if claimed is None:
            claimed = max(self.epoch, expected or 0) + 1
        self.epoch = claimed
        if self.journal is not None:
            self.journal.set_epoch(claimed)
        return claimed

    def _jwrite(self, kind: str, **payload) -> None:
        """Checkpoint write-through.  ProcessCrash (armed crash injection)
        propagates by design; the journal swallows real IO errors itself."""
        if self.journal is not None:
            self.journal.append(kind, **payload)

    def _notify(self, result: ExecutionResult) -> None:
        if self.notifier is None:
            return
        if isinstance(self.notifier, ExecutorNotifier):
            if result.stopped:
                self.notifier.on_execution_stopped(result)
            else:
                self.notifier.on_execution_finished(result)
        else:  # plain callable hook
            self.notifier(result)

    # ---- retry / re-planning ----------------------------------------------------
    def _swap_proposal(self, planner: ExecutionTaskPlanner,
                       task: ExecutionTask,
                       proposal: ExecutionProposal) -> None:
        """Replace a task's proposal, keeping the sibling leadership task
        (built from the same proposal object) consistent."""
        old = task.proposal
        task.proposal = proposal
        for lt in planner.leader_tasks:
            if lt.proposal is old:
                lt.proposal = proposal

    def _replan_destinations(self, planner: ExecutionTaskPlanner,
                             task: ExecutionTask,
                             include_dead: bool = False) -> bool:
        """Re-target a move whose destinations are excluded (or, with
        ``include_dead``, vanished): each bad destination is replaced by
        the lowest-id live, non-excluded broker not already used.  A
        placement-preserving fallback, not a goal-checked plan — the
        detector's goal machinery re-balances later if needed."""
        degraded: Set[int] = set()
        deg = getattr(self.backend, "degraded_brokers", None)
        if deg is not None:
            degraded = set(deg())
        if not include_dead and not self.excluded_destinations \
                and not degraded:
            return True  # the common fast path: nothing to route around
        alive = self.backend.alive_brokers()
        bad = {
            b for b in task.added_brokers
            if b in self.excluded_destinations or b in degraded
            or (include_dead and b not in alive)
        }
        if not bad:
            return True
        keep = [b for b in task.proposal.new_replicas if b not in bad]
        candidates = sorted(
            alive - self.excluded_destinations - degraded - set(keep) - bad
        )
        replacement: Dict[int, int] = {}
        new_replicas: List[int] = []
        for b in task.proposal.new_replicas:
            if b in bad:
                if not candidates:
                    return False
                replacement[b] = candidates.pop(0)
                new_replicas.append(replacement[b])
            else:
                new_replicas.append(b)
        new_leader = replacement.get(task.proposal.new_leader,
                                     task.proposal.new_leader)
        self._swap_proposal(planner, task, dataclasses.replace(
            task.proposal, new_replicas=tuple(new_replicas),
            new_leader=new_leader,
        ))
        events.emit(
            "executor.task_replanned", severity="WARNING",
            taskId=task.task_id, partition=task.proposal.partition,
            replaced={str(k): v for k, v in sorted(replacement.items())},
            newReplicas=list(new_replicas),
        )
        self._jwrite("task", taskId=task.task_id,
                     partition=task.proposal.partition, state="PENDING",
                     attempts=task.attempts,
                     newReplicas=list(new_replicas))
        return True

    def _ensure_destinations(self, planner: ExecutionTaskPlanner,
                             task: ExecutionTask) -> bool:
        """Pre-dispatch gate: re-plan around excluded/degraded
        destinations; abort the task when nowhere is left to place it."""
        if self._replan_destinations(planner, task):
            return True
        task.transition(TaskState.ABORTED)
        events.emit(
            "executor.task_dead", severity="WARNING", taskId=task.task_id,
            partition=task.proposal.partition, reason="no-destination",
        )
        self._jwrite("task", taskId=task.task_id,
                     partition=task.proposal.partition, state="ABORTED",
                     reason="no-destination")
        return False

    def _fail_task(self, t: ExecutionTask, reason: str, ticks: int,
                   extra: Optional[dict] = None) -> None:
        """A move failed (timeout / replica mismatch): charge its
        destinations, then either schedule a bounded backoff retry or
        declare it DEAD."""
        p = t.proposal.partition
        for b in sorted(t.added_brokers):
            n = self._dest_failures.get(b, 0) + 1
            self._dest_failures[b] = n
            if (0 < self.config.dest_exclusion_threshold <= n
                    and b not in self.excluded_destinations):
                self.excluded_destinations.add(b)
                events.emit("executor.dest_excluded", severity="WARNING",
                            broker=b, failures=n)
        if (t.attempts < self.config.task_retry_max_attempts
                and not self._stop_requested):
            # clear the stale reassignment so the retry re-issues cleanly
            cancel = getattr(self.backend, "cancel_reassignments", None)
            if cancel is not None:
                try:
                    cancel([p])
                except NotImplementedError:
                    pass
            backoff = min(
                self.config.task_retry_backoff_base_ticks
                * (1 << t.attempts),
                self.config.task_retry_backoff_max_ticks,
            )
            jitter = 0
            if self.config.task_retry_jitter_ticks > 0:
                # deterministic decorrelation: no RNG (the chaos
                # fingerprints depend on same-plan → same-schedule), but
                # different tasks/attempts spread across the window
                jitter = (t.task_id * 1103515245 + t.attempts * 12345) % (
                    self.config.task_retry_jitter_ticks + 1
                )
            t.attempts += 1
            t.retry(eligible_tick=ticks + backoff + jitter)
            self._retries_scheduled += 1
            LOG.warning(
                "task %d (partition %d) failed (%s): retry %d/%d in %d "
                "ticks", t.task_id, p, reason, t.attempts,
                self.config.task_retry_max_attempts, backoff + jitter,
            )
            events.emit(
                "executor.task_retry", severity="WARNING",
                taskId=t.task_id, partition=p, reason=reason,
                attempt=t.attempts,
                maxAttempts=self.config.task_retry_max_attempts,
                backoffTicks=backoff + jitter, **(extra or {}),
            )
            self._jwrite("task", taskId=t.task_id, partition=p,
                         state="PENDING", attempts=t.attempts, tick=ticks,
                         reason=reason)
            return
        LOG.warning(
            "task %d (partition %d) DEAD: %s (attempts=%d)",
            t.task_id, p, reason, t.attempts,
        )
        events.emit(
            "executor.task_dead", severity="WARNING",
            taskId=t.task_id, partition=p, reason=reason,
            attempts=t.attempts, **(extra or {}),
        )
        t.transition(TaskState.DEAD)
        t.finished_tick = ticks
        self._jwrite("task", taskId=t.task_id, partition=p, state="DEAD",
                     tick=ticks, attempts=t.attempts, reason=reason)

    # ---- foreign reassignments + topology drift ---------------------------------
    def _reassignment_targets(self) -> Optional[Dict[int, List[int]]]:
        """partition → target replicas of in-flight reassignments, or None
        when the backend can't say (foreign-conflict detection then
        degrades to mismatch-only)."""
        if self._targets_supported is False:
            return None
        probe = getattr(self.backend, "reassignment_targets", None)
        if probe is None:
            self._targets_supported = False
            return None
        try:
            targets = probe()
        except NotImplementedError:
            self._targets_supported = False
            return None
        self._targets_supported = True
        return targets

    def _note_foreign(self, partitions, conflict: bool, origin: str) -> None:
        """Journal newly sighted foreign partitions (one record per
        partition per execution, not per tick) and bump the drift
        counters."""
        new = [p for p in sorted(partitions) if p not in self._foreign_seen]
        if not new:
            return
        self._foreign_seen.update(new)
        key = "foreignConflict" if conflict else "foreignObserved"
        self._drift[key] += len(new)
        events.emit(
            "executor.foreign_reassignment", severity="WARNING",
            conflict=conflict, origin=origin,
            policy=self.config.foreign_conflict_policy,
            partitions=new[:200],
        )

    def _cancel_drift(self, t: ExecutionTask, ticks: int, reason: str,
                      counter: Optional[str] = None) -> None:
        """Cancel a stale task with a categorical topology-drift reason
        (the plan completes partial-gracefully around it).  ``counter``
        is None when the sighting was already counted (foreign dedup)."""
        if t.state == TaskState.IN_PROGRESS:
            t.transition(TaskState.ABORTING)
        t.transition(TaskState.ABORTED)
        t.finished_tick = ticks
        if counter is not None:
            self._drift[counter] += 1
        events.emit(
            "executor.topology_drift", severity="WARNING",
            taskId=t.task_id, partition=t.proposal.partition, reason=reason,
        )
        self._jwrite("task", taskId=t.task_id,
                     partition=t.proposal.partition, state="ABORTED",
                     tick=ticks, reason=reason)

    def _handle_conflict(self, t: ExecutionTask, ticks: int,
                         origin: str, in_progress: bool) -> None:
        """A FOREIGN reassignment touched a planned task's partition.
        Policy "yield": step aside — pre-dispatch tasks postpone, in-flight
        ones retry after backoff (the foreign move owns the partition; our
        retry re-issues once it drains) or cancel ``foreign-conflict``
        when the budget is spent.  Policy "abort": the whole plan aborts
        partial-gracefully."""
        p = t.proposal.partition
        self._note_foreign([p], conflict=True, origin=origin)
        policy = self.config.foreign_conflict_policy
        if policy == "abort":
            self._abort_reason = "foreign-conflict"
            self._stop_requested = True
            if in_progress:
                t.transition(TaskState.ABORTING)
                t.transition(TaskState.ABORTED)
                t.finished_tick = ticks
                self._jwrite("task", taskId=t.task_id, partition=p,
                             state="ABORTED", tick=ticks,
                             reason="foreign-conflict")
            return
        if not in_progress:
            # pre-dispatch yield: re-check once the backoff elapses (the
            # foreign move usually drains long before)
            t.next_eligible_tick = \
                ticks + self.config.foreign_yield_backoff_ticks
            return
        if (t.attempts < self.config.task_retry_max_attempts
                and not self._stop_requested):
            # yield/retry: do NOT cancel — the foreign controller owns the
            # reassignment now; our retry re-issues our target after it
            # drains (revalidation keeps postponing while it hasn't)
            backoff = min(
                self.config.task_retry_backoff_base_ticks
                * (1 << t.attempts),
                self.config.task_retry_backoff_max_ticks,
            )
            t.attempts += 1
            t.retry(eligible_tick=ticks + backoff)
            self._retries_scheduled += 1
            events.emit(
                "executor.task_retry", severity="WARNING",
                taskId=t.task_id, partition=p, reason="foreign-conflict",
                attempt=t.attempts,
                maxAttempts=self.config.task_retry_max_attempts,
                backoffTicks=backoff,
            )
            self._jwrite("task", taskId=t.task_id, partition=p,
                         state="PENDING", attempts=t.attempts, tick=ticks,
                         reason="foreign-conflict")
            return
        self._cancel_drift(t, ticks, "foreign-conflict")

    def _revalidate_task(self, t: ExecutionTask, ticks: int,
                         ongoing: Set[int], alive: Set[int],
                         targets: Optional[Dict[int, List[int]]]) -> bool:
        """Per-batch precondition revalidation: verify the task against
        LIVE metadata right before its alterPartitionReassignments.
        Topics created/deleted/RF-changed mid-execution used to fail as
        generic replica-mismatch retries that could burn the whole
        backoff budget; stale tasks now cancel with categorical reasons
        and the plan completes partial-gracefully."""
        p = t.proposal.partition
        try:
            st = self.backend.partition_state(p)
        except KeyError:
            self._cancel_drift(t, ticks, "topology-drift:deleted", "deleted")
            return False
        if p in ongoing and targets is not None:
            tgt = targets.get(p)
            if tgt is not None and list(tgt) != list(t.proposal.new_replicas):
                # someone else is moving this partition RIGHT NOW (our own
                # resumed re-issues match the planned target and pass)
                self._handle_conflict(t, ticks, origin="pre-dispatch",
                                      in_progress=False)
                return False
        if len(st.replicas) not in (len(t.proposal.old_replicas),
                                    len(t.proposal.new_replicas)) \
                and p not in ongoing:
            # the partition's RF changed under the plan (external RF bump
            # or shrink): the planned replica set no longer means what the
            # optimizer computed
            self._cancel_drift(t, ticks, "topology-drift:rf-changed",
                               "rfChanged")
            return False
        if not set(st.replicas) & alive:
            # no live source replica to copy from: postpone rather than
            # burn the dispatch (the hosting broker may come back)
            t.next_eligible_tick = \
                ticks + self.config.foreign_yield_backoff_ticks
            return False
        return True

    # ---- drive loops ------------------------------------------------------------
    def _caps(self, in_flight: Optional[Set[int]] = None) -> int:
        cap = self.config.num_concurrent_partition_movements_per_broker
        urp = self.backend.under_replicated_partitions()
        if self.adjuster is not None:
            # URPs the execution itself created don't count as stress
            external = urp - (in_flight or set())
            cap = self.adjuster.observe(external)
        if len(urp) > self.config.concurrency_adjuster_urp_threshold:
            cap = max(1, cap // 2)  # legacy coarse back-off
        return cap

    def _abort_pending_replicas(self, planner: ExecutionTaskPlanner,
                                reason: str) -> None:
        for t in planner.replica_tasks:
            if t.state == TaskState.PENDING:
                t.transition(TaskState.ABORTED)
                self._jwrite("task", taskId=t.task_id,
                             partition=t.proposal.partition,
                             state="ABORTED", reason=reason)

    def _drive_replica_moves(
        self, planner: ExecutionTaskPlanner, sizes: Dict[int, float], max_ticks: int
    ) -> int:
        self.state = (
            ExecutorStateValue.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
        )
        events.emit(
            "executor.phase", phase="replica_moves",
            pending=sum(1 for t in planner.replica_tasks
                        if t.state == TaskState.PENDING),
        )
        self._jwrite("phase", phase="replica_moves")
        in_flight: Dict[int, ExecutionTask] = {}
        in_flight_per_broker: Dict[int, int] = {}
        ticks = 0
        watchdog = self.config.watchdog_stuck_ticks
        last_progress_tick = 0
        halted = False  # watchdog stage 1: no new dispatches
        while ticks < max_ticks:
            if self._stop_requested:
                self.state = ExecutorStateValue.STOPPING_EXECUTION
                stop_reason = self._abort_reason or "stopped"
                for t in planner.replica_tasks:
                    if t.state == TaskState.PENDING:
                        t.transition(TaskState.ABORTED)
                        self._jwrite("task", taskId=t.task_id,
                                     partition=t.proposal.partition,
                                     state="ABORTED", reason=stop_reason)
                    elif t.state == TaskState.IN_PROGRESS:
                        t.transition(TaskState.ABORTING)
                        t.transition(TaskState.ABORTED)
                        self._jwrite("task", taskId=t.task_id,
                                     partition=t.proposal.partition,
                                     state="ABORTED", reason=stop_reason)
                return ticks
            batch = [] if halted else planner.next_replica_batch(
                in_flight_per_broker,
                self._caps(set(in_flight)),
                sizes,
                self.backend.under_replicated_partitions(),
                now_tick=ticks,
            )
            if batch:
                # excluded/degraded destinations are re-planned (or the
                # task aborted) before anything reaches the cluster
                batch = [
                    t for t in batch if self._ensure_destinations(planner, t)
                ]
            if batch and self.config.revalidate_preconditions:
                # per-batch precondition revalidation against LIVE
                # metadata: deleted/RF-drifted partitions cancel with
                # categorical reasons, foreign-conflicted ones yield or
                # abort the plan per execution.foreign.conflict.policy
                ongoing_pre = self.backend.ongoing_reassignments()
                alive_pre = self.backend.alive_brokers()
                targets_pre = (
                    self._reassignment_targets() if ongoing_pre else None
                )
                batch = [
                    t for t in batch
                    if self._revalidate_task(t, ticks, ongoing_pre,
                                             alive_pre, targets_pre)
                ]
                if self._stop_requested:
                    batch = []
            if batch:
                from cruise_control_tpu_torch.telemetry import tracing

                last_progress_tick = ticks
                # one span + one event per dispatched batch (not per tick):
                # batch count is bounded by the plan, tick count is not
                events.emit("executor.batch", phase="replica_moves",
                            moves=len(batch), tick=ticks,
                            partitions=[t.proposal.partition for t in batch])
                # write-ahead watermark: the batch reaches the checkpoint
                # BEFORE the cluster sees it, so no crash point can lose
                # track of a dispatched move (task ids suffice — recovery
                # maps them back to partitions through the start record)
                self._jwrite("batch", phase="replica_moves", tick=ticks,
                             taskIds=[t.task_id for t in batch])
                with tracing.span("executor.batch") as sp:
                    sp.set("moves", len(batch))
                    reassignments = {
                        t.proposal.partition: t.proposal.new_replicas
                        for t in batch
                    }
                    self.backend.alter_partition_reassignments(reassignments)
                    for t in batch:
                        t.transition(TaskState.IN_PROGRESS)
                        t.started_tick = ticks
                        in_flight[t.proposal.partition] = t
                        for b in t.participating_brokers:
                            in_flight_per_broker[b] = (
                                in_flight_per_broker.get(b, 0) + 1
                            )
            if not in_flight and not any(
                t.state == TaskState.PENDING for t in planner.replica_tasks
            ):
                break
            # advance the world one tick and harvest completions
            tick = getattr(self.backend, "tick", None)
            if tick is not None:
                tick()
            ticks += 1
            ongoing = self.backend.ongoing_reassignments()
            # mid-flight foreign reconciliation: diff observed
            # reassignments against our dispatched set every tick
            foreign_now = ongoing - set(in_flight)
            if foreign_now:
                planned_left = {
                    t.proposal.partition for t in planner.replica_tasks
                    if t.state == TaskState.PENDING
                }
                # disjoint foreign moves are tolerated: journaled once and
                # fed to the ConcurrencyAdjuster as external URPs via
                # _caps (their catch-up traffic is real cluster stress)
                self._note_foreign(foreign_now - planned_left,
                                   conflict=False, origin="mid-flight")
            if in_flight:
                targets = self._reassignment_targets()
                if targets:
                    for p, t in list(in_flight.items()):
                        tgt = targets.get(p)
                        if tgt is not None and list(tgt) != \
                                list(t.proposal.new_replicas):
                            # a foreign writer re-targeted our in-flight
                            # move: yield it (retry once the foreign move
                            # drains) or abort the plan, per policy
                            in_flight.pop(p)
                            for b in t.participating_brokers:
                                in_flight_per_broker[b] -= 1
                            self._handle_conflict(t, ticks,
                                                  origin="in-flight",
                                                  in_progress=True)
            finished = [p for p in in_flight if p not in ongoing]
            completed_now: List[ExecutionTask] = []
            for p in finished:
                t = in_flight.pop(p)
                for b in t.participating_brokers:
                    in_flight_per_broker[b] -= 1
                try:
                    st = self.backend.partition_state(p)
                except KeyError:
                    # the partition was deleted while our move was in
                    # flight: the task is moot, not failed
                    self._cancel_drift(t, ticks, "topology-drift:deleted",
                                       "deleted")
                    continue
                ok = list(st.replicas) == list(t.proposal.new_replicas)
                if ok:
                    t.transition(TaskState.COMPLETED)
                    t.finished_tick = ticks
                    last_progress_tick = ticks
                    completed_now.append(t)
                else:
                    self._fail_task(
                        t, "replica-mismatch", ticks,
                        extra={
                            "actual": list(st.replicas),
                            "planned": list(t.proposal.new_replicas),
                        },
                    )
            if completed_now:
                # one aggregated record per tick, not one per move — the
                # checkpoint must cost ~nothing on the bench's hot path
                self._jwrite("task", state="COMPLETED", tick=ticks,
                             taskIds=[t.task_id for t in completed_now])
            # time out stuck moves (upstream: mark DEAD, leave reassignment
            # — unless the retry budget buys another attempt)
            for p, t in list(in_flight.items()):
                if ticks - t.started_tick > self.config.task_timeout_ticks:
                    in_flight.pop(p)
                    for b in t.participating_brokers:
                        in_flight_per_broker[b] -= 1
                    self._fail_task(
                        t, "timeout", ticks,
                        extra={
                            "timeoutTicks": self.config.task_timeout_ticks
                        },
                    )
            # stuck-execution watchdog: stop → abort → unrecoverable
            if watchdog > 0 and (in_flight or any(
                t.state == TaskState.PENDING for t in planner.replica_tasks
            )):
                stuck = ticks - last_progress_tick
                if stuck >= 2 * watchdog:
                    events.emit("executor.watchdog", severity="ERROR",
                                stage="abort", stuckTicks=stuck)
                    cancel = getattr(self.backend, "cancel_reassignments",
                                     None)
                    if cancel is not None:
                        try:
                            cancel(sorted(in_flight))
                        except NotImplementedError:
                            pass
                    for p, t in list(in_flight.items()):
                        events.emit(
                            "executor.task_dead", severity="WARNING",
                            taskId=t.task_id, partition=p,
                            reason="watchdog", stuckTicks=stuck,
                        )
                        t.transition(TaskState.DEAD)
                        t.finished_tick = ticks
                        self._jwrite("task", taskId=t.task_id, partition=p,
                                     state="DEAD", tick=ticks,
                                     attempts=t.attempts, reason="watchdog")
                    in_flight.clear()
                    in_flight_per_broker.clear()
                    self._abort_pending_replicas(planner, "watchdog")
                    events.emit(
                        "execution.unrecoverable", severity="ERROR",
                        executionId=self._execution_seq, stuckTicks=stuck,
                        tick=ticks,
                    )
                    self._jwrite("phase", phase="unrecoverable", tick=ticks)
                    break
                if stuck >= watchdog and not halted:
                    halted = True
                    events.emit("executor.watchdog", severity="WARNING",
                                stage="stop", stuckTicks=stuck)
        else:
            # tick budget exhausted: nothing may stay non-terminal, or the
            # result would misreport an incomplete rebalance as success
            for t in in_flight.values():
                events.emit(
                    "executor.task_dead", severity="WARNING",
                    taskId=t.task_id, partition=t.proposal.partition,
                    reason="tick-budget", maxTicks=max_ticks,
                )
                t.transition(TaskState.DEAD)
                t.finished_tick = ticks
                self._jwrite("task", taskId=t.task_id,
                             partition=t.proposal.partition, state="DEAD",
                             tick=ticks, attempts=t.attempts,
                             reason="tick-budget")
        self._abort_pending_replicas(planner, "not-started")
        return ticks

    def _drive_leader_moves(self, planner: ExecutionTaskPlanner) -> None:
        self.state = ExecutorStateValue.LEADER_MOVEMENT_TASK_IN_PROGRESS
        events.emit(
            "executor.phase", phase="leader_moves",
            pending=sum(1 for t in planner.leader_tasks
                        if t.state == TaskState.PENDING),
        )
        self._jwrite("phase", phase="leader_moves")
        while True:
            if self._stop_requested:
                self.state = ExecutorStateValue.STOPPING_EXECUTION
                for t in planner.leader_tasks:
                    if t.state == TaskState.PENDING:
                        t.transition(TaskState.ABORTED)
                        self._jwrite("task", taskId=t.task_id,
                                     partition=t.proposal.partition,
                                     state="ABORTED",
                                     reason=self._abort_reason or "stopped")
                return
            batch = planner.next_leader_batch(
                self.config.num_concurrent_leader_movements
            )
            if batch and self.config.revalidate_preconditions:
                live_batch = []
                for t in batch:
                    try:
                        self.backend.partition_state(t.proposal.partition)
                        live_batch.append(t)
                    except KeyError:
                        self._cancel_drift(t, 0, "topology-drift:deleted",
                                           "deleted")
                batch = live_batch
            if not batch:
                return
            events.emit("executor.batch", phase="leader_moves",
                        moves=len(batch))
            self._jwrite("batch", phase="leader_moves",
                         taskIds=[t.task_id for t in batch])
            elections = {
                t.proposal.partition: t.proposal.new_leader for t in batch
            }
            self.backend.elect_leaders(elections)
            elected: List[ExecutionTask] = []
            for t in batch:
                t.transition(TaskState.IN_PROGRESS)
                st = self.backend.partition_state(t.proposal.partition)
                ok = st.leader == t.proposal.new_leader
                if not ok:
                    events.emit(
                        "executor.task_dead", severity="WARNING",
                        taskId=t.task_id, partition=t.proposal.partition,
                        reason="leader-election-failed",
                        actualLeader=st.leader,
                        plannedLeader=t.proposal.new_leader,
                    )
                t.transition(
                    TaskState.COMPLETED if ok else TaskState.DEAD
                )
                if ok:
                    elected.append(t)
                else:
                    self._jwrite("task", taskId=t.task_id,
                                 partition=t.proposal.partition,
                                 state="DEAD",
                                 reason="leader-election-failed")
            if elected:
                self._jwrite("task", state="COMPLETED",
                             taskIds=[t.task_id for t in elected])

    def _drive_intra_moves(self, planner: ExecutionTaskPlanner) -> None:
        """JBOD disk-to-disk moves via alterReplicaLogDirs.  Proposals reach
        the executor with dir NAMES in disk_moves (facade-translated)."""
        if not any(t.state == TaskState.PENDING for t in planner.intra_tasks):
            return
        self.state = (
            ExecutorStateValue.INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
        )
        events.emit(
            "executor.phase", phase="intra_moves",
            pending=sum(1 for t in planner.intra_tasks
                        if t.state == TaskState.PENDING),
        )
        self._jwrite("phase", phase="intra_moves")
        while True:
            if self._stop_requested:
                self.state = ExecutorStateValue.STOPPING_EXECUTION
                for t in planner.intra_tasks:
                    if t.state == TaskState.PENDING:
                        t.transition(TaskState.ABORTED)
                        self._jwrite("task", taskId=t.task_id,
                                     partition=t.proposal.partition,
                                     state="ABORTED",
                                     reason=self._abort_reason or "stopped")
                return
            batch = planner.next_intra_batch(
                self.config.num_concurrent_intra_broker_partition_movements
            )
            if batch and self.config.revalidate_preconditions:
                live_batch = []
                for t in batch:
                    try:
                        self.backend.partition_state(t.proposal.partition)
                        live_batch.append(t)
                    except KeyError:
                        self._cancel_drift(t, 0, "topology-drift:deleted",
                                           "deleted")
                batch = live_batch
            if not batch:
                return
            events.emit("executor.batch", phase="intra_moves",
                        moves=len(batch))
            self._jwrite("batch", phase="intra_moves",
                         taskIds=[t.task_id for t in batch])
            moves = {
                t.proposal.partition: {
                    b: new_dir for b, _old, new_dir in t.proposal.disk_moves
                }
                for t in batch
            }
            self.backend.alter_replica_log_dirs(moves)
            for t in batch:
                t.transition(TaskState.IN_PROGRESS)
            # a real backend copies data asynchronously — poll with the same
            # tick/timeout budget replica moves get
            tick = getattr(self.backend, "tick", None)
            for waited in range(self.config.task_timeout_ticks + 1):
                pending = [
                    t for t in batch
                    if t.state == TaskState.IN_PROGRESS and not all(
                        self.backend.replica_log_dir(t.proposal.partition, b)
                        == new_dir
                        for b, _old, new_dir in t.proposal.disk_moves
                    )
                ]
                for t in batch:
                    if t.state == TaskState.IN_PROGRESS and t not in pending:
                        t.transition(TaskState.COMPLETED)
                        self._jwrite("task", taskId=t.task_id,
                                     partition=t.proposal.partition,
                                     state="COMPLETED")
                if not pending:
                    break
                if tick is None or waited == self.config.task_timeout_ticks:
                    for t in pending:
                        events.emit(
                            "executor.task_dead", severity="WARNING",
                            taskId=t.task_id,
                            partition=t.proposal.partition,
                            reason="intra-move-timeout",
                        )
                        t.transition(TaskState.DEAD)
                        self._jwrite("task", taskId=t.task_id,
                                     partition=t.proposal.partition,
                                     state="DEAD",
                                     reason="intra-move-timeout")
                    break
                tick()

    # ---- observability ----------------------------------------------------------
    def state_summary(self, verbose: bool = False) -> dict:
        """Summary for ``/state``.  The per-move ``tasks`` arrays (up to
        8 executions × 200 task dicts) are only embedded when ``verbose``
        — the UI polls /state every 5 s and opens the drill-in rarely, so
        the default payload stays proportional to the execution count,
        not the move count."""
        tasks = self.planner.all_tasks if self.planner else []
        by_state: Dict[str, int] = {}
        for t in tasks:
            by_state[t.state.value] = by_state.get(t.state.value, 0) + 1
        recent = self.execution_log[-8:]
        if not verbose:
            recent = [
                {k: v for k, v in e.items() if k != "tasks"} for e in recent
            ]
        return {
            "state": self.state.value,
            "taskCounts": by_state,
            "numFinishedMovements": self._finished_movements,
            "stopRequested": self._stop_requested,
            "adoptedAtStartup": sorted(self.adopted_at_startup),
            "recentExecutions": recent,
            # crash-recovery + retry posture (docs/ARCHITECTURE.md
            # "Execution recovery"): the last checkpoint adoption and the
            # retry machinery's live counters
            "recovery": {
                "checkpointEnabled": self.journal is not None,
                "lastRecovery": self._last_recovery,
            },
            "retries": {
                "scheduled": self._retries_scheduled,
                "excludedDestinations": sorted(self.excluded_destinations),
            },
            # concurrent-controller posture: the fencing epoch this
            # process holds and the current execution's foreign/drift tally
            "fencing": {
                "epoch": self.epoch,
                "conflictPolicy": self.config.foreign_conflict_policy,
                "drift": dict(self._drift),
            },
        }

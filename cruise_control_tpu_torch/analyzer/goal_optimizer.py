"""GoalOptimizer — runs the goal stack in priority order and diffs the result
into execution proposals (upstream ``analyzer/GoalOptimizer.java`` +
``OptimizerResult`` + ``AnalyzerUtils`` diff; SURVEY.md §2.5, call stack §3.2).

This is the *greedy baseline engine* (BASELINE.json config #1) and the parity
oracle for the TPU optimizer: both produce the same ``OptimizerResult``
contract, so everything downstream (executor, REST, self-healing) is
engine-agnostic.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from cruise_control_tpu_torch.common.resources import EMPTY_SLOT
from cruise_control_tpu_torch.analyzer.actions import ActionType, BalancingAction
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext, OptimizationOptions
from cruise_control_tpu_torch.analyzer.goals.base import (
    BalancingConstraint,
    Goal,
    OptimizationFailure,
)
from cruise_control_tpu_torch.analyzer.goals.capacity import (
    CpuCapacityGoal,
    DiskCapacityGoal,
    NetworkInboundCapacityGoal,
    NetworkOutboundCapacityGoal,
    ReplicaCapacityGoal,
)
from cruise_control_tpu_torch.analyzer.goals.distribution import (
    BrokerSetAwareGoal,
    CpuUsageDistributionGoal,
    DiskUsageDistributionGoal,
    LeaderBytesInDistributionGoal,
    LeaderReplicaDistributionGoal,
    MinTopicLeadersPerBrokerGoal,
    NetworkInboundUsageDistributionGoal,
    NetworkOutboundUsageDistributionGoal,
    PotentialNwOutGoal,
    PreferredLeaderElectionGoal,
    ReplicaDistributionGoal,
    TopicReplicaDistributionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.intrabroker import (
    IntraBrokerDiskCapacityGoal,
    IntraBrokerDiskUsageDistributionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.kafka_assigner import (
    KafkaAssignerDiskUsageDistributionGoal,
    KafkaAssignerEvenRackAwareGoal,
)
from cruise_control_tpu_torch.analyzer.goals.rack import (
    RackAwareDistributionGoal,
    RackAwareGoal,
)
from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("analyzer")
from cruise_control_tpu_torch.models.stats import cluster_stats, stats_summary

#: Upstream default.goals order (cruisecontrol.properties default.goals).
DEFAULT_GOAL_ORDER = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
]

GOAL_CLASSES = {
    cls.name: cls
    for cls in [
        RackAwareGoal,
        RackAwareDistributionGoal,
        ReplicaCapacityGoal,
        DiskCapacityGoal,
        NetworkInboundCapacityGoal,
        NetworkOutboundCapacityGoal,
        CpuCapacityGoal,
        ReplicaDistributionGoal,
        PotentialNwOutGoal,
        DiskUsageDistributionGoal,
        NetworkInboundUsageDistributionGoal,
        NetworkOutboundUsageDistributionGoal,
        CpuUsageDistributionGoal,
        TopicReplicaDistributionGoal,
        LeaderReplicaDistributionGoal,
        LeaderBytesInDistributionGoal,
        MinTopicLeadersPerBrokerGoal,
        BrokerSetAwareGoal,
        PreferredLeaderElectionGoal,
        IntraBrokerDiskCapacityGoal,
        IntraBrokerDiskUsageDistributionGoal,
        KafkaAssignerEvenRackAwareGoal,
        KafkaAssignerDiskUsageDistributionGoal,
    ]
}

#: The JBOD goal list (upstream rebalance?rebalance_disk=true).
INTRA_BROKER_GOAL_ORDER = [
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
]

#: Legacy kafka-assigner mode (upstream kafka_assigner=true).
KAFKA_ASSIGNER_GOAL_ORDER = [
    "KafkaAssignerEvenRackAwareGoal",
    "KafkaAssignerDiskUsageDistributionGoal",
]


def make_goals(
    names: Optional[Sequence[str]] = None,
    constraint: Optional[BalancingConstraint] = None,
    hard_names: Optional[Sequence[str]] = None,
) -> List[Goal]:
    """Instantiate goals by name (upstream getConfiguredInstances over the
    `default.goals` list).  ``hard_names`` overrides which goals are treated
    as hard for this instance (upstream `hard.goals`); None keeps each
    class's intrinsic hardness."""
    constraint = constraint or BalancingConstraint()
    goals = [GOAL_CLASSES[n](constraint) for n in (names or DEFAULT_GOAL_ORDER)]
    if hard_names is not None:
        hard = set(hard_names)
        for g in goals:
            g.is_hard = g.name in hard
    return goals


@dataclasses.dataclass(frozen=True)
class ExecutionProposal:
    """Diff unit handed to the executor (upstream executor/ExecutionProposal.java)."""

    partition: int
    topic: int
    old_leader: int
    new_leader: int
    old_replicas: tuple
    new_replicas: tuple
    #: JBOD intra-broker moves: (broker, old_disk, new_disk) triples —
    #: disk ids while inside the analyzer, log-dir names once the facade has
    #: translated for the executor (upstream replicasToMoveBetweenDisksByBroker)
    disk_moves: tuple = ()
    #: decision provenance: names of the goal passes (or engine phases)
    #: whose actions touched this partition, in commit order — answers
    #: "which goal generated this proposal" straight from the REST payload
    goals: tuple = ()

    @property
    def has_replica_change(self) -> bool:
        return set(self.old_replicas) != set(self.new_replicas)

    @property
    def has_leader_change(self) -> bool:
        return self.old_leader != self.new_leader

    @property
    def has_disk_move(self) -> bool:
        return bool(self.disk_moves)

    def to_json(self) -> dict:
        return {
            "partition": self.partition,
            "topic": self.topic,
            "oldLeader": self.old_leader,
            "newLeader": self.new_leader,
            "oldReplicas": list(self.old_replicas),
            "newReplicas": list(self.new_replicas),
            "diskMoves": [list(m) for m in self.disk_moves],
            "goals": list(self.goals),
        }


@dataclasses.dataclass
class OptimizerResult:
    """Upstream ``OptimizerResult``: proposals + before/after accounting."""

    proposals: List[ExecutionProposal]
    actions: List[BalancingAction]
    violations_before: Dict[str, int]
    violations_after: Dict[str, int]
    stats_before: dict
    stats_after: dict
    final_state: ClusterState
    duration_s: float
    engine: str = "greedy"
    #: Filled by the facade after a non-dryrun execution (ExecutionResult).
    execution: Optional[object] = None
    #: Provisioning hints from the final state (ProvisionResponse).
    provision: Optional[object] = None
    #: Per-goal-pass decision provenance: [{goal, pass, accepted,
    #: rejected: {reason: count}}] in pass order (both engines fill it).
    goal_summaries: List[dict] = dataclasses.field(default_factory=list)

    @property
    def violation_score_before(self) -> int:
        return sum(self.violations_before.values())

    @property
    def violation_score_after(self) -> int:
        return sum(self.violations_after.values())

    def summary(self) -> dict:
        exec_summary = None
        if self.execution is not None:
            exec_summary = {
                "completed": self.execution.completed,
                "dead": self.execution.dead,
                "aborted": self.execution.aborted,
                "succeeded": self.execution.succeeded,
            }
        # upstream OptimizationResult movement accounting (the numbers the
        # proposals UI/clients render): replica moves = replicas gaining a
        # new broker, dataToMoveMB = their disk footprint
        n_replica_moves = n_leader_moves = n_disk_moves = 0
        data_mb = 0.0
        disk = None
        if self.final_state is not None:
            import numpy as np

            from cruise_control_tpu_torch.common.resources import Resource

            leader_disk = np.asarray(
                self.final_state.leader_load[:, Resource.DISK]
            )
            disk = leader_disk
        # per-broker before→after deltas (the UI's proposal-diff view, the
        # per-broker slice of upstream's loadBeforeOptimization/
        # loadAfterOptimization): replicas, leadership, and disk bytes each
        # broker gains or sheds if this plan executes
        bdiff: Dict[int, dict] = {}

        def _ent(b: int) -> dict:
            return bdiff.setdefault(int(b), {
                "broker": int(b), "replicaDelta": 0, "leaderDelta": 0,
                "diskDeltaMB": 0.0,
            })

        for p in self.proposals:
            added = set(p.new_replicas) - set(p.old_replicas)
            removed = set(p.old_replicas) - set(p.new_replicas)
            n_replica_moves += len(added)
            n_leader_moves += int(p.has_leader_change)
            n_disk_moves += len(p.disk_moves)
            size = (
                float(disk[p.partition])
                if disk is not None and p.partition < len(disk) else 0.0
            )
            if added:
                data_mb += size * len(added)
            for b in added:
                e = _ent(b)
                e["replicaDelta"] += 1
                e["diskDeltaMB"] += size
            for b in removed:
                e = _ent(b)
                e["replicaDelta"] -= 1
                e["diskDeltaMB"] -= size
            if p.has_leader_change:
                _ent(p.new_leader)["leaderDelta"] += 1
                _ent(p.old_leader)["leaderDelta"] -= 1
        # secondary sort keys keep leader-only brokers (diskDeltaMB == 0)
        # from sorting last and silently falling off the truncation
        broker_diff = sorted(
            bdiff.values(),
            key=lambda e: (-abs(e["diskDeltaMB"]), -abs(e["leaderDelta"]),
                           -abs(e["replicaDelta"]), e["broker"]),
        )[:60]
        for e in broker_diff:
            e["diskDeltaMB"] = round(e["diskDeltaMB"], 2)
        return {
            "engine": self.engine,
            "execution": exec_summary,
            "provision": (
                self.provision.to_json() if self.provision is not None else None
            ),
            "numProposals": len(self.proposals),
            "numActions": len(self.actions),
            "numReplicaMovements": n_replica_moves,
            "numLeaderMovements": n_leader_moves,
            "numIntraBrokerReplicaMovements": n_disk_moves,
            "dataToMoveMB": round(data_mb, 3),
            "brokerLoadDiff": broker_diff,
            # truncation indicator: the UI labels the table partial when
            # numBrokersChanged > len(brokerLoadDiff)
            "numBrokersChanged": len(bdiff),
            # decision provenance: what each goal pass accepted/rejected
            # and why — the "explain this plan per goal" card
            "goalSummaries": self.goal_summaries,
            "violationsBefore": self.violations_before,
            "violationsAfter": self.violations_after,
            # reference-UI parity: per-goal before/after + ClusterModelStats
            # deltas backing the proposals tab's goal-stats card
            "statsBefore": self.stats_before,
            "statsAfter": self.stats_after,
            "violationScoreBefore": self.violation_score_before,
            "violationScoreAfter": self.violation_score_after,
            "durationSeconds": self.duration_s,
        }


def goal_pass_summaries(
    goals: Sequence[Goal], ctx: AnalyzerContext
) -> List[dict]:
    """Per-pass accepted/rejected accounting (decision provenance).

    Accepted counts derive from the action tags (a swap decomposed into
    two internal applies still counts once); reject counters with their
    categorical reasons come straight from ``ctx.pass_stats``."""
    accepted: Dict[str, int] = {}
    for a in ctx.actions:
        if a.goal:
            accepted[a.goal] = accepted.get(a.goal, 0) + 1
    out = []
    for i, g in enumerate(goals):
        st = ctx.pass_stats.get(g.name, {})
        rejected = {
            k: int(v) for k, v in sorted(st.get("rejected", {}).items())
        }
        out.append({
            "goal": g.name,
            "pass": i,
            "accepted": int(accepted.get(g.name, 0)),
            "rejected": rejected,
        })
    return out


def _proposal_goals(ctx: AnalyzerContext) -> Dict[int, tuple]:
    """{partition: (goal, ...)} — which goal passes touched each partition,
    deduplicated in commit order (the attribution ``diff_proposals`` stamps
    onto every ExecutionProposal)."""
    by_p: Dict[int, dict] = {}
    for a in ctx.actions:
        if not a.goal:
            continue
        parts = (
            (a.partition, a.swap_partition)
            if a.action_type == ActionType.INTER_BROKER_REPLICA_SWAP
            else (a.partition,)
        )
        for p in parts:
            by_p.setdefault(int(p), {})[a.goal] = None  # ordered set
    return {p: tuple(d) for p, d in by_p.items()}


def diff_proposals(
    initial_assignment: np.ndarray,
    initial_leader_slot: np.ndarray,
    ctx: AnalyzerContext,
    initial_replica_disk: Optional[np.ndarray] = None,
) -> List[ExecutionProposal]:
    """Placement diff → proposals (upstream AnalyzerUtils.getDiff).

    The changed-partition detection is vectorized: the Python loop below
    touches only partitions whose row/leader/disk actually changed — at
    the 1M-partition scale a full-universe Python walk was most of the
    post-search finalize time for a plan touching a few percent of
    partitions."""
    out: List[ExecutionProposal] = []
    goals_by_p = _proposal_goals(ctx)
    old_leaders = np.take_along_axis(
        initial_assignment, initial_leader_slot[:, None], axis=1
    )[:, 0]
    new_leaders = np.take_along_axis(
        ctx.assignment, ctx.leader_slot[:, None], axis=1
    )[:, 0]
    changed = np.any(initial_assignment != ctx.assignment, axis=1) | (
        old_leaders != new_leaders
    )
    if initial_replica_disk is not None:
        changed = changed | np.any(
            (initial_assignment != EMPTY_SLOT)
            & (initial_assignment == ctx.assignment)
            & (initial_replica_disk != ctx.replica_disk)
            & (ctx.replica_disk >= 0),
            axis=1,
        )
    for p in np.nonzero(changed)[0]:
        p = int(p)
        old_row = initial_assignment[p]
        new_row = ctx.assignment[p]
        old_leader = int(old_row[initial_leader_slot[p]])
        new_leader = ctx.leader_broker(p)
        disk_moves: List[tuple] = []
        if initial_replica_disk is not None:
            for s in range(old_row.shape[0]):
                b = int(old_row[s])
                # a disk change only yields an intra move when the replica
                # stayed on its broker; cross-broker moves pick their dir on
                # arrival
                if (
                    b != EMPTY_SLOT
                    and b == int(new_row[s])
                    and initial_replica_disk[p, s] != ctx.replica_disk[p, s]
                    and ctx.replica_disk[p, s] >= 0
                ):
                    disk_moves.append((
                        b,
                        int(initial_replica_disk[p, s]),
                        int(ctx.replica_disk[p, s]),
                    ))
        if ((old_row == new_row).all() and old_leader == new_leader
                and not disk_moves):
            continue
        # Kafka replica lists are leader-first; emit the new replica list with
        # the leader first so executors can hand it straight to a reassignment.
        new_replicas = [int(b) for b in new_row if b != EMPTY_SLOT]
        new_replicas.sort(key=lambda b: b != new_leader)
        old_replicas = [int(b) for b in old_row if b != EMPTY_SLOT]
        old_replicas.sort(key=lambda b: b != old_leader)
        out.append(
            ExecutionProposal(
                partition=p,
                topic=int(ctx.partition_topic[p]),
                old_leader=old_leader,
                new_leader=new_leader,
                old_replicas=tuple(old_replicas),
                new_replicas=tuple(new_replicas),
                disk_moves=tuple(disk_moves),
                goals=goals_by_p.get(p, ()),
            )
        )
    return out


class GoalOptimizer:
    """Runs goals by priority over an AnalyzerContext (upstream GoalOptimizer)."""

    def __init__(
        self,
        goals: Optional[Sequence[Goal]] = None,
        constraint: Optional[BalancingConstraint] = None,
    ):
        self.constraint = constraint or BalancingConstraint()
        self.goals = list(goals) if goals is not None else make_goals(
            constraint=self.constraint
        )

    def optimize(
        self,
        state: ClusterState,
        options: Optional[OptimizationOptions] = None,
        warm_start=None,
        carry=None,
    ) -> OptimizerResult:
        """``warm_start`` (replan.delta.WarmStart-shaped) seeds the goal
        passes at a previous plan's final placement — on a drifted steady
        state the passes then accept only the delta's worth of moves —
        and enables signature-based partial re-verification.  ``carry``
        is accepted for engine-API parity and ignored (the device carry
        is the TPU engine's)."""
        from cruise_control_tpu_torch.telemetry import tracing

        with tracing.span("analyzer.greedy"):
            return self._optimize(state, options, warm_start=warm_start)

    def _optimize(
        self,
        state: ClusterState,
        options: Optional[OptimizationOptions] = None,
        warm_start=None,
    ) -> OptimizerResult:
        t0 = time.perf_counter()
        ctx = AnalyzerContext(state, options)
        initial_assignment = ctx.assignment.copy()
        initial_leader_slot = ctx.leader_slot.copy()
        initial_replica_disk = (
            ctx.replica_disk.copy() if ctx.replica_disk is not None else None
        )
        if warm_start is not None:
            ctx.reseed(
                warm_start.assignment, warm_start.leader_slot,
                warm_start.replica_disk,
            )
        stats_before = stats_summary(cluster_stats(state))
        if warm_start is not None:
            from cruise_control_tpu_torch.analyzer.verifier import (
                partial_violations,
            )

            violations_before, _, reused_before = partial_violations(
                ctx, self.goals,
                warm_start.prev_signatures, warm_start.prev_violations,
                force_full=warm_start.full_verify,
            )
        else:
            violations_before = {
                g.name: g.violations(ctx) for g in self.goals
            }
            reused_before = []

        import logging as _logging

        from cruise_control_tpu_torch.telemetry import tracing

        optimized: List[Goal] = []
        try:
            for i, goal in enumerate(self.goals):
                n_before = len(ctx.actions)
                # decision provenance: actions applied and candidates
                # rejected during this pass are charged to it
                ctx.current_goal, ctx.current_round = goal.name, i
                # per-goal pass span (goal.name is a static class attribute —
                # no formatting on the disabled path)
                with tracing.span("analyzer.goal", sub=goal.name):
                    goal.optimize(ctx, optimized)
                if LOG.isEnabledFor(_logging.DEBUG):  # violations() is work
                    LOG.debug(
                        "%s: %d actions (violations %d -> %d)", goal.name,
                        len(ctx.actions) - n_before,
                        violations_before[goal.name], goal.violations(ctx),
                    )
                if goal.is_hard and goal.violations(ctx) > 0:
                    LOG.error(
                        "hard goal %s still violated after optimization",
                        goal.name,
                    )
                    raise OptimizationFailure(
                        f"{goal.name} still violated after optimization"
                    )
                optimized.append(goal)
        except OptimizationFailure as e:
            # a failed rebalance must stay diagnosable: ship the per-pass
            # accounting gathered so far with the failure (the facade
            # journals it)
            e.goal_summaries = goal_pass_summaries(self.goals, ctx)
            raise
        finally:
            ctx.current_goal, ctx.current_round = "", -1

        replan_verify = None
        if warm_start is not None:
            from cruise_control_tpu_torch.analyzer.verifier import (
                partial_violations,
            )

            violations_after, sigs_after, reused_after = partial_violations(
                ctx, self.goals,
                warm_start.prev_signatures, warm_start.prev_violations,
                force_full=warm_start.full_verify,
            )
            replan_verify = {
                "signatures": sigs_after,
                "reusedBefore": list(reused_before),
                "reusedAfter": list(reused_after),
                "fullVerify": bool(warm_start.full_verify),
            }
        else:
            violations_after = {
                g.name: g.violations(ctx) for g in self.goals
            }
        final_state = ctx.to_state(state)
        stats_after = stats_summary(cluster_stats(final_state))
        from cruise_control_tpu_torch.analyzer.provision import analyze_provisioning

        provision = analyze_provisioning(final_state)
        result = OptimizerResult(
            proposals=diff_proposals(
                initial_assignment, initial_leader_slot, ctx,
                initial_replica_disk,
            ),
            actions=(
                list(warm_start.prev_actions) + list(ctx.actions)
                if warm_start is not None else list(ctx.actions)
            ),
            violations_before=violations_before,
            violations_after=violations_after,
            stats_before=stats_before,
            stats_after=stats_after,
            final_state=final_state,
            duration_s=time.perf_counter() - t0,
            engine="greedy",
            provision=provision,
            goal_summaries=goal_pass_summaries(self.goals, ctx),
        )
        if replan_verify is not None:
            result.replan_verify = replan_verify
        return result

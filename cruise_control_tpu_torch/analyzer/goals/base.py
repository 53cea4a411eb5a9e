"""Goal SPI + shared greedy machinery.

Upstream shape (``analyzer/goals/Goal.java`` / ``AbstractGoal.java``,
SURVEY.md §2.5): goals run in priority order; each goal mutates the model to
satisfy itself while every candidate action must pass the *acceptance* check
of all previously-optimized goals (chaining).  Hard goals throw on failure;
soft goals settle for best-effort.

TPU-first twist: acceptance is expressed **vectorized over the destination
broker axis** (``accept_move(ctx, p, s) -> bool[B]``) rather than per-action.
The greedy baseline consumes these masks directly (one numpy op per goal per
candidate replica instead of B Python calls), and the TPU optimizer reuses the
same formulas on jnp arrays for its fused feasibility mask — single-source
goal semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import (
    DEFAULT_BALANCE_THRESHOLD,
    DEFAULT_CAPACITY_THRESHOLD,
    DEFAULT_LOW_UTILIZATION_THRESHOLD,
    EMPTY_SLOT,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.analyzer.actions import ActionType, BalancingAction
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext

#: Upstream ResourceDistributionGoal.BALANCE_MARGIN: thresholds are tightened
#: by this factor during optimization so post-optimization drift stays legal.
BALANCE_MARGIN = 0.9


class OptimizationFailure(Exception):
    """Hard goal could not be satisfied (upstream OptimizationFailureException)."""


@dataclasses.dataclass
class BalancingConstraint:
    """Analyzer threshold config (upstream AnalyzerConfig keys, SURVEY.md §5.6)."""

    capacity_threshold: Dict[Resource, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_CAPACITY_THRESHOLD)
    )
    balance_threshold: Dict[Resource, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_BALANCE_THRESHOLD)
    )
    low_utilization_threshold: Dict[Resource, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LOW_UTILIZATION_THRESHOLD)
    )
    #: replica.count.balance.threshold
    replica_balance_threshold: float = 1.1
    #: leader.replica.count.balance.threshold
    leader_replica_balance_threshold: float = 1.1
    #: topic.replica.count.balance.threshold
    topic_replica_balance_threshold: float = 3.0
    #: max.replicas.per.broker
    max_replicas_per_broker: int = 10_000
    #: min.topic.leaders.per.broker + the topic ids it applies to
    min_topic_leaders_per_broker: int = 0
    min_topic_leaders_topics: Set[int] = dataclasses.field(default_factory=set)
    #: topic id -> allowed broker ids (BrokerSetAwareGoal config)
    broker_sets: Dict[int, Set[int]] = dataclasses.field(default_factory=dict)

    def balance_bounds(self, avg: float, resource: Resource) -> Tuple[float, float]:
        """(lower, upper) utilization bounds around the cluster average."""
        pct = (self.balance_threshold[resource] - 1.0) * BALANCE_MARGIN
        return avg * max(0.0, 1.0 - pct), avg * (1.0 + pct)

    def count_bounds(self, avg: float, threshold: float) -> Tuple[int, int]:
        pct = (threshold - 1.0) * BALANCE_MARGIN
        import math

        return math.floor(avg * max(0.0, 1.0 - pct)), math.ceil(avg * (1.0 + pct))


class Goal:
    """Base goal.  Subclasses set ``name`` and ``is_hard``."""

    name: str = "goal"
    is_hard: bool = False
    #: categorical reject reason charged when THIS goal's acceptance check
    #: is the one that eliminates every candidate destination (decision
    #: provenance; the vocabulary is fixed: capacity-exceeded,
    #: rack-violation, no-improvement, swap-cap, excluded-broker)
    reject_reason: str = "no-improvement"
    #: model fields this goal's ``violations()`` reads (the partial-verify
    #: vocabulary — see ``verifier.INPUT_FIELDS``).  The delta-replan path
    #: reuses a previously verified verdict when every declared input is
    #: BIT-IDENTICAL between the two contexts, so a declaration may be
    #: conservative (extra fields cost reuse, never correctness) but must
    #: never omit a field the verdict depends on.  The base default is the
    #: full surface; subclasses narrow it.
    inputs: tuple = (
        "assignment", "leader_slot", "loads", "capacity", "racks",
        "broker_state", "topics", "offline", "disks",
    )

    def __init__(self, constraint: Optional[BalancingConstraint] = None):
        self.constraint = constraint or BalancingConstraint()

    # ---- acceptance (vectorized over destination brokers) ----------------------
    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        """bool [B]: for each dest broker, would moving replica (p, s) there
        keep this goal satisfied?  Goal-specific invariant only — global
        legality (alive, exclusions, duplicates) is the caller's job."""
        return np.ones(ctx.num_brokers, bool)

    def accept_leadership(self, ctx: AnalyzerContext, p: int, new_slot: int) -> bool:
        """Would transferring partition p's leadership to ``new_slot`` keep
        this goal satisfied?"""
        return True

    def accept_swap(
        self, ctx: AnalyzerContext, p1: int, s1: int, p2: int, s2: int
    ) -> bool:
        """Would swapping replicas (p1, s1) ↔ (p2, s2) between their brokers
        keep this goal satisfied?  (Upstream ``actionAcceptance`` with
        ``INTER_BROKER_REPLICA_SWAP``.)

        Default: both legs must be individually acceptable single moves —
        exact for goals whose invariant depends only on final placement
        (rack, broker-set, topic counts), conservative for aggregate-bound
        goals, which override with the NET effect (the whole point of a
        swap is that the net fits where a single move does not)."""
        b1 = int(ctx.assignment[p1, s1])
        b2 = int(ctx.assignment[p2, s2])
        return bool(
            self.accept_move(ctx, p1, s1)[b2]
            and self.accept_move(ctx, p2, s2)[b1]
        )

    def accept_swap_dest(self, ctx: AnalyzerContext, p1: int, s1: int) -> np.ndarray:
        """bool [B] — NECESSARY condition on the partner broker for
        ``accept_swap(p1, s1, p2, s2)`` with any partner hosted there.

        A screen, not a replacement: pairs on surviving brokers still run
        the full ``accept_swap`` chain, so a sound implementation may only
        return False where no partner could ever be accepted.  For the
        default ``accept_swap`` leg 1 — placing (p1, s1) on the partner
        broker — must be an acceptable single move, and it does not depend
        on the partner replica, so the default screen is ``accept_move``'s
        destination mask.  NET-semantics overrides (distribution/capacity/
        count goals), whose verdict depends on the partner's load, override
        this to all-True."""
        return self.accept_move(ctx, p1, s1)

    # ---- optimization -----------------------------------------------------------
    def optimize(
        self,
        ctx: AnalyzerContext,
        optimized: Sequence["Goal"],
    ) -> None:
        """Mutate ctx toward this goal, chaining acceptance through
        ``optimized``.  Hard goals raise OptimizationFailure if impossible."""
        raise NotImplementedError

    # ---- scoring ---------------------------------------------------------------
    def violations(self, ctx: AnalyzerContext) -> int:
        """Number of outstanding violations (0 = satisfied).  Used by the
        goal-violation detector, the verifier, and the violation score."""
        raise NotImplementedError


# ---------------------------------------------------------------------------------
# Loop helpers shared by goal implementations and the GoalOptimizer
# ---------------------------------------------------------------------------------

def legal_move_dests(ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
    """bool [B]: structurally legal destinations for replica (p, s):
    alive + not excluded, not the current broker, not already hosting a
    replica of p."""
    ok = ctx.dest_candidates().copy()
    row = ctx.assignment[p]
    for b in row:
        if b != EMPTY_SLOT:
            ok[b] = False  # includes the source broker itself
    for b in ctx.offline_origin[p]:
        if b != EMPTY_SLOT:
            ok[b] = False  # p may not return to a broker it died on
    return ok


def accepted_move_dests(
    ctx: AnalyzerContext,
    p: int,
    s: int,
    current: Goal,
    optimized: Sequence[Goal],
) -> np.ndarray:
    """Destinations passing legality + current goal + all optimized goals.

    Provenance: when the mask empties, the rejection is charged to the
    running pass (``ctx.current_goal``) under the categorical reason of
    the goal whose check eliminated the last destination (structural
    legality counts as ``excluded-broker``)."""
    ok = legal_move_dests(ctx, p, s)
    if not ok.any():
        ctx.record_reject("excluded-broker")
        return ok
    ok &= current.accept_move(ctx, p, s)
    if not ok.any():
        ctx.record_reject(current.reject_reason)
        return ok
    for g in optimized:
        ok &= g.accept_move(ctx, p, s)
        if not ok.any():
            ctx.record_reject(g.reject_reason)
            break
    return ok


def accepted_leadership(
    ctx: AnalyzerContext,
    p: int,
    new_slot: int,
    current: Goal,
    optimized: Sequence[Goal],
) -> bool:
    b = ctx.assignment[p, new_slot]
    if b == EMPTY_SLOT or not ctx.leadership_candidates()[b]:
        ctx.record_reject("excluded-broker")
        return False
    if ctx.replica_offline[p, new_slot]:
        ctx.record_reject("excluded-broker")
        return False
    if not current.accept_leadership(ctx, p, new_slot):
        ctx.record_reject(current.reject_reason)
        return False
    for g in optimized:
        if not g.accept_leadership(ctx, p, new_slot):
            ctx.record_reject(g.reject_reason)
            return False
    return True


def accepted_swap(
    ctx: AnalyzerContext,
    p1: int, s1: int, p2: int, s2: int,
    current: Goal,
    optimized: Sequence[Goal],
) -> bool:
    """Legality + current-goal + chained acceptance for an inter-broker
    replica swap (upstream ``ResourceDistributionGoal`` swap fallback's
    acceptance path).  Legality is the two-way twin of
    :func:`legal_move_dests`: both brokers eligible destinations, neither
    partition already resident on (or offline-originated from) the other
    broker, leadership only landing on leadership-eligible brokers."""
    b1 = int(ctx.assignment[p1, s1])
    b2 = int(ctx.assignment[p2, s2])
    if p1 == p2 or b1 == b2 or b1 == EMPTY_SLOT or b2 == EMPTY_SLOT:
        return False
    if ctx.partition_excluded(p1) or ctx.partition_excluded(p2):
        return False
    # offline replicas are evacuated (one-way), never swapped
    if ctx.replica_offline[p1, s1] or ctx.replica_offline[p2, s2]:
        return False
    dest_ok = ctx.dest_candidates()
    if not (dest_ok[b1] and dest_ok[b2]):
        return False
    row1, row2 = ctx.assignment[p1], ctx.assignment[p2]
    if b2 in row1 or b1 in row2:
        return False
    if b2 in ctx.offline_origin[p1] or b1 in ctx.offline_origin[p2]:
        return False
    lead_ok = ctx.leadership_candidates()
    if ctx.is_leader(p1, s1) and not lead_ok[b2]:
        return False
    if ctx.is_leader(p2, s2) and not lead_ok[b1]:
        return False
    # provenance: structural filters above run per candidate PAIR inside
    # the partner scan and would swamp the per-replica counters; only the
    # goal-semantic verdicts below are charged
    if not current.accept_swap(ctx, p1, s1, p2, s2):
        ctx.record_reject(current.reject_reason)
        return False
    for g in optimized:
        if not g.accept_swap(ctx, p1, s1, p2, s2):
            ctx.record_reject(g.reject_reason)
            return False
    return True


def swap_partner_broker_mask(
    ctx: AnalyzerContext,
    p1: int, s1: int,
    current: Goal,
    optimized: Sequence[Goal],
) -> np.ndarray:
    """bool [B] — brokers that could host an acceptable swap partner for
    (p1, s1): the partner-independent slice of :func:`accepted_swap`
    (structural legality of leg 1 + every goal's ``accept_swap_dest``
    screen), vectorized over brokers.

    EXACT: a False broker cannot host any accepted partner, so the swap
    fallbacks skip it without enumerating its replicas; a True broker's
    pairs still run the full per-pair chain.  Before this screen the
    fallbacks discovered the same verdicts pair by pair — ~300k chained
    ``accept_swap`` evaluations on the 50b/1k bench, 2/3 of them
    rejected on conditions that never looked at the partner (the round-5
    0.48 → 0.67 s bench regression's root cause).

    Provenance mirrors :func:`accepted_move_dests`: when the mask empties,
    one rejection is charged under the reason of the goal whose screen
    emptied it (structural legality counts as ``excluded-broker``)."""
    b1 = int(ctx.assignment[p1, s1])
    B = ctx.num_brokers
    if (
        b1 == EMPTY_SLOT
        or ctx.partition_excluded(p1)
        or ctx.replica_offline[p1, s1]
        or not ctx.dest_candidates()[b1]
    ):
        return np.zeros(B, bool)
    ok = ctx.dest_candidates().copy()
    ok[b1] = False
    for b in ctx.assignment[p1]:
        if b != EMPTY_SLOT:
            ok[b] = False  # the partner broker must not already host p1
    for b in ctx.offline_origin[p1]:
        if b != EMPTY_SLOT:
            ok[b] = False
    if ctx.is_leader(p1, s1):
        ok &= ctx.leadership_candidates()
    if not ok.any():
        ctx.record_reject("excluded-broker")
        return ok
    ok &= current.accept_swap_dest(ctx, p1, s1)
    if not ok.any():
        ctx.record_reject(current.reject_reason)
        return ok
    for g in optimized:
        ok &= g.accept_swap_dest(ctx, p1, s1)
        if not ok.any():
            ctx.record_reject(g.reject_reason)
            break
    return ok


def swap_action(
    ctx: AnalyzerContext, p1: int, s1: int, p2: int, s2: int
) -> BalancingAction:
    return BalancingAction(
        ActionType.INTER_BROKER_REPLICA_SWAP,
        p1, s1, int(ctx.assignment[p1, s1]), int(ctx.assignment[p2, s2]),
        swap_partition=int(p2), swap_slot=int(s2),
    )


def move_action(ctx: AnalyzerContext, p: int, s: int, dest: int) -> BalancingAction:
    return BalancingAction(
        ActionType.INTER_BROKER_REPLICA_MOVEMENT,
        p, s, int(ctx.assignment[p, s]), int(dest),
    )


def leadership_action(ctx: AnalyzerContext, p: int, new_slot: int) -> BalancingAction:
    return BalancingAction(
        ActionType.LEADERSHIP_MOVEMENT,
        p, int(ctx.leader_slot[p]),
        ctx.leader_broker(p), int(ctx.assignment[p, new_slot]),
        dest_slot=int(new_slot),
    )


def broker_replicas(ctx: AnalyzerContext, b: int) -> List[Tuple[int, int]]:
    """All (partition, slot) pairs currently hosted on broker b."""
    ps, ss = np.nonzero(ctx.assignment == b)
    return list(zip(ps.tolist(), ss.tolist()))


def evacuate_offline_replicas(
    ctx: AnalyzerContext, current: Goal, optimized: Sequence[Goal]
) -> List[Tuple[int, int]]:
    """Move every offline replica (dead broker / broken disk) to an accepted
    destination; transfer leadership off non-leadership-eligible brokers.

    Upstream: each goal's optimize() first relocates "immigrant"/offline
    replicas (AbstractGoal + GoalUtils); the highest-priority goal does the
    heavy lifting, later goals find nothing left.  Returns replicas it could
    NOT place (hard goals treat that as failure)."""
    failed: List[Tuple[int, int]] = []
    ps, ss = np.nonzero(ctx.replica_offline & (ctx.assignment != EMPTY_SLOT))
    for p, s in zip(ps.tolist(), ss.tolist()):
        if not ctx.replica_offline[p, s]:
            continue  # earlier evacuation in this loop already fixed it
        ok = accepted_move_dests(ctx, p, s, current, optimized)
        if not ok.any():
            failed.append((p, s))
            continue
        # least-loaded eligible dest by disk utilization (stable tie-break)
        util = ctx.utilization(Resource.DISK)
        dest = int(np.argmin(np.where(ok, util, np.inf)))
        ctx.apply(move_action(ctx, p, s, dest))
    # leadership must not sit on dead/demoted brokers
    lead_ok = ctx.leadership_candidates()
    for p in range(ctx.num_partitions):
        lb = ctx.leader_broker(p)
        if lead_ok[lb]:
            continue
        moved = False
        for s in range(ctx.max_rf):
            if s == ctx.leader_slot[p] or ctx.assignment[p, s] == EMPTY_SLOT:
                continue
            if accepted_leadership(ctx, p, s, current, optimized):
                ctx.apply(leadership_action(ctx, p, s))
                moved = True
                break
        if not moved:
            failed.append((p, int(ctx.leader_slot[p])))
    return failed

"""Soft distribution goals (upstream ``analyzer/goals/ResourceDistributionGoal``
family + count-based distribution goals + PotentialNwOutGoal +
PreferredLeaderElectionGoal; SURVEY.md §2.5 soft-goal row) and the remaining
topic-scoped hard goals (MinTopicLeadersPerBrokerGoal, BrokerSetAwareGoal).

Distribution pattern (identical across resources/counts, the thing the TPU
path re-expresses as one vectorized cost): compute per-broker metric and
[lower, upper] bounds around the alive-broker average; brokers above upper
shed, brokers below lower pull; every candidate move passes chained
acceptance.  Soft goals never raise — best effort.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import EMPTY_SLOT, Resource
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal,
    OptimizationFailure,
    accepted_leadership,
    accepted_move_dests,
    accepted_swap,
    broker_replicas,
    evacuate_offline_replicas,
    leadership_action,
    move_action,
    swap_action,
    swap_partner_broker_mask,
)


class ResourceDistributionGoal(Goal):
    """Broker utilization of ``resource`` within balance bounds (soft)."""

    resource: Resource
    is_hard = False
    inputs = ("assignment", "leader_slot", "loads", "capacity",
              "broker_state")

    # ---- bounds -----------------------------------------------------------------
    def _bounds(self, ctx: AnalyzerContext) -> Tuple[np.ndarray, np.ndarray]:
        """(lower[B], upper[B]) absolute load bounds (NaN-free; dead = inf).

        Memoized per context mutation: acceptance predicates re-derive the
        bounds per candidate, and the swap fallback multiplies candidates
        by partner replicas — uncached this was the bulk of the round-5
        greedy slowdown.  The cached arrays are shared; never mutated."""
        return ctx.memo((self.name, "bounds"), lambda: self._bounds_now(ctx))

    def _bounds_now(self, ctx: AnalyzerContext) -> Tuple[np.ndarray, np.ndarray]:
        avg = ctx.avg_alive_utilization(self.resource)
        lo_u, up_u = self.constraint.balance_bounds(avg, self.resource)
        cap = ctx.broker_capacity[:, self.resource].astype(np.float64)
        # Low-utilization escape hatch (upstream low.utilization.threshold):
        # when the cluster barely uses this resource, don't churn replicas.
        if avg < self.constraint.low_utilization_threshold[self.resource]:
            return np.zeros_like(cap), np.full_like(cap, np.inf)
        return lo_u * cap, up_u * cap

    def _metric(self, ctx: AnalyzerContext) -> np.ndarray:
        return ctx.broker_load[:, self.resource]

    def _moved(self, ctx: AnalyzerContext, p: int, s: int) -> float:
        return float(ctx.replica_load_vec(p, s)[self.resource])

    # ---- acceptance -------------------------------------------------------------
    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        lo, up = self._bounds(ctx)
        delta = self._moved(ctx, p, s)
        src = int(ctx.assignment[p, s])
        m = self._metric(ctx)
        # Upstream semantics: reject if the move pushes dest above its upper
        # bound or drags an already-balanced source below its lower bound.
        if m[src] - delta < lo[src]:
            return np.zeros(ctx.num_brokers, bool)
        return m + delta <= up

    def accept_leadership(self, ctx: AnalyzerContext, p: int, new_slot: int) -> bool:
        if self.resource not in (Resource.NW_OUT, Resource.CPU):
            return True
        lo, up = self._bounds(ctx)
        delta = float(
            ctx.leader_load[p, self.resource] - ctx.follower_load[p, self.resource]
        )
        src = ctx.leader_broker(p)
        dst = int(ctx.assignment[p, new_slot])
        m = self._metric(ctx)
        return bool(m[dst] + delta <= up[dst] and m[src] - delta >= lo[src])

    def accept_swap(
        self, ctx: AnalyzerContext, p1: int, s1: int, p2: int, s2: int
    ) -> bool:
        # NET effect (upstream swap acceptance): b1 sheds l1 and gains l2,
        # b2 the reverse — a swap is acceptable exactly when the net keeps
        # both within bounds, even where either single move alone would not
        lo, up = self._bounds(ctx)
        d = self._moved(ctx, p1, s1) - self._moved(ctx, p2, s2)
        b1 = int(ctx.assignment[p1, s1])
        b2 = int(ctx.assignment[p2, s2])
        m = self._metric(ctx)
        # mirror the single-move asymmetry: the net-losing broker must not
        # drop below lower, the net-gaining broker must not exceed upper
        # (a broker already out of bounds may still improve)
        if d >= 0:  # b1 sheds d, b2 gains d
            return bool(m[b1] - d >= lo[b1] and m[b2] + d <= up[b2])
        return bool(m[b2] + d >= lo[b2] and m[b1] - d <= up[b1])

    def accept_swap_dest(self, ctx: AnalyzerContext, p1: int, s1: int) -> np.ndarray:
        # NET semantics: the verdict depends on the partner replica's load,
        # so no partner-independent necessary condition is screened here
        return np.ones(ctx.num_brokers, bool)

    # ---- scoring ----------------------------------------------------------------
    def violations(self, ctx: AnalyzerContext) -> int:
        lo, up = self._bounds(ctx)
        m = self._metric(ctx)
        out = (m > up * (1 + 1e-9)) | (m < lo * (1 - 1e-9))
        return int((out & ctx.broker_alive).sum())

    # ---- optimization -----------------------------------------------------------
    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        evacuate_offline_replicas(ctx, self, optimized)
        self._swap_attempts = 0
        r = self.resource
        lo, up = self._bounds(ctx)
        m = self._metric(ctx)
        over = np.nonzero((m > up) & ctx.broker_alive)[0]
        for b in over[np.argsort(-(m[over] - up[over]))].tolist():
            self._shed(ctx, b, optimized)
        # pull phase for under-loaded brokers
        lo, up = self._bounds(ctx)
        m = self._metric(ctx)
        under = np.nonzero((m < lo) & ctx.broker_alive & ctx.dest_candidates())[0]
        for b in under[np.argsort(m[under] - lo[under])].tolist():
            self._pull(ctx, b, optimized)

    def _try_leadership_shed(
        self, ctx: AnalyzerContext, p: int, s: int, optimized: Sequence[Goal]
    ) -> bool:
        if not ctx.is_leader(p, s) or self.resource not in (
            Resource.NW_OUT,
            Resource.CPU,
        ):
            return False
        for new_slot in range(ctx.max_rf):
            if new_slot == s or ctx.assignment[p, new_slot] == EMPTY_SLOT:
                continue
            if accepted_leadership(ctx, p, new_slot, self, optimized):
                ctx.apply(leadership_action(ctx, p, new_slot))
                return True
        return False

    def _shed(self, ctx: AnalyzerContext, b: int, optimized: Sequence[Goal]) -> None:
        r = self.resource
        replicas = broker_replicas(ctx, b)
        replicas.sort(key=lambda ps: -self._moved(ctx, *ps))
        for p, s in replicas:
            lo, up = self._bounds(ctx)
            if ctx.broker_load[b, r] <= up[b]:
                return
            if ctx.partition_excluded(p):
                continue
            if self._try_leadership_shed(ctx, p, s, optimized):
                continue
            ok = accepted_move_dests(ctx, p, s, self, optimized)
            # prefer under-loaded destinations
            if not ok.any():
                # upstream swap fallback: when no single move is accepted
                # (count-full / bound-tight destinations), trade this
                # replica for a smaller one elsewhere — net sheds load
                # while replica counts stay put
                self._try_swap_shed(ctx, p, s, optimized)
                continue
            m = self._metric(ctx) / np.maximum(ctx.broker_capacity[:, r], 1e-9)
            ctx.apply(move_action(ctx, p, s, int(np.argmin(np.where(ok, m, np.inf)))))

    #: partner brokers examined per swap attempt (coldest first) — bounds
    #: the fallback's cost on large clusters; upstream walks its sorted
    #: candidate list the same way
    SWAP_PARTNER_BROKERS = 16
    #: swap-fallback attempts allowed per optimize() pass.  Each attempt is
    #: O(partner brokers x partner replicas) of chained acceptance; on
    #: bound-tight fixtures every stuck replica reaches the fallback, and
    #: unbounded attempts made the greedy baseline ~9x slower (round-5
    #: VERDICT next #2) for marginal extra shedding
    MAX_SWAP_ATTEMPTS_PER_PASS = 256
    _swap_attempts = 0

    def _try_swap_shed(
        self, ctx: AnalyzerContext, p: int, s: int, optimized: Sequence[Goal]
    ) -> bool:
        """Swap replica (p, s) with a smaller replica of a cold broker
        (upstream ``ResourceDistributionGoal`` INTER_BROKER_REPLICA_SWAP
        fallback).  Partner replicas are tried smallest-first (largest net
        shed first); acceptance is the chained NET check."""
        if self._swap_attempts >= self.MAX_SWAP_ATTEMPTS_PER_PASS:
            ctx.record_reject("swap-cap")
            return False
        self._swap_attempts += 1
        l1 = self._moved(ctx, p, s)
        m = self._metric(ctx)
        # partner-independent screen, ONCE per attempt: structural
        # legality + every goal's accept_swap_dest over all brokers.
        # Exact — a screened-out broker could never host an accepted
        # partner, so its replicas are never enumerated (pre-screen this
        # fallback walked ~400 pairs per attempt through the full chain)
        dest_ok = swap_partner_broker_mask(ctx, p, s, self, optimized)
        if not dest_ok.any():
            return False
        cold_order = np.argsort(np.where(dest_ok, m, np.inf))
        for b2 in cold_order[: self.SWAP_PARTNER_BROKERS].tolist():
            if not dest_ok[b2]:
                continue
            partners = broker_replicas(ctx, b2)
            partners.sort(key=lambda ps: self._moved(ctx, *ps))
            for p2, s2 in partners:
                if self._moved(ctx, p2, s2) >= l1:
                    break  # ascending: nothing smaller remains
                if accepted_swap(ctx, p, s, p2, s2, self, optimized):
                    ctx.apply(swap_action(ctx, p, s, p2, s2))
                    return True
        return False

    def _pull(self, ctx: AnalyzerContext, b: int, optimized: Sequence[Goal]) -> None:
        """Move replicas from the most-loaded brokers onto under-loaded b."""
        r = self.resource
        for _ in range(ctx.num_partitions):  # bounded loop
            lo, up = self._bounds(ctx)
            if ctx.broker_load[b, r] >= lo[b]:
                return
            donors = np.argsort(-self._metric(ctx))
            moved = False
            for donor in donors.tolist():
                if donor == b or not ctx.broker_alive[donor]:
                    continue
                if ctx.broker_load[donor, r] <= lo[donor]:
                    break  # donors are sorted; nothing useful left
                for p, s in sorted(
                    broker_replicas(ctx, donor),
                    key=lambda ps: -self._moved(ctx, *ps),
                ):
                    if ctx.partition_excluded(p):
                        continue
                    ok = accepted_move_dests(ctx, p, s, self, optimized)
                    if ok[b]:
                        ctx.apply(move_action(ctx, p, s, b))
                        moved = True
                        break
                if moved:
                    break
            if not moved:
                return


class DiskUsageDistributionGoal(ResourceDistributionGoal):
    name = "DiskUsageDistributionGoal"
    resource = Resource.DISK


class NetworkInboundUsageDistributionGoal(ResourceDistributionGoal):
    name = "NetworkInboundUsageDistributionGoal"
    resource = Resource.NW_IN


class NetworkOutboundUsageDistributionGoal(ResourceDistributionGoal):
    name = "NetworkOutboundUsageDistributionGoal"
    resource = Resource.NW_OUT


class CpuUsageDistributionGoal(ResourceDistributionGoal):
    name = "CpuUsageDistributionGoal"
    resource = Resource.CPU


# ---------------------------------------------------------------------------------
# Count-based distribution goals
# ---------------------------------------------------------------------------------

class ReplicaDistributionGoal(Goal):
    """Replica counts per broker within bounds around the average (soft)."""

    name = "ReplicaDistributionGoal"
    is_hard = False
    inputs = ("assignment", "broker_state")

    def _counts(self, ctx: AnalyzerContext) -> np.ndarray:
        return ctx.broker_replica_count

    def _threshold(self) -> float:
        return self.constraint.replica_balance_threshold

    def _bounds(self, ctx: AnalyzerContext) -> Tuple[int, int]:
        def compute() -> Tuple[int, int]:
            alive = ctx.broker_alive
            avg = float(self._counts(ctx)[alive].sum() / max(alive.sum(), 1))
            return self.constraint.count_bounds(avg, self._threshold())

        return ctx.memo((self.name, "bounds"), compute)

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        lo, up = self._bounds(ctx)
        src = int(ctx.assignment[p, s])
        if self._counts(ctx)[src] - 1 < lo:
            return np.zeros(ctx.num_brokers, bool)
        return self._counts(ctx) + 1 <= up

    def accept_swap(
        self, ctx: AnalyzerContext, p1: int, s1: int, p2: int, s2: int
    ) -> bool:
        return True  # a swap preserves both brokers' replica counts

    def accept_swap_dest(self, ctx: AnalyzerContext, p1: int, s1: int) -> np.ndarray:
        return np.ones(ctx.num_brokers, bool)

    def violations(self, ctx: AnalyzerContext) -> int:
        lo, up = self._bounds(ctx)
        c = self._counts(ctx)
        return int((((c > up) | (c < lo)) & ctx.broker_alive).sum())

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        evacuate_offline_replicas(ctx, self, optimized)
        lo, up = self._bounds(ctx)
        c = self._counts(ctx)
        for b in np.nonzero((c > up) & ctx.broker_alive)[0].tolist():
            for p, s in sorted(
                broker_replicas(ctx, b),
                key=lambda ps: self._moved_size(ctx, *ps),
            ):
                if self._counts(ctx)[b] <= up:
                    break
                if ctx.partition_excluded(p):
                    continue
                ok = accepted_move_dests(ctx, p, s, self, optimized)
                ok &= self._counts(ctx) + 1 <= up
                if not ok.any():
                    continue
                counts = np.where(ok, self._counts(ctx), np.iinfo(np.int64).max)
                ctx.apply(move_action(ctx, p, s, int(np.argmin(counts))))

    def _moved_size(self, ctx: AnalyzerContext, p: int, s: int) -> float:
        # prefer moving small replicas for count balancing (cheap data moves)
        return float(ctx.replica_load_vec(p, s)[Resource.DISK])


class LeaderReplicaDistributionGoal(Goal):
    """Leader counts per broker within bounds (soft); prefers leadership
    transfers over data movement."""

    name = "LeaderReplicaDistributionGoal"
    is_hard = False
    inputs = ("assignment", "leader_slot", "broker_state")

    def _bounds(self, ctx: AnalyzerContext) -> Tuple[int, int]:
        def compute() -> Tuple[int, int]:
            alive = ctx.broker_alive
            avg = float(
                ctx.broker_leader_count[alive].sum() / max(alive.sum(), 1)
            )
            return self.constraint.count_bounds(
                avg, self.constraint.leader_replica_balance_threshold
            )

        return ctx.memo((self.name, "bounds"), compute)

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        if not ctx.is_leader(p, s):
            return np.ones(ctx.num_brokers, bool)
        lo, up = self._bounds(ctx)
        src = int(ctx.assignment[p, s])
        if ctx.broker_leader_count[src] - 1 < lo:
            return np.zeros(ctx.num_brokers, bool)
        return ctx.broker_leader_count + 1 <= up

    def accept_leadership(self, ctx: AnalyzerContext, p: int, new_slot: int) -> bool:
        lo, up = self._bounds(ctx)
        src = ctx.leader_broker(p)
        dst = int(ctx.assignment[p, new_slot])
        return bool(
            ctx.broker_leader_count[dst] + 1 <= up
            and ctx.broker_leader_count[src] - 1 >= lo
        )

    def accept_swap(
        self, ctx: AnalyzerContext, p1: int, s1: int, p2: int, s2: int
    ) -> bool:
        # leadership travels with a swapped replica: the NET per-broker
        # leader delta is −dl / +dl with dl ∈ {−1, 0, 1} (both-leaders or
        # neither-leader swaps are count-neutral)
        dl = int(ctx.is_leader(p1, s1)) - int(ctx.is_leader(p2, s2))
        if dl == 0:
            return True
        lo, up = self._bounds(ctx)
        b1 = int(ctx.assignment[p1, s1])
        b2 = int(ctx.assignment[p2, s2])
        c = ctx.broker_leader_count
        # mirror the single-move asymmetry: the losing broker must not drop
        # below lower, the gaining broker must not exceed upper (a broker
        # already out of bounds may still improve)
        loser, gainer = (b1, b2) if dl > 0 else (b2, b1)
        return bool(c[loser] - 1 >= lo and c[gainer] + 1 <= up)

    def accept_swap_dest(self, ctx: AnalyzerContext, p1: int, s1: int) -> np.ndarray:
        # NET semantics (leader delta depends on the partner's leadership)
        return np.ones(ctx.num_brokers, bool)

    def violations(self, ctx: AnalyzerContext) -> int:
        lo, up = self._bounds(ctx)
        c = ctx.broker_leader_count
        return int((((c > up) | (c < lo)) & ctx.broker_alive).sum())

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        evacuate_offline_replicas(ctx, self, optimized)
        lo, up = self._bounds(ctx)
        over = np.nonzero((ctx.broker_leader_count > up) & ctx.broker_alive)[0]
        for b in over.tolist():
            for p in np.nonzero(
                (ctx.assignment == b)
                & (
                    ctx.leader_slot[:, None]
                    == np.arange(ctx.max_rf)[None, :]
                )
            )[0].tolist():
                if ctx.broker_leader_count[b] <= up:
                    break
                if ctx.partition_excluded(p):
                    continue
                for new_slot in range(ctx.max_rf):
                    if (
                        new_slot == ctx.leader_slot[p]
                        or ctx.assignment[p, new_slot] == EMPTY_SLOT
                    ):
                        continue
                    dst = int(ctx.assignment[p, new_slot])
                    if ctx.broker_leader_count[dst] + 1 > up:
                        continue
                    if accepted_leadership(ctx, p, new_slot, self, optimized):
                        ctx.apply(leadership_action(ctx, p, new_slot))
                        break


class TopicReplicaDistributionGoal(Goal):
    """Per-topic replica counts per broker within bounds (soft)."""

    name = "TopicReplicaDistributionGoal"
    is_hard = False
    inputs = ("assignment", "topics", "broker_state")

    def _bounds_for_topic(self, ctx: AnalyzerContext, t: int) -> Tuple[int, int]:
        alive = ctx.broker_alive
        avg = float(
            ctx.broker_topic_replica_count[alive, t].sum() / max(alive.sum(), 1)
        )
        return self.constraint.count_bounds(
            avg, self.constraint.topic_replica_balance_threshold
        )

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        t = int(ctx.partition_topic[p])
        lo, up = self._bounds_for_topic(ctx, t)
        src = int(ctx.assignment[p, s])
        if ctx.broker_topic_replica_count[src, t] - 1 < lo:
            return np.zeros(ctx.num_brokers, bool)
        return ctx.broker_topic_replica_count[:, t] + 1 <= up

    def violations(self, ctx: AnalyzerContext) -> int:
        v = 0
        for t in range(ctx.num_topics):
            lo, up = self._bounds_for_topic(ctx, t)
            c = ctx.broker_topic_replica_count[:, t]
            v += int((((c > up) | (c < lo)) & ctx.broker_alive).sum())
        return v

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        evacuate_offline_replicas(ctx, self, optimized)
        for t in range(ctx.num_topics):
            if t in ctx.options.excluded_topics:
                continue
            lo, up = self._bounds_for_topic(ctx, t)
            over = np.nonzero(
                (ctx.broker_topic_replica_count[:, t] > up) & ctx.broker_alive
            )[0]
            for b in over.tolist():
                for p, s in broker_replicas(ctx, b):
                    if ctx.broker_topic_replica_count[b, t] <= up:
                        break
                    if int(ctx.partition_topic[p]) != t:
                        continue
                    ok = accepted_move_dests(ctx, p, s, self, optimized)
                    ok &= ctx.broker_topic_replica_count[:, t] + 1 <= up
                    if not ok.any():
                        continue
                    counts = np.where(
                        ok,
                        ctx.broker_topic_replica_count[:, t],
                        np.iinfo(np.int64).max,
                    )
                    ctx.apply(move_action(ctx, p, s, int(np.argmin(counts))))


class LeaderBytesInDistributionGoal(Goal):
    """Leader bytes-in per broker balanced (soft); leadership-transfer based."""

    name = "LeaderBytesInDistributionGoal"
    is_hard = False
    inputs = ("assignment", "leader_slot", "loads", "capacity",
              "broker_state")

    def _bounds(self, ctx: AnalyzerContext) -> Tuple[np.ndarray, np.ndarray]:
        def compute() -> Tuple[np.ndarray, np.ndarray]:
            alive = ctx.broker_alive
            total = ctx.broker_leader_load[:, Resource.NW_IN].sum()
            cap = ctx.broker_capacity[:, Resource.NW_IN].astype(np.float64)
            avg = total / max(cap[alive].sum(), 1e-9)
            lo_u, up_u = self.constraint.balance_bounds(avg, Resource.NW_IN)
            return lo_u * cap, up_u * cap

        return ctx.memo((self.name, "bounds"), compute)

    def accept_leadership(self, ctx: AnalyzerContext, p: int, new_slot: int) -> bool:
        lo, up = self._bounds(ctx)
        dst = int(ctx.assignment[p, new_slot])
        add = float(ctx.leader_load[p, Resource.NW_IN])
        return bool(
            ctx.broker_leader_load[dst, Resource.NW_IN] + add <= up[dst]
        )

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        if not ctx.is_leader(p, s):
            return np.ones(ctx.num_brokers, bool)
        lo, up = self._bounds(ctx)
        add = float(ctx.leader_load[p, Resource.NW_IN])
        return ctx.broker_leader_load[:, Resource.NW_IN] + add <= up

    def violations(self, ctx: AnalyzerContext) -> int:
        lo, up = self._bounds(ctx)
        m = ctx.broker_leader_load[:, Resource.NW_IN]
        return int(((m > up * (1 + 1e-9)) & ctx.broker_alive).sum())

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        evacuate_offline_replicas(ctx, self, optimized)
        lo, up = self._bounds(ctx)
        m = ctx.broker_leader_load[:, Resource.NW_IN]
        over = np.nonzero((m > up) & ctx.broker_alive)[0]
        for b in over[np.argsort(-(m[over] - up[over]))].tolist():
            leaders = [
                p
                for p in range(ctx.num_partitions)
                if ctx.leader_broker(p) == b
            ]
            leaders.sort(key=lambda p: -float(ctx.leader_load[p, Resource.NW_IN]))
            for p in leaders:
                if ctx.broker_leader_load[b, Resource.NW_IN] <= up[b]:
                    break
                if ctx.partition_excluded(p):
                    continue
                best, best_load = -1, np.inf
                for new_slot in range(ctx.max_rf):
                    if (
                        new_slot == ctx.leader_slot[p]
                        or ctx.assignment[p, new_slot] == EMPTY_SLOT
                    ):
                        continue
                    dst = int(ctx.assignment[p, new_slot])
                    if accepted_leadership(ctx, p, new_slot, self, optimized):
                        dl = float(ctx.broker_leader_load[dst, Resource.NW_IN])
                        if dl < best_load:
                            best, best_load = new_slot, dl
                if best >= 0:
                    ctx.apply(leadership_action(ctx, p, best))


class PotentialNwOutGoal(Goal):
    """Potential (all-leadership) outbound bandwidth per broker under the
    outbound capacity limit (soft)."""

    name = "PotentialNwOutGoal"
    is_hard = False
    inputs = ("assignment", "loads", "capacity", "broker_state")

    def _limits(self, ctx: AnalyzerContext) -> np.ndarray:
        return (
            ctx.broker_capacity[:, Resource.NW_OUT].astype(np.float64)
            * self.constraint.capacity_threshold[Resource.NW_OUT]
        )

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        pot = float(ctx.leader_load[p, Resource.NW_OUT])
        return ctx.broker_potential_nw_out + pot <= self._limits(ctx)

    def violations(self, ctx: AnalyzerContext) -> int:
        over = ctx.broker_potential_nw_out > self._limits(ctx) * (1 + 1e-9)
        return int((over & ctx.broker_alive).sum())

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        evacuate_offline_replicas(ctx, self, optimized)
        limits = self._limits(ctx)
        over = np.nonzero(
            (ctx.broker_potential_nw_out > limits) & ctx.broker_alive
        )[0]
        for b in over.tolist():
            replicas = broker_replicas(ctx, b)
            replicas.sort(
                key=lambda ps: -float(ctx.leader_load[ps[0], Resource.NW_OUT])
            )
            for p, s in replicas:
                if ctx.broker_potential_nw_out[b] <= limits[b]:
                    break
                if ctx.partition_excluded(p):
                    continue
                ok = accepted_move_dests(ctx, p, s, self, optimized)
                if not ok.any():
                    continue
                pot = np.where(ok, ctx.broker_potential_nw_out, np.inf)
                ctx.apply(move_action(ctx, p, s, int(np.argmin(pot))))


class PreferredLeaderElectionGoal(Goal):
    """Make the preferred replica (slot 0) the leader wherever eligible
    (upstream PreferredLeaderElectionGoal, kafka-assigner mode)."""

    name = "PreferredLeaderElectionGoal"
    is_hard = False
    inputs = ("assignment", "leader_slot", "broker_state")

    def violations(self, ctx: AnalyzerContext) -> int:
        lead_ok = ctx.leadership_candidates()
        v = 0
        for p in range(ctx.num_partitions):
            cur = ctx.leader_broker(p)
            if not lead_ok[cur]:
                # leader sits on an ineligible (demoted/excluded) broker
                if any(
                    ctx.assignment[p, s] != EMPTY_SLOT
                    and lead_ok[ctx.assignment[p, s]]
                    for s in range(ctx.max_rf)
                ):
                    v += 1
            elif ctx.leader_slot[p] != 0 and lead_ok[ctx.assignment[p, 0]]:
                v += 1
        return v

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        lead_ok = ctx.leadership_candidates()
        for p in range(ctx.num_partitions):
            cur = ctx.leader_broker(p)
            # preferred slot first, then any eligible slot if the current
            # leader is ineligible (demoted-broker evacuation semantics)
            slots = [0] if lead_ok[cur] else list(range(ctx.max_rf))
            for s in slots:
                if s == ctx.leader_slot[p]:
                    continue
                b = ctx.assignment[p, s]
                if b == EMPTY_SLOT or not lead_ok[b]:
                    continue
                if accepted_leadership(ctx, p, s, self, optimized):
                    ctx.apply(leadership_action(ctx, p, s))
                    break


class MinTopicLeadersPerBrokerGoal(Goal):
    """Configured topics must keep ≥ k leaders on every alive broker (hard;
    vacuous when no topics are configured — the upstream default)."""

    name = "MinTopicLeadersPerBrokerGoal"
    is_hard = True
    inputs = ("assignment", "leader_slot", "topics", "broker_state")

    def _applies(self) -> bool:
        return (
            self.constraint.min_topic_leaders_per_broker > 0
            and bool(self.constraint.min_topic_leaders_topics)
        )

    def accept_leadership(self, ctx: AnalyzerContext, p: int, new_slot: int) -> bool:
        if not self._applies():
            return True
        t = int(ctx.partition_topic[p])
        if t not in self.constraint.min_topic_leaders_topics:
            return True
        src = ctx.leader_broker(p)
        k = self.constraint.min_topic_leaders_per_broker
        return bool(ctx.broker_topic_leader_count[src, t] - 1 >= k)

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        if not self._applies() or not ctx.is_leader(p, s):
            return np.ones(ctx.num_brokers, bool)
        t = int(ctx.partition_topic[p])
        if t not in self.constraint.min_topic_leaders_topics:
            return np.ones(ctx.num_brokers, bool)
        src = int(ctx.assignment[p, s])
        k = self.constraint.min_topic_leaders_per_broker
        if ctx.broker_topic_leader_count[src, t] - 1 < k:
            return np.zeros(ctx.num_brokers, bool)
        return np.ones(ctx.num_brokers, bool)

    def violations(self, ctx: AnalyzerContext) -> int:
        if not self._applies():
            return 0
        k = self.constraint.min_topic_leaders_per_broker
        v = 0
        eligible = ctx.broker_alive & ~ctx.broker_demoted
        for t in self.constraint.min_topic_leaders_topics:
            short = ctx.broker_topic_leader_count[:, t] < k
            v += int((short & eligible).sum())
        return v

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        failed = evacuate_offline_replicas(ctx, self, optimized)
        if failed:
            raise OptimizationFailure(
                f"{self.name}: {len(failed)} offline replicas could not be placed"
            )
        if not self._applies():
            return
        k = self.constraint.min_topic_leaders_per_broker
        eligible = np.nonzero(ctx.broker_alive & ~ctx.broker_demoted)[0]
        for t in sorted(self.constraint.min_topic_leaders_topics):
            for b in eligible.tolist():
                while ctx.broker_topic_leader_count[b, t] < k:
                    if not self._grant_leader(ctx, optimized, t, int(b)):
                        raise OptimizationFailure(
                            f"{self.name}: broker {b} cannot reach {k} leaders "
                            f"of topic {t}"
                        )

    def _grant_leader(
        self, ctx: AnalyzerContext, optimized: Sequence[Goal], t: int, b: int
    ) -> bool:
        # find a partition of t with a follower on b whose leadership can move
        for p in range(ctx.num_partitions):
            if int(ctx.partition_topic[p]) != t or ctx.leader_broker(p) == b:
                continue
            for s in range(ctx.max_rf):
                if ctx.assignment[p, s] == b and s != ctx.leader_slot[p]:
                    if accepted_leadership(ctx, p, s, self, optimized):
                        ctx.apply(leadership_action(ctx, p, s))
                        return True
        return False


class BrokerSetAwareGoal(Goal):
    """Topic replicas confined to their configured broker set (hard; vacuous
    without brokerset config — the upstream default)."""

    name = "BrokerSetAwareGoal"
    is_hard = True
    inputs = ("assignment", "topics", "broker_state")
    reject_reason = "excluded-broker"

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        t = int(ctx.partition_topic[p])
        allowed = self.constraint.broker_sets.get(t)
        if allowed is None:
            return np.ones(ctx.num_brokers, bool)
        mask = np.zeros(ctx.num_brokers, bool)
        mask[list(allowed)] = True
        return mask

    def violations(self, ctx: AnalyzerContext) -> int:
        v = 0
        for t, allowed in self.constraint.broker_sets.items():
            if t in ctx.options.excluded_topics:
                continue
            in_topic = ctx.partition_topic == t
            brokers = ctx.assignment[in_topic]
            ok = np.isin(brokers, list(allowed)) | (brokers == EMPTY_SLOT)
            v += int((~ok).sum())
        return v

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        failed = evacuate_offline_replicas(ctx, self, optimized)
        if failed:
            raise OptimizationFailure(
                f"{self.name}: {len(failed)} offline replicas could not be placed"
            )
        if not self.constraint.broker_sets:
            return
        for p in range(ctx.num_partitions):
            if ctx.partition_excluded(p):
                continue
            t = int(ctx.partition_topic[p])
            allowed = self.constraint.broker_sets.get(t)
            if allowed is None:
                continue
            for s in range(ctx.max_rf):
                b = ctx.assignment[p, s]
                if b == EMPTY_SLOT or int(b) in allowed:
                    continue
                ok = accepted_move_dests(ctx, p, s, self, optimized)
                if not ok.any():
                    raise OptimizationFailure(
                        f"{self.name}: partition {p} replica {s} cannot enter "
                        f"broker set of topic {t}"
                    )
                util = ctx.utilization(Resource.DISK)
                ctx.apply(
                    move_action(ctx, p, s, int(np.argmin(np.where(ok, util, np.inf))))
                )

"""Hard capacity goals (upstream ``analyzer/goals/CapacityGoal.java`` family:
ReplicaCapacityGoal, DiskCapacityGoal, NetworkInbound/OutboundCapacityGoal,
CpuCapacityGoal; SURVEY.md §2.5 hard-goal row).

Invariant per alive broker: utilization ≤ capacity × capacity.threshold.
Violating brokers shed replicas (largest-for-the-resource first) to the
least-utilized accepted destination; leadership-bound resources (NW_OUT, CPU)
also shed by transferring leadership.
"""

from __future__ import annotations

from typing import List, Sequence

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


class ReplicaCapacityGoal(Goal):
    """Broker replica count ≤ max.replicas.per.broker (hard)."""

    name = "ReplicaCapacityGoal"
    is_hard = True
    reject_reason = "capacity-exceeded"
    inputs = ("assignment", "broker_state")

    def _limit(self) -> int:
        return self.constraint.max_replicas_per_broker

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        return ctx.broker_replica_count + 1 <= self._limit()

    def accept_swap(
        self, ctx: AnalyzerContext, p1: int, s1: int, p2: int, s2: int
    ) -> bool:
        # a swap preserves both brokers' replica counts — the key unlock on
        # count-saturated clusters, where accept_move rejects every
        # destination and only swaps can still rebalance (upstream
        # ReplicaCapacityGoal actionAcceptance for REPLICA_SWAP)
        return True

    def accept_swap_dest(self, ctx: AnalyzerContext, p1: int, s1: int) -> np.ndarray:
        return np.ones(ctx.num_brokers, bool)

    def violations(self, ctx: AnalyzerContext) -> int:
        over = ctx.broker_replica_count > self._limit()
        return int((over & ctx.broker_alive).sum())

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        failed = evacuate_offline_replicas(ctx, self, optimized)
        if failed:
            raise OptimizationFailure(
                f"{self.name}: {len(failed)} offline replicas could not be placed"
            )
        limit = self._limit()
        for b in np.nonzero(ctx.broker_replica_count > limit)[0].tolist():
            replicas = broker_replicas(ctx, b)
            for p, s in replicas:
                if ctx.broker_replica_count[b] <= limit:
                    break
                if ctx.partition_excluded(p):
                    continue
                ok = accepted_move_dests(ctx, p, s, self, optimized)
                if not ok.any():
                    continue
                counts = np.where(ok, ctx.broker_replica_count, np.iinfo(np.int64).max)
                ctx.apply(move_action(ctx, p, s, int(np.argmin(counts))))
            if ctx.broker_replica_count[b] > limit and ctx.broker_alive[b]:
                raise OptimizationFailure(
                    f"{self.name}: broker {b} stuck at "
                    f"{int(ctx.broker_replica_count[b])} > {limit}"
                )


class CapacityGoal(Goal):
    """Resource capacity goal (hard); subclasses pin ``resource``.

    All checks run on the context's CAPACITY-ESTIMATE loads
    (``broker_cap_load`` / ``replica_cap_load_vec``): the percentile over
    the model's window series when ``ClusterState.capacity_percentile`` is
    set (upstream ``model/Load.java`` window semantics — provision for
    peak, not mean), and exactly the mean loads otherwise.
    """

    resource: Resource
    is_hard = True
    reject_reason = "capacity-exceeded"
    inputs = ("assignment", "leader_slot", "loads", "capacity",
              "broker_state")

    def _limits(self, ctx: AnalyzerContext) -> np.ndarray:
        """f64 [B] — absolute load limit per broker (capacity × threshold
        never changes during an optimization, so the array is cached for
        the context's lifetime and frozen)."""
        return ctx.static_memo(
            (self.name, "limits"),
            lambda: ctx.broker_capacity[:, self.resource].astype(np.float64)
            * self.constraint.capacity_threshold[self.resource],
        )

    def _moved_load(self, ctx: AnalyzerContext, p: int, s: int) -> float:
        return float(ctx.replica_cap_load_vec(p, s)[self.resource])

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        delta = self._moved_load(ctx, p, s)
        return ctx.broker_cap_load[:, self.resource] + delta <= self._limits(ctx)

    def accept_leadership(self, ctx: AnalyzerContext, p: int, new_slot: int) -> bool:
        if self.resource not in (Resource.NW_OUT, Resource.CPU):
            return True
        delta = float(
            ctx.leader_cap_load[p, self.resource]
            - ctx.follower_cap_load[p, self.resource]
        )
        dst = ctx.assignment[p, new_slot]
        return bool(
            ctx.broker_cap_load[dst, self.resource] + delta
            <= self._limits(ctx)[dst]
        )

    def accept_swap(
        self, ctx: AnalyzerContext, p1: int, s1: int, p2: int, s2: int
    ) -> bool:
        # NET capacity check: b1 sheds l1 and absorbs l2, b2 the reverse —
        # acceptable when both stay under their limit even if either single
        # move alone would overflow (upstream CapacityGoal swap acceptance).
        # Asymmetry for an already-over-limit shedding broker (upstream
        # swap acceptance): a net-shedding swap that STRICTLY reduces its
        # load is accepted even though one swap cannot get it under the
        # limit — repeated swaps then converge instead of the goal raising
        # OptimizationFailure on the first one.  The partner must stay
        # within its limit either way.
        d = self._moved_load(ctx, p1, s1) - self._moved_load(ctx, p2, s2)
        b1 = int(ctx.assignment[p1, s1])
        b2 = int(ctx.assignment[p2, s2])
        lim = self._limits(ctx)
        cl = ctx.broker_cap_load[:, self.resource]
        if d > 0 and cl[b1] > lim[b1]:  # b1 over limit, swap net-sheds it
            return bool(cl[b2] + d <= lim[b2])
        if d < 0 and cl[b2] > lim[b2]:  # b2 over limit, swap net-sheds it
            return bool(cl[b1] - d <= lim[b1])
        return bool(cl[b1] - d <= lim[b1] and cl[b2] + d <= lim[b2])

    def accept_swap_dest(self, ctx: AnalyzerContext, p1: int, s1: int) -> np.ndarray:
        # NET semantics: the verdict depends on the partner replica's load
        return np.ones(ctx.num_brokers, bool)

    def violations(self, ctx: AnalyzerContext) -> int:
        over = ctx.broker_cap_load[:, self.resource] > self._limits(ctx) * (1 + 1e-9)
        return int((over & ctx.broker_alive).sum())

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        failed = evacuate_offline_replicas(ctx, self, optimized)
        if failed:
            raise OptimizationFailure(
                f"{self.name}: {len(failed)} offline replicas could not be placed"
            )
        self._swap_attempts = 0
        limits = self._limits(ctx)
        r = self.resource
        over_brokers = np.nonzero(
            (ctx.broker_cap_load[:, r] > limits) & ctx.broker_alive
        )[0]
        # most-overloaded first
        order = np.argsort(
            -(ctx.broker_cap_load[over_brokers, r] - limits[over_brokers])
        )
        for b in over_brokers[order].tolist():
            self._shed(ctx, b, optimized)
            if ctx.broker_cap_load[b, r] > self._limits(ctx)[b] * (1 + 1e-9):
                raise OptimizationFailure(
                    f"{self.name}: broker {b} stuck over capacity "
                    f"({ctx.broker_cap_load[b, r]:.1f} > "
                    f"{self._limits(ctx)[b]:.1f})"
                )

    def _shed(self, ctx: AnalyzerContext, b: int, optimized: Sequence[Goal]) -> None:
        r = self.resource
        limit = self._limits(ctx)[b]
        replicas = broker_replicas(ctx, b)
        # biggest contribution first
        replicas.sort(key=lambda ps: -self._moved_load(ctx, *ps))
        for p, s in replicas:
            if ctx.broker_cap_load[b, r] <= limit:
                return
            if ctx.partition_excluded(p):
                continue
            # leadership-bound resources: try handing off leadership first —
            # cheaper than a data move (no replication traffic)
            if ctx.is_leader(p, s) and r in (Resource.NW_OUT, Resource.CPU):
                done = False
                for new_slot in range(ctx.max_rf):
                    if new_slot == s or ctx.assignment[p, new_slot] == EMPTY_SLOT:
                        continue
                    if accepted_leadership(ctx, p, new_slot, self, optimized):
                        ctx.apply(leadership_action(ctx, p, new_slot))
                        done = True
                        break
                if done:
                    continue
            ok = accepted_move_dests(ctx, p, s, self, optimized)
            if not ok.any():
                # upstream swap fallback: on count- or capacity-saturated
                # clusters a one-way move overflows every destination, but
                # trading this replica for a smaller one still sheds load
                self._try_swap_shed(ctx, p, s, optimized)
                continue
            util = ctx.broker_load[:, r] / np.maximum(ctx.broker_capacity[:, r], 1e-9)
            ctx.apply(move_action(ctx, p, s, int(np.argmin(np.where(ok, util, np.inf)))))

    #: partner brokers examined per swap attempt (least-utilized first)
    SWAP_PARTNER_BROKERS = 16
    #: swap-fallback attempts per optimize() pass (hard-goal twin of the
    #: distribution cap; higher because capacity repair MUST make progress
    #: and a starved fallback turns into OptimizationFailure)
    MAX_SWAP_ATTEMPTS_PER_PASS = 1024
    _swap_attempts = 0

    def _try_swap_shed(
        self, ctx: AnalyzerContext, p: int, s: int, optimized: Sequence[Goal]
    ) -> bool:
        """Swap (p, s) off its over-capacity broker for a smaller replica of
        a low-utilization broker; chained NET acceptance (hard-goal twin of
        the ResourceDistributionGoal fallback)."""
        if self._swap_attempts >= self.MAX_SWAP_ATTEMPTS_PER_PASS:
            ctx.record_reject("swap-cap")
            return False
        self._swap_attempts += 1
        r = self.resource
        l1 = self._moved_load(ctx, p, s)
        util = ctx.broker_cap_load[:, r] / np.maximum(
            ctx.broker_capacity[:, r], 1e-9
        )
        # partner-independent screen, ONCE per attempt (see the
        # ResourceDistributionGoal fallback): exact, so screened brokers'
        # replicas are never enumerated
        dest_ok = swap_partner_broker_mask(ctx, p, s, self, optimized)
        if not dest_ok.any():
            return False
        order = np.argsort(np.where(dest_ok, util, np.inf))
        for b2 in order[: self.SWAP_PARTNER_BROKERS].tolist():
            if not dest_ok[b2]:
                continue
            partners = broker_replicas(ctx, b2)
            partners.sort(key=lambda ps: self._moved_load(ctx, *ps))
            for p2, s2 in partners:
                if self._moved_load(ctx, p2, s2) >= l1:
                    break  # ascending: no net shed remains
                if accepted_swap(ctx, p, s, p2, s2, self, optimized):
                    ctx.apply(swap_action(ctx, p, s, p2, s2))
                    return True
        return False


class DiskCapacityGoal(CapacityGoal):
    name = "DiskCapacityGoal"
    resource = Resource.DISK


class NetworkInboundCapacityGoal(CapacityGoal):
    name = "NetworkInboundCapacityGoal"
    resource = Resource.NW_IN


class NetworkOutboundCapacityGoal(CapacityGoal):
    name = "NetworkOutboundCapacityGoal"
    resource = Resource.NW_OUT


class CpuCapacityGoal(CapacityGoal):
    name = "CpuCapacityGoal"
    resource = Resource.CPU

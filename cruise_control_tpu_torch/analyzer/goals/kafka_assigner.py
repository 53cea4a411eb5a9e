"""Kafka-assigner mode goals (upstream ``analyzer/kafkaassigner/
KafkaAssignerEvenRackAwareGoal.java`` / ``KafkaAssignerDiskUsageDistributionGoal
.java``; SURVEY.md §2.5) — the legacy ``kafka-assigner`` tool replacement.

Characteristics that distinguish them from the main stack:
- EvenRackAware: replicas of a partition sit on distinct racks AND the
  per-rack replica totals stay even (strict round-robin spirit).
- DiskUsageDistribution: balances broker disk utilization exclusively via
  replica SWAPS, so per-broker replica counts never change.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import EMPTY_SLOT, Resource
from cruise_control_tpu_torch.analyzer.actions import ActionType, BalancingAction
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal,
    OptimizationFailure,
    accepted_move_dests,
    evacuate_offline_replicas,
    move_action,
)


class KafkaAssignerEvenRackAwareGoal(Goal):
    """Hard: rack-distinct replicas + even per-rack replica totals."""

    name = "KafkaAssignerEvenRackAwareGoal"
    is_hard = True
    inputs = ("assignment", "leader_slot", "racks", "broker_state",
              "offline")
    reject_reason = "rack-violation"

    def _rack_totals(self, ctx: AnalyzerContext) -> np.ndarray:
        totals = np.zeros(ctx.num_brokers, np.int64)  # indexed by rack id
        for b in range(ctx.num_brokers):
            totals[ctx.broker_rack[b]] += ctx.broker_replica_count[b]
        return totals

    def _even_bound(self, ctx: AnalyzerContext) -> int:
        alive_racks = np.unique(ctx.broker_rack[ctx.broker_alive])
        total = int(ctx.broker_replica_count.sum())
        return -(-total // max(len(alive_racks), 1))  # ceil

    def violations(self, ctx: AnalyzerContext) -> int:
        v = 0
        for p in range(ctx.num_partitions):
            racks = [
                ctx.broker_rack[b]
                for b in ctx.assignment[p]
                if b != EMPTY_SLOT
            ]
            v += len(racks) - len(set(racks))
        totals = self._rack_totals(ctx)
        bound = self._even_bound(ctx)
        alive_racks = np.unique(ctx.broker_rack[ctx.broker_alive])
        v += int(sum(max(0, totals[r] - bound) for r in alive_racks))
        return v

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        """A destination is acceptable if it doesn't collide with the
        partition's other racks (the even-total part is re-optimized, not
        vetoed, matching upstream's lenient acceptance)."""
        other_racks = {
            int(ctx.broker_rack[b])
            for i, b in enumerate(ctx.assignment[p])
            if b != EMPTY_SLOT and i != s
        }
        ok = np.ones(ctx.num_brokers, bool)
        for b in range(ctx.num_brokers):
            if int(ctx.broker_rack[b]) in other_racks:
                ok[b] = False
        return ok

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        failed = evacuate_offline_replicas(ctx, self, optimized)
        if failed:
            raise OptimizationFailure(
                f"{self.name}: {len(failed)} offline replicas stuck"
            )
        # 1. rack-distinctness (same machinery as RackAwareGoal)
        for p in range(ctx.num_partitions):
            seen: dict = {}
            for s in range(ctx.max_rf):
                b = int(ctx.assignment[p, s])
                if b == EMPTY_SLOT:
                    continue
                rack = int(ctx.broker_rack[b])
                if rack not in seen:
                    seen[rack] = s
                    continue
                ok = accepted_move_dests(ctx, p, s, self, optimized)
                # prefer racks not used by this partition at all, then the
                # rack with the lowest replica total (evenness pressure)
                totals = self._rack_totals(ctx)
                dests = np.nonzero(ok)[0]
                if dests.size == 0:
                    raise OptimizationFailure(
                        f"{self.name}: partition {p} cannot be made "
                        f"rack-distinct"
                    )
                dest = min(
                    dests.tolist(),
                    key=lambda b2: (totals[ctx.broker_rack[b2]],
                                    ctx.broker_replica_count[b2], b2),
                )
                ctx.apply(move_action(ctx, p, s, int(dest)))
        # 2. evenness: drain racks above the ceil bound
        bound = self._even_bound(ctx)
        for _ in range(ctx.num_partitions * ctx.max_rf):
            totals = self._rack_totals(ctx)
            alive_racks = np.unique(ctx.broker_rack[ctx.broker_alive])
            over = [r for r in alive_racks.tolist() if totals[r] > bound]
            if not over:
                break
            moved = False
            r_hot = max(over, key=lambda r: totals[r])
            for b in np.argsort(-ctx.broker_replica_count).tolist():
                if ctx.broker_rack[b] != r_hot:
                    continue
                for p, s in zip(*np.nonzero(ctx.assignment == b)):
                    ok = accepted_move_dests(
                        ctx, int(p), int(s), self, optimized
                    )
                    dests = [
                        d for d in np.nonzero(ok)[0].tolist()
                        if totals[ctx.broker_rack[d]] < bound
                    ]
                    if dests:
                        dest = min(
                            dests,
                            key=lambda d: (totals[ctx.broker_rack[d]],
                                           ctx.broker_replica_count[d], d),
                        )
                        ctx.apply(move_action(ctx, int(p), int(s), int(dest)))
                        moved = True
                        break
                if moved:
                    break
            if not moved:
                break  # nothing movable: totals as even as acceptance allows


class KafkaAssignerDiskUsageDistributionGoal(Goal):
    """Soft: balance broker disk utilization via swaps only (replica counts
    preserved — the kafka-assigner contract)."""

    name = "KafkaAssignerDiskUsageDistributionGoal"
    is_hard = False
    inputs = ("assignment", "leader_slot", "loads", "capacity",
              "broker_state")

    def _bounds(self, ctx: AnalyzerContext) -> Tuple[float, float]:
        avg = ctx.avg_alive_utilization(Resource.DISK)
        return self.constraint.balance_bounds(avg, Resource.DISK)

    def violations(self, ctx: AnalyzerContext) -> int:
        lo, hi = self._bounds(ctx)
        util = ctx.utilization(Resource.DISK)
        alive = ctx.broker_alive
        return int(((util < lo - 1e-9) | (util > hi + 1e-9))[alive].sum())

    def _swap_candidates(self, ctx: AnalyzerContext, b: int
                         ) -> List[Tuple[float, int, int]]:
        out = []
        for p, s in zip(*np.nonzero(ctx.assignment == b)):
            if ctx.partition_excluded(int(p)):
                continue
            out.append((
                float(ctx.replica_load_vec(int(p), int(s))[Resource.DISK]),
                int(p), int(s),
            ))
        out.sort(reverse=True)
        return out

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        lo, hi = self._bounds(ctx)
        cap = np.maximum(ctx.broker_capacity[:, Resource.DISK], 1e-9)
        for _ in range(ctx.num_partitions):
            util = ctx.broker_load[:, Resource.DISK] / cap
            util = np.where(ctx.broker_alive, util, -np.inf)
            hot = int(util.argmax())
            if util[hot] <= hi + 1e-9:
                return  # balanced
            cold = int(np.where(ctx.broker_alive, util, np.inf).argmin())
            if hot == cold:
                return
            if not self._swap_once(ctx, optimized, hot, cold):
                return  # no improving swap available

    def _swap_once(self, ctx: AnalyzerContext, optimized: Sequence[Goal],
                   hot: int, cold: int) -> bool:
        gap = (ctx.broker_load[hot, Resource.DISK]
               - ctx.broker_load[cold, Resource.DISK])
        for l1, p1, s1 in self._swap_candidates(ctx, hot):
            for l2, p2, s2 in self._swap_candidates(ctx, cold):
                delta = l1 - l2
                # the swap must shrink the gap without overshooting
                if delta <= 0 or delta >= gap:
                    continue
                if p1 == p2:
                    continue
                # neither partition may already sit on the other broker
                if cold in ctx.assignment[p1] or hot in ctx.assignment[p2]:
                    continue
                if not self._accepted_both_ways(
                    ctx, optimized, p1, s1, cold, p2, s2, hot
                ):
                    continue
                ctx.apply(BalancingAction(
                    ActionType.INTER_BROKER_REPLICA_SWAP,
                    p1, s1, hot, cold,
                    swap_partition=p2, swap_slot=s2,
                ))
                return True
        return False

    @staticmethod
    def _accepted_both_ways(ctx, optimized, p1, s1, dest1, p2, s2, dest2
                            ) -> bool:
        for goal in optimized:
            if not goal.accept_move(ctx, p1, s1)[dest1]:
                return False
            if not goal.accept_move(ctx, p2, s2)[dest2]:
                return False
        return True

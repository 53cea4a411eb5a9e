"""Intra-broker (JBOD) goals — disk-to-disk balancing within one broker
(upstream ``analyzer/goals/intrabroker/IntraBrokerDiskCapacityGoal.java`` /
``IntraBrokerDiskUsageDistributionGoal.java``; SURVEY.md §2.5).

Both goals emit only ``INTRA_BROKER_REPLICA_MOVEMENT`` actions (disk index
changes; the replica never leaves its broker), so they compose with the
inter-broker stack without disturbing placement.  Vacuous on models without
per-disk data."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.analyzer.actions import ActionType, BalancingAction
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.goals.base import Goal, OptimizationFailure


def _disk_replicas(ctx: AnalyzerContext, b: int, d: int) -> List[Tuple[int, int]]:
    """(partition, slot) replicas on disk d of broker b, largest disk-load
    first (upstream moves big replicas first for fewer moves)."""
    out = []
    ps, ss = np.nonzero((ctx.assignment == b) & (ctx.replica_disk == d))
    for p, s in zip(ps.tolist(), ss.tolist()):
        out.append((ctx.replica_load_vec(p, s)[Resource.DISK], p, s))
    out.sort(reverse=True)
    return [(p, s) for _, p, s in out]


def _intra_action(ctx: AnalyzerContext, p: int, s: int, d_dst: int
                  ) -> BalancingAction:
    b = int(ctx.assignment[p, s])
    return BalancingAction(
        ActionType.INTRA_BROKER_REPLICA_MOVEMENT,
        p, s, b, b,
        source_disk=int(ctx.replica_disk[p, s]),
        dest_disk=d_dst,
    )


class IntraBrokerDiskCapacityGoal(Goal):
    """Hard: every healthy disk's load stays under capacity × threshold, and
    no replica remains on an offline disk when a healthy one has room."""

    name = "IntraBrokerDiskCapacityGoal"
    is_hard = True
    inputs = ("assignment", "leader_slot", "loads", "disks",
              "broker_state")
    reject_reason = "capacity-exceeded"

    def _threshold(self) -> float:
        return self.constraint.capacity_threshold[Resource.DISK]

    def accept_intra_move(self, ctx: AnalyzerContext, p: int, s: int,
                          dest_disk: int) -> bool:
        """Acceptance chaining for later intra goals: the destination disk
        must stay under the capacity threshold."""
        b = int(ctx.assignment[p, s])
        load = ctx.replica_load_vec(p, s)[Resource.DISK]
        cap = ctx.disk_capacity[b, dest_disk] * self._threshold()
        return bool(ctx.disk_load[b, dest_disk] + load <= cap + 1e-6)

    def violations(self, ctx: AnalyzerContext) -> int:
        if ctx.disk_load is None:
            return 0
        thr = self._threshold()
        v = 0
        for b in np.nonzero(ctx.broker_alive)[0].tolist():
            ok = ctx.disk_alive_mask(b)
            over = ctx.disk_load[b] > ctx.disk_capacity[b] * thr + 1e-6
            v += int((over & ok).sum())
            if ctx.disk_offline is not None:
                # replicas stuck on failed disks count too
                dead = np.nonzero(ctx.disk_offline[b])[0]
                for d in dead.tolist():
                    v += len(_disk_replicas(ctx, b, int(d)))
        return v

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        if ctx.disk_load is None:
            return
        thr = self._threshold()
        for b in np.nonzero(ctx.broker_alive)[0].tolist():
            ok = ctx.disk_alive_mask(b)
            if not ok.any():
                continue
            # 1. evacuate failed disks
            if ctx.disk_offline is not None:
                for d in np.nonzero(ctx.disk_offline[b])[0].tolist():
                    for p, s in _disk_replicas(ctx, b, d):
                        dst = ctx.least_loaded_disk(int(b))
                        if dst < 0:
                            raise OptimizationFailure(
                                f"{self.name}: no healthy disk on broker {b}"
                            )
                        ctx.apply(_intra_action(ctx, p, s, dst))
            # 2. relieve over-threshold disks
            for d in np.argsort(-ctx.disk_load[b]).tolist():
                if not ok[d]:
                    continue
                cap = ctx.disk_capacity[b, d] * thr
                if ctx.disk_load[b, d] <= cap + 1e-6:
                    continue
                for p, s in _disk_replicas(ctx, b, d):
                    if ctx.disk_load[b, d] <= cap + 1e-6:
                        break
                    load = ctx.replica_load_vec(p, s)[Resource.DISK]
                    # smallest destination that keeps its own bound
                    util = ctx.disk_load[b] / np.maximum(ctx.disk_capacity[b], 1e-9)
                    for dst in np.argsort(util).tolist():
                        if dst == d or not ok[dst]:
                            continue
                        if (ctx.disk_load[b, dst] + load
                                <= ctx.disk_capacity[b, dst] * thr + 1e-6):
                            ctx.apply(_intra_action(ctx, p, s, int(dst)))
                            break
                if ctx.disk_load[b, d] > cap + 1e-6:
                    raise OptimizationFailure(
                        f"{self.name}: disk {d} of broker {b} cannot fit "
                        f"under {thr:.0%}"
                    )


class IntraBrokerDiskUsageDistributionGoal(Goal):
    """Soft: each broker's healthy disks stay within the balance threshold of
    that broker's mean disk utilization."""

    name = "IntraBrokerDiskUsageDistributionGoal"
    is_hard = False
    inputs = ("assignment", "leader_slot", "loads", "disks",
              "broker_state")

    def _bounds(self, ctx: AnalyzerContext, b: int) -> Tuple[float, float]:
        ok = ctx.disk_alive_mask(b)
        cap = float(ctx.disk_capacity[b][ok].sum())
        if cap <= 0:
            return (0.0, 1.0)
        avg = float(ctx.disk_load[b][ok].sum()) / cap
        return self.constraint.balance_bounds(avg, Resource.DISK)

    def violations(self, ctx: AnalyzerContext) -> int:
        if ctx.disk_load is None:
            return 0
        v = 0
        for b in np.nonzero(ctx.broker_alive)[0].tolist():
            ok = ctx.disk_alive_mask(b)
            if ok.sum() < 2:
                continue
            lo, hi = self._bounds(ctx, b)
            util = ctx.disk_load[b] / np.maximum(ctx.disk_capacity[b], 1e-9)
            v += int(((util < lo - 1e-9) | (util > hi + 1e-9))[ok].sum())
        return v

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        if ctx.disk_load is None:
            return
        for b in np.nonzero(ctx.broker_alive)[0].tolist():
            ok = ctx.disk_alive_mask(b)
            if ok.sum() < 2:
                continue
            lo, hi = self._bounds(ctx, b)
            cap = np.maximum(ctx.disk_capacity[b], 1e-9)
            # move replicas off over-limit disks onto the least-utilized ones
            for d in np.argsort(-(ctx.disk_load[b] / cap)).tolist():
                if not ok[d]:
                    continue
                for p, s in _disk_replicas(ctx, b, d):
                    if ctx.disk_load[b, d] / cap[d] <= hi + 1e-9:
                        break
                    load = ctx.replica_load_vec(p, s)[Resource.DISK]
                    util = ctx.disk_load[b] / cap
                    dst = int(np.where(ok, util, np.inf).argmin())
                    if dst == d:
                        break
                    # only move if it doesn't overshoot the destination
                    if (ctx.disk_load[b, dst] + load) / cap[dst] > hi + 1e-9:
                        continue
                    # acceptance chaining: previously-optimized goals (the
                    # hard capacity goal) must tolerate the destination
                    if not all(
                        g.accept_intra_move(ctx, p, s, dst)
                        for g in optimized
                        if hasattr(g, "accept_intra_move")
                    ):
                        continue
                    ctx.apply(_intra_action(ctx, p, s, dst))

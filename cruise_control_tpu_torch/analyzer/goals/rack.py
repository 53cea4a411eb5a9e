"""Rack-awareness goals (upstream ``analyzer/goals/RackAwareGoal.java`` and
``RackAwareDistributionGoal.java``; SURVEY.md §2.5 hard-goal row).

* RackAwareGoal — no two replicas of a partition share a rack (requires
  RF ≤ #alive racks).
* RackAwareDistributionGoal — relaxed form for RF > #racks: replicas spread
  across racks as evenly as possible (max per-rack count ≤ ⌈RF/#racks⌉).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from cruise_control_tpu_torch.common.resources import EMPTY_SLOT, Resource
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal,
    OptimizationFailure,
    accepted_move_dests,
    evacuate_offline_replicas,
    move_action,
)


def _partition_rack_counts(ctx: AnalyzerContext, p: int, skip_slot: int = -1) -> np.ndarray:
    """int [num_racks-upper-bound] — replicas of p per rack, optionally
    excluding one slot (the candidate being moved)."""
    counts = np.zeros(ctx.num_brokers, np.int32)  # rack ids < num_brokers
    for s in range(ctx.max_rf):
        if s == skip_slot:
            continue
        b = ctx.assignment[p, s]
        if b != EMPTY_SLOT:
            counts[ctx.broker_rack[b]] += 1
    return counts


def _count_over_limit_racks(ctx: AnalyzerContext, limit: np.ndarray) -> int:
    """Number of (partition, rack) pairs whose replica count exceeds
    ``limit[p]``, excluded topics skipped — vectorized over all partitions
    (the per-partition loop dominates result assembly at the 1M scale)."""
    a = ctx.assignment
    P, S = a.shape
    exists = a != EMPTY_SLOT
    racks = np.where(exists, ctx.broker_rack[np.clip(a, 0, None)], -1)  # [P, S]
    same = racks[:, :, None] == racks[:, None, :]                  # [P, S, S]
    cnt = (same & exists[:, None, :]).sum(axis=2)                  # per slot
    # count each over-limit rack once: at its first-occurrence slot
    earlier = np.arange(S)[None, None, :] < np.arange(S)[None, :, None]
    first = ~np.any(same & earlier & exists[:, None, :], axis=2)
    viol = exists & first & (cnt > limit[:, None])
    excluded = ctx.excluded_partition_mask()
    if excluded.any():
        viol &= ~excluded[:, None]
    return int(viol.sum())


class RackAwareGoal(Goal):
    name = "RackAwareGoal"
    is_hard = True
    inputs = ("assignment", "racks", "broker_state", "offline")
    reject_reason = "rack-violation"

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        used = _partition_rack_counts(ctx, p, skip_slot=s) > 0
        return ~used[ctx.broker_rack]

    def violations(self, ctx: AnalyzerContext) -> int:
        # Excluded topics are outside this goal's jurisdiction (upstream
        # RackAwareGoal skips excluded topics entirely).
        return _count_over_limit_racks(
            ctx, np.ones(ctx.num_partitions, np.int32)
        )

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        failed = evacuate_offline_replicas(ctx, self, optimized)
        if failed:
            raise OptimizationFailure(
                f"{self.name}: {len(failed)} offline replicas could not be placed"
            )
        for p in range(ctx.num_partitions):
            if ctx.partition_excluded(p):
                continue
            # move every replica whose rack is already taken by a
            # lower-indexed replica of the same partition
            seen: set = set()
            for s in range(ctx.max_rf):
                b = ctx.assignment[p, s]
                if b == EMPTY_SLOT:
                    continue
                rack = int(ctx.broker_rack[b])
                if rack not in seen:
                    seen.add(rack)
                    continue
                ok = accepted_move_dests(ctx, p, s, self, optimized)
                if not ok.any():
                    raise OptimizationFailure(
                        f"{self.name}: partition {p} replica {s} has no "
                        f"rack-aware destination"
                    )
                util = ctx.utilization(Resource.DISK)
                dest = int(np.argmin(np.where(ok, util, np.inf)))
                ctx.apply(move_action(ctx, p, s, dest))
                seen.add(int(ctx.broker_rack[dest]))


class RackAwareDistributionGoal(Goal):
    name = "RackAwareDistributionGoal"
    is_hard = True
    inputs = ("assignment", "racks", "broker_state", "offline")
    reject_reason = "rack-violation"

    def _alive_racks(self, ctx: AnalyzerContext) -> int:
        return len(set(ctx.broker_rack[ctx.broker_alive].tolist())) or 1

    def _max_per_rack(self, ctx: AnalyzerContext, p: int) -> int:
        rf = int((ctx.assignment[p] != EMPTY_SLOT).sum())
        return math.ceil(rf / self._alive_racks(ctx))

    def accept_move(self, ctx: AnalyzerContext, p: int, s: int) -> np.ndarray:
        counts = _partition_rack_counts(ctx, p, skip_slot=s)
        limit = self._max_per_rack(ctx, p)
        return counts[ctx.broker_rack] + 1 <= limit

    def violations(self, ctx: AnalyzerContext) -> int:
        rf = (ctx.assignment != EMPTY_SLOT).sum(axis=1)
        limit = np.ceil(rf / self._alive_racks(ctx)).astype(np.int32)
        return _count_over_limit_racks(ctx, limit)

    def optimize(self, ctx: AnalyzerContext, optimized: Sequence[Goal]) -> None:
        failed = evacuate_offline_replicas(ctx, self, optimized)
        if failed:
            raise OptimizationFailure(
                f"{self.name}: {len(failed)} offline replicas could not be placed"
            )
        for p in range(ctx.num_partitions):
            if ctx.partition_excluded(p):
                continue
            limit = self._max_per_rack(ctx, p)
            # shed replicas from over-packed racks
            for s in range(ctx.max_rf):
                counts = _partition_rack_counts(ctx, p)
                b = ctx.assignment[p, s]
                if b == EMPTY_SLOT or counts[ctx.broker_rack[b]] <= limit:
                    continue
                ok = accepted_move_dests(ctx, p, s, self, optimized)
                if not ok.any():
                    raise OptimizationFailure(
                        f"{self.name}: partition {p} replica {s} has no "
                        f"distribution-legal destination"
                    )
                util = ctx.utilization(Resource.DISK)
                ctx.apply(
                    move_action(ctx, p, s, int(np.argmin(np.where(ok, util, np.inf))))
                )

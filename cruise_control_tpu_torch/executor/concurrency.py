"""Adaptive movement concurrency (upstream ``executor/ConcurrencyAdjuster``;
SURVEY.md §2.6 ◆).

AIMD over the per-broker inter-broker movement cap: when the cluster shows
stress — under-replicated partitions that are NOT explained by the
execution's own in-flight moves — the cap halves (multiplicative decrease,
never below the floor); after ``healthy_ticks_before_increase`` consecutive
healthy observations it climbs by one (additive increase, never above the
ceiling).  The executor consults the adjuster every drive tick, so caps react
while a plan is running — the upstream behavior that keeps a rebalance from
drowning an already-degraded cluster.
"""

from __future__ import annotations

from typing import Optional, Set


class ConcurrencyAdjuster:
    def __init__(
        self,
        initial_cap: int,
        min_cap: int = 1,
        max_cap: Optional[int] = None,
        healthy_ticks_before_increase: int = 3,
    ):
        self.cap = max(initial_cap, min_cap)
        self.min_cap = min_cap
        self.max_cap = max_cap if max_cap is not None else initial_cap * 2
        self.healthy_ticks_before_increase = healthy_ticks_before_increase
        self._healthy_streak = 0
        self.adjustments: list = []  # (tick_index, new_cap) history

    def observe(self, external_urps: Set[int]) -> int:
        """One observation per drive tick → the cap to use this tick."""
        if external_urps:
            self._healthy_streak = 0
            new_cap = max(self.min_cap, self.cap // 2)
            if new_cap != self.cap:
                self.cap = new_cap
                self.adjustments.append(("decrease", new_cap))
        else:
            self._healthy_streak += 1
            if (
                self._healthy_streak >= self.healthy_ticks_before_increase
                and self.cap < self.max_cap
            ):
                self.cap += 1
                self._healthy_streak = 0
                self.adjustments.append(("increase", self.cap))
        return self.cap

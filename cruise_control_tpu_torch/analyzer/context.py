"""Analyzer working context — mutable numpy mirror of a ClusterState.

The greedy baseline (upstream ``GoalOptimizer``/``AbstractGoal`` inner loop,
SURVEY.md §2.5) makes thousands of dependent moves; recomputing broker
aggregates per move would be O(P·S) each.  This context keeps every aggregate
the goals consult updated *incrementally* per action — the numpy twin of the
"relocate = two scatter-adds" identity the TPU path exploits.

The same aggregate vocabulary is exported as a pytree
(:func:`goal_arrays`) so goal predicates written against it run unchanged
under numpy (greedy) and jax.numpy (TPU mask builder) — single-source goal
semantics, engine-checked for parity in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    BrokerState,
    Resource,
)
from cruise_control_tpu_torch.analyzer.actions import ActionType, BalancingAction
from cruise_control_tpu_torch.models.cluster_state import ClusterState


@dataclasses.dataclass
class OptimizationOptions:
    """Upstream ``OptimizationOptions`` (analyzer/OptimizationOptions.java):
    scoping knobs every goal must respect."""

    excluded_topics: Set[int] = dataclasses.field(default_factory=set)
    excluded_brokers_for_leadership: Set[int] = dataclasses.field(default_factory=set)
    excluded_brokers_for_replica_move: Set[int] = dataclasses.field(default_factory=set)
    #: Brokers requested for removal (demotion of all replicas), upstream
    #: removeBrokers semantics: treated as non-destinations whose replicas
    #: must evacuate.
    brokers_to_remove: Set[int] = dataclasses.field(default_factory=set)


class AnalyzerContext:
    """Mutable placement + aggregates; one instance per optimization run."""

    def __init__(self, state: ClusterState, options: Optional[OptimizationOptions] = None):
        self.options = options or OptimizationOptions()
        # placement (mutable copies)
        self.assignment = np.array(state.assignment, np.int32)
        self.leader_slot = np.array(state.leader_slot, np.int32)
        self.replica_offline = np.array(state.replica_offline, bool)
        # immutable per-partition data
        self.leader_load = np.array(state.leader_load, np.float32)
        self.follower_load = np.array(state.follower_load, np.float32)
        self.partition_topic = np.array(state.partition_topic, np.int32)
        # capacity-estimation loads (upstream model/Load.java window series:
        # percentile over windows when the state carries them and a
        # capacity_percentile is set; otherwise aliases of the mean loads,
        # so capacity and balance semantics coincide — round-1 behavior)
        from cruise_control_tpu_torch.models.cluster_state import capacity_loads

        lcap, fcap = capacity_loads(state)
        self.cap_distinct = lcap is not state.leader_load
        if self.cap_distinct:
            self.leader_cap_load = np.array(lcap, np.float32)
            self.follower_cap_load = np.array(fcap, np.float32)
        else:
            self.leader_cap_load = self.leader_load
            self.follower_cap_load = self.follower_load
        # broker data
        self.broker_capacity = np.array(state.broker_capacity, np.float32)
        self.broker_rack = np.array(state.broker_rack, np.int32)
        self.broker_state = np.array(state.broker_state, np.int8)
        self.num_topics = state.num_topics
        # JBOD (None when the model carries no per-disk data)
        self.replica_disk = (
            None if state.replica_disk is None
            else np.array(state.replica_disk, np.int32)
        )
        self.disk_capacity = (
            None if state.disk_capacity is None
            else np.array(state.disk_capacity, np.float32)
        )
        self.disk_offline = (
            None if state.disk_offline is None
            else np.array(state.disk_offline, bool)
        )

        self.num_partitions, self.max_rf = self.assignment.shape
        self.num_brokers = self.broker_capacity.shape[0]

        # Brokers requested for removal: their replicas become "immigrants"
        # that hard goals must evacuate (upstream removeBrokers semantics —
        # same machinery as dead-broker self-healing).
        for b in self.options.brokers_to_remove:
            self.replica_offline |= self.assignment == b

        # Where each offline replica started: partition p may never be placed
        # back on these brokers during this optimization, or the final diff
        # would keep the broker in p's replica set and the physically dead
        # replica would survive the plan (dead dir / dead broker).
        self.offline_origin = np.where(
            self.replica_offline, self.assignment, EMPTY_SLOT
        ).astype(np.int32)

        self._init_aggregates()
        #: modification counter + memo tables.  The greedy goals' acceptance
        #: predicates re-derive the same values (balance bounds, alive
        #: averages, candidate masks) thousands of times between mutations —
        #: the round-5 swap fallback made that quadratic in practice (the
        #: 3.4 s → 40 s bench regression: ~1M mask/average rebuilds
        #: per run).  ``_memo`` caches aggregate-derived values and is
        #: cleared on every mutation; ``_static_memo`` caches values that
        #: only depend on broker states/options, which no action changes.
        self.version = 0
        self._memo: Dict = {}
        self._static_memo: Dict = {}
        self.actions: List[BalancingAction] = []
        #: decision provenance: the goal pass currently mutating this
        #: context (set by the optimizer loops around each pass) — every
        #: action applied while set is tagged with it, and rejections are
        #: charged to it in ``pass_stats``
        self.current_goal: str = ""
        self.current_round: int = -1
        #: per-pass accept/reject accounting:
        #: {goal name: {"rejected": {categorical reason: count}}}
        #: (accepted counts are derived from the action tags, so a swap
        #: decomposed into two applies still counts once)
        self.pass_stats: Dict[str, dict] = {}

    # ---- decision provenance ----------------------------------------------------
    def record_reject(self, reason: str) -> None:
        """Charge one rejected candidate move to the current goal pass
        under a categorical reason (capacity-exceeded, rack-violation,
        no-improvement, swap-cap, excluded-broker)."""
        g = self.current_goal
        if not g:
            return
        st = self.pass_stats.setdefault(g, {"rejected": {}})
        rej = st["rejected"]
        rej[reason] = rej.get(reason, 0) + 1

    def _tagged(self, action: BalancingAction) -> BalancingAction:
        """Stamp the current pass's provenance onto an untagged action."""
        if self.current_goal and not action.goal:
            return dataclasses.replace(
                action, goal=self.current_goal, round=self.current_round
            )
        return action

    # ---- memoization ------------------------------------------------------------
    def invalidate(self) -> None:
        """Mark every aggregate-derived memo stale.  ``apply`` calls this;
        code mutating aggregates directly (the TPU engine's batched commit)
        MUST call it too, or stale bounds/averages leak into acceptance."""
        self.version += 1
        self._memo.clear()

    def memo(self, key, fn):
        """Memoize ``fn()`` under ``key`` until the next mutation."""
        try:
            return self._memo[key]
        except KeyError:
            v = self._memo[key] = fn()
            return v

    def static_memo(self, key, fn):
        """Memoize ``fn()`` under ``key`` for this context's lifetime (for
        values derived only from broker states/options/capacity, which no
        balancing action mutates).  Returned arrays are frozen — callers
        must ``.copy()`` before editing."""
        try:
            return self._static_memo[key]
        except KeyError:
            v = self._static_memo[key] = fn()  # cclint: disable=cache-key-discipline -- context-lifetime cache by design: an AnalyzerContext is built per model generation and never outlives it, and the cached values (broker states/options-derived masks) are immutable for that lifetime
            if isinstance(v, np.ndarray):
                v.flags.writeable = False
            return v

    # ---- masks ------------------------------------------------------------------
    @property
    def broker_alive(self) -> np.ndarray:
        return self.static_memo(
            "broker_alive",
            lambda: (self.broker_state != BrokerState.DEAD)
            & (self.broker_state != BrokerState.REMOVED),
        )

    @property
    def broker_demoted(self) -> np.ndarray:
        return self.static_memo(
            "broker_demoted", lambda: self.broker_state == BrokerState.DEMOTED
        )

    @property
    def broker_new(self) -> np.ndarray:
        return self.static_memo(
            "broker_new", lambda: self.broker_state == BrokerState.NEW
        )

    def dest_candidates(self) -> np.ndarray:
        """bool [B] — brokers eligible as replica-move destinations
        (frozen cached array — ``.copy()`` before mutating)."""
        return self.static_memo("dest_candidates", self._dest_candidates)

    def _dest_candidates(self) -> np.ndarray:
        ok = self.broker_alive.copy()
        for b in self.options.excluded_brokers_for_replica_move:
            ok[b] = False
        for b in self.options.brokers_to_remove:
            ok[b] = False
        return ok

    def leadership_candidates(self) -> np.ndarray:
        """bool [B] — brokers eligible to take leadership (frozen cached
        array — ``.copy()`` before mutating)."""
        return self.static_memo(
            "leadership_candidates", self._leadership_candidates
        )

    def _leadership_candidates(self) -> np.ndarray:
        ok = self.broker_alive & ~self.broker_demoted
        for b in self.options.excluded_brokers_for_leadership:
            ok[b] = False
        for b in self.options.brokers_to_remove:
            ok[b] = False
        return ok

    def partition_excluded(self, p: int) -> bool:
        return int(self.partition_topic[p]) in self.options.excluded_topics

    def excluded_partition_mask(self) -> np.ndarray:
        """bool [P] — partitions whose topic is excluded from optimization.

        Single source for the device mask builder, the host commit evaluator,
        and the verifier (exclusion semantics must agree between all three).
        """
        if not self.options.excluded_topics:
            return np.zeros(self.num_partitions, bool)
        return np.isin(self.partition_topic, list(self.options.excluded_topics))

    # ---- aggregates -------------------------------------------------------------
    def _init_aggregates(self) -> None:
        P, S = self.assignment.shape
        B, T = self.num_brokers, self.num_topics
        self.broker_load = np.zeros((B, NUM_RESOURCES), np.float64)
        self.broker_leader_load = np.zeros((B, NUM_RESOURCES), np.float64)
        self.broker_replica_count = np.zeros(B, np.int64)
        self.broker_leader_count = np.zeros(B, np.int64)
        self.broker_topic_replica_count = np.zeros((B, T), np.int64)
        self.broker_topic_leader_count = np.zeros((B, T), np.int64)
        self.broker_potential_nw_out = np.zeros(B, np.float64)
        if self.disk_capacity is not None:
            self.disk_load = np.zeros(self.disk_capacity.shape, np.float64)
        else:
            self.disk_load = None

        # vectorized recount (bincount over flattened replica rows): the
        # Python-loop version is O(P·S) interpreter iterations, minutes at
        # the 1M-partition scale this engine targets
        exists = self.assignment != EMPTY_SLOT
        is_leader = np.arange(S)[None, :] == self.leader_slot[:, None]
        rload = np.where(
            is_leader[:, :, None],
            self.leader_load[:, None, :],
            self.follower_load[:, None, :],
        ).astype(np.float64)                                 # [P, S, R]
        fb = self.assignment[exists].astype(np.int64)        # flat broker ids
        fload = rload[exists]                                # [N, R]
        for r in range(NUM_RESOURCES):
            self.broker_load[:, r] = np.bincount(
                fb, weights=fload[:, r], minlength=B
            )
        self.broker_replica_count[:] = np.bincount(fb, minlength=B)
        ft = np.broadcast_to(
            self.partition_topic[:, None].astype(np.int64), (P, S)
        )[exists]
        self.broker_topic_replica_count[:] = np.bincount(
            fb * T + ft, minlength=B * T
        ).reshape(B, T)
        fpot = np.broadcast_to(
            self.leader_load[:, None, Resource.NW_OUT].astype(np.float64), (P, S)
        )[exists]
        self.broker_potential_nw_out[:] = np.bincount(
            fb, weights=fpot, minlength=B
        )
        if self.disk_load is not None:
            fd = self.replica_disk[exists].astype(np.int64)
            on_disk = fd >= 0
            D = self.disk_capacity.shape[1]
            self.disk_load[:] = np.bincount(
                fb[on_disk] * D + fd[on_disk],
                weights=fload[on_disk, Resource.DISK],
                minlength=B * D,
            ).reshape(B, D)
        lb = self.assignment[np.arange(P), self.leader_slot].astype(np.int64)
        self.broker_leader_count[:] = np.bincount(lb, minlength=B)
        for r in range(NUM_RESOURCES):
            self.broker_leader_load[:, r] = np.bincount(
                lb, weights=self.leader_load[:, r].astype(np.float64),
                minlength=B,
            )
        self.broker_topic_leader_count[:] = np.bincount(
            lb * T + self.partition_topic.astype(np.int64), minlength=B * T
        ).reshape(B, T)
        # capacity-estimate broker loads: a distinct roll-up only when the
        # model carries a window series + percentile; otherwise an alias of
        # broker_load (apply() keeps the pair in sync via cap_distinct)
        if self.cap_distinct:
            crload = np.where(
                is_leader[:, :, None],
                self.leader_cap_load[:, None, :],
                self.follower_cap_load[:, None, :],
            ).astype(np.float64)
            cfload = crload[exists]
            self.broker_cap_load = np.zeros((B, NUM_RESOURCES), np.float64)
            for r in range(NUM_RESOURCES):
                self.broker_cap_load[:, r] = np.bincount(
                    fb, weights=cfload[:, r], minlength=B
                )
        else:
            self.broker_cap_load = self.broker_load

    def leader_broker(self, p: int) -> int:
        return int(self.assignment[p, self.leader_slot[p]])

    def is_leader(self, p: int, s: int) -> bool:
        return self.leader_slot[p] == s

    def replica_load_vec(self, p: int, s: int) -> np.ndarray:
        """f64 [R] — the load replica (p, s) puts on its broker right now."""
        if self.is_leader(p, s):
            return self.leader_load[p].astype(np.float64)
        return self.follower_load[p].astype(np.float64)

    def replica_cap_load_vec(self, p: int, s: int) -> np.ndarray:
        """f64 [R] — the capacity-estimate load of replica (p, s) (== the
        mean load unless a window series + percentile is configured)."""
        if self.is_leader(p, s):
            return self.leader_cap_load[p].astype(np.float64)
        return self.follower_cap_load[p].astype(np.float64)

    def disk_alive_mask(self, b: int) -> np.ndarray:
        """bool [D] — existing, non-failed disks of broker b."""
        ok = self.disk_capacity[b] > 0
        if self.disk_offline is not None:
            ok &= ~self.disk_offline[b]
        return ok

    def least_loaded_disk(self, b: int) -> int:
        """Healthy disk of b with the lowest utilization; -1 if none."""
        if self.disk_capacity is None:
            return -1
        ok = self.disk_alive_mask(b)
        if not ok.any():
            return -1
        util = self.disk_load[b] / np.maximum(self.disk_capacity[b], 1e-9)
        util = np.where(ok, util, np.inf)
        return int(util.argmin())

    def utilization(self, resource: Resource) -> np.ndarray:
        """f64 [B] — load/capacity for a resource."""
        return self.broker_load[:, resource] / np.maximum(
            self.broker_capacity[:, resource], 1e-9
        )

    def avg_alive_utilization(self, resource: Resource) -> float:
        """Upstream avgUtilizationPercentage: total load / total alive capacity."""
        return self.memo(
            ("avg_alive_util", int(resource)),
            lambda: self._avg_alive_utilization(resource),
        )

    def _avg_alive_utilization(self, resource: Resource) -> float:
        alive = self.broker_alive
        cap = self.broker_capacity[alive, resource].sum()
        return float(self.broker_load[:, resource].sum() / max(cap, 1e-9))

    # ---- action application -----------------------------------------------------
    def apply(self, action: BalancingAction) -> None:
        """Apply an accepted action, updating placement + every aggregate."""
        self.invalidate()
        p = action.partition
        t = self.partition_topic[p]
        if action.action_type == ActionType.INTRA_BROKER_REPLICA_MOVEMENT:
            s, b = action.slot, action.source_broker
            assert self.assignment[p, s] == b == action.dest_broker
            d_src, d_dst = action.source_disk, action.dest_disk
            assert self.replica_disk[p, s] == d_src, "stale intra action"
            dl = self.replica_load_vec(p, s)[Resource.DISK]
            self.replica_disk[p, s] = d_dst
            self.disk_load[b, d_src] -= dl
            self.disk_load[b, d_dst] += dl
            self.replica_offline[p, s] = False  # moved off a dead disk
            self.actions.append(self._tagged(action))
            return
        if action.action_type == ActionType.INTER_BROKER_REPLICA_MOVEMENT:
            s, src, dst = action.slot, action.source_broker, action.dest_broker
            assert self.assignment[p, s] == src, "stale action"
            load = self.replica_load_vec(p, s)
            if self.cap_distinct:
                capl = self.replica_cap_load_vec(p, s)
                self.broker_cap_load[src] -= capl
                self.broker_cap_load[dst] += capl
            pot = self.leader_load[p, Resource.NW_OUT]
            if self.disk_load is not None:
                # leave the source disk; land on the destination's
                # least-loaded healthy disk (upstream: live log dir choice)
                d_src = self.replica_disk[p, s]
                if d_src >= 0:
                    self.disk_load[src, d_src] -= load[Resource.DISK]
                d_dst = self.least_loaded_disk(dst)
                self.replica_disk[p, s] = d_dst
                if d_dst >= 0:
                    self.disk_load[dst, d_dst] += load[Resource.DISK]
            self.assignment[p, s] = dst
            self.replica_offline[p, s] = False
            self.broker_load[src] -= load
            self.broker_load[dst] += load
            self.broker_replica_count[src] -= 1
            self.broker_replica_count[dst] += 1
            self.broker_topic_replica_count[src, t] -= 1
            self.broker_topic_replica_count[dst, t] += 1
            self.broker_potential_nw_out[src] -= pot
            self.broker_potential_nw_out[dst] += pot
            if self.is_leader(p, s):
                self.broker_leader_count[src] -= 1
                self.broker_leader_count[dst] += 1
                self.broker_leader_load[src] -= self.leader_load[p]
                self.broker_leader_load[dst] += self.leader_load[p]
                self.broker_topic_leader_count[src, t] -= 1
                self.broker_topic_leader_count[dst, t] += 1
        elif action.action_type == ActionType.LEADERSHIP_MOVEMENT:
            new_slot = action.dest_slot
            old_slot = self.leader_slot[p]
            src = int(self.assignment[p, old_slot])
            dst = int(self.assignment[p, new_slot])
            assert src == action.source_broker and dst == action.dest_broker
            delta = (self.leader_load[p] - self.follower_load[p]).astype(np.float64)
            if self.cap_distinct:
                cdelta = (
                    self.leader_cap_load[p] - self.follower_cap_load[p]
                ).astype(np.float64)
                self.broker_cap_load[src] -= cdelta
                self.broker_cap_load[dst] += cdelta
            self.leader_slot[p] = new_slot
            self.broker_load[src] -= delta
            self.broker_load[dst] += delta
            self.broker_leader_count[src] -= 1
            self.broker_leader_count[dst] += 1
            self.broker_leader_load[src] -= self.leader_load[p]
            self.broker_leader_load[dst] += self.leader_load[p]
            self.broker_topic_leader_count[src, t] -= 1
            self.broker_topic_leader_count[dst, t] += 1
        elif action.action_type == ActionType.INTER_BROKER_REPLICA_SWAP:
            # decompose into two moves (aggregates stay exact because the two
            # applies are sequential); record only the swap itself
            a1 = BalancingAction(
                ActionType.INTER_BROKER_REPLICA_MOVEMENT,
                action.partition, action.slot,
                action.source_broker, action.dest_broker,
            )
            a2 = BalancingAction(
                ActionType.INTER_BROKER_REPLICA_MOVEMENT,
                action.swap_partition, action.swap_slot,
                action.dest_broker, action.source_broker,
            )
            self.apply(a1)
            self.apply(a2)
            self.actions.pop()
            self.actions.pop()
            self.actions.append(self._tagged(action))
            return
        else:
            raise NotImplementedError(action.action_type)
        self.actions.append(self._tagged(action))

    # ---- warm-start seeding (delta replan) --------------------------------------
    def reseed(
        self,
        assignment: np.ndarray,
        leader_slot: np.ndarray,
        replica_disk: Optional[np.ndarray] = None,
    ) -> None:
        """Re-point this context's placement at a warm-start seed (the
        previous plan's final placement) and rebuild every aggregate.

        The seed describes a *hypothetical* placement (the previous plan
        has not necessarily executed), so per-replica offline flags are
        re-derived from first principles: a seeded replica is offline
        exactly when it sits on a dead/removed broker or a broker
        requested for removal — the model's per-disk/per-replica offline
        flags for rows the seed did not move are kept (a failed disk stays
        failed wherever the seed points).
        """
        assert assignment.shape == self.assignment.shape, "seed shape drift"
        moved = np.any(assignment != self.assignment, axis=1)
        self.assignment = np.array(assignment, np.int32)
        self.leader_slot = np.array(leader_slot, np.int32)
        if replica_disk is not None and self.replica_disk is not None:
            self.replica_disk = np.array(replica_disk, np.int32)
        # rows the seed moved: offline only where the seed lands on a
        # non-hosting broker; untouched rows keep their recorded flags
        dead = ~self.broker_alive
        on_dead = (self.assignment != EMPTY_SLOT) & dead[
            np.clip(self.assignment, 0, None)
        ]
        self.replica_offline = np.where(
            moved[:, None], on_dead, self.replica_offline | on_dead
        )
        for b in self.options.brokers_to_remove:
            self.replica_offline |= self.assignment == b
        self.offline_origin = np.where(
            self.replica_offline, self.assignment, EMPTY_SLOT
        ).astype(np.int32)
        self._init_aggregates()
        self.invalidate()

    # ---- snapshots --------------------------------------------------------------
    def to_state(self, template: ClusterState) -> ClusterState:
        # host-first like the rest of ClusterState: device upload happens
        # only where a consumer actually jits over it
        out = template.replace(
            assignment=self.assignment.copy(),
            leader_slot=self.leader_slot.copy(),
            replica_offline=self.replica_offline.copy(),
        )
        if self.replica_disk is not None:
            out = out.replace(replica_disk=self.replica_disk.copy())
        return out

    def recompute_check(self, atol: float = 1e-3) -> None:
        """Debug invariant: incremental aggregates match a fresh recount."""
        snap_load = self.broker_load.copy()
        snap_rc = self.broker_replica_count.copy()
        snap_lc = self.broker_leader_count.copy()
        snap_disk = None if self.disk_load is None else self.disk_load.copy()
        self._init_aggregates()
        assert np.allclose(snap_load, self.broker_load, atol=atol), "load drift"
        assert (snap_rc == self.broker_replica_count).all(), "replica count drift"
        assert (snap_lc == self.broker_leader_count).all(), "leader count drift"
        if snap_disk is not None:
            assert np.allclose(snap_disk, self.disk_load, atol=atol), \
                "disk load drift"

"""DeltaReplanner — turns a generation bump into a warm re-optimization.

The facade's proposal-compute path (``get_proposals`` → the precompute
daemon, ``GET /proposals`` misses, anomaly-invalidated refreshes) calls
into this planner instead of cold-starting:

1. **Delta model build** — ``LoadMonitor.cluster_model_delta`` patches the
   previous model's arrays (dirty rows only) and reports a structured
   :class:`ModelDelta`;
2. **Warm-start decision** — the delta must fit the configured dirty
   budget; structural drift the patch could not express (``delta.full``)
   or a missing snapshot routes to the cold path;
3. **Warm start assembly** — seed placement = the previous plan's final
   placement (rows the cluster itself moved re-seed from the live
   placement), previous actions carried for accounting, per-goal input
   signatures + verified violations for the exact partial re-verify, and
   the device carry (resident model + pool row tables) for the TPU
   engine's delta upload;
4. **Commit** — after the engine returns, the new model/result/signatures
   become the snapshot the NEXT replan diffs against.

Every decision is journaled (``replan.start`` / ``replan.end``), so a
scenario can assert "this refresh served warm" from the journal alone.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from cruise_control_tpu_torch.analyzer.actions import ActionType
from cruise_control_tpu_torch.replan.delta import ModelDelta, ReplanCarry, WarmStart
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("replan")


@dataclasses.dataclass
class ReplanConfig:
    """The ``replan.*`` config-key surface (bootstrap wires it)."""

    enabled: bool = True
    #: relative per-row load drift below which a partition's loads keep
    #: the previous model's bits (replan.dirty.load.relative.threshold)
    dirty_load_rel_threshold: float = 0.05
    #: dirty-partition fraction of P above which the warm path falls back
    #: to a cold plan (replan.dirty.partition.budget.ratio)
    dirty_partition_budget_ratio: float = 0.25
    #: safety net: recompute every goal even when its input signature
    #: matched the previously verified state (replan.full.verify)
    full_verify: bool = False
    #: carry the device model + pool row tables across plans
    #: (replan.table.carry.enabled)
    table_carry: bool = True


@dataclasses.dataclass
class ReplanSnapshot:
    """What the next replan diffs against: the previous model, its plan,
    and the verification state of that plan's final placement."""

    state: object                  # ClusterState (the model optimized)
    result: object                 # OptimizerResult
    generation: str
    agg_mark: int                  # aggregator generation at build time
    signatures: Optional[dict]     # goal name → input signature (final ctx)
    violations_after: dict


class _SigView:
    """Duck-typed signature target for a bare ClusterState: mirrors the
    attribute surface ``verifier.goal_input_signatures`` reads off an
    AnalyzerContext, including the capacity-load aliases (the replan path
    never runs percentile capacity estimation, so the aliases hold)."""

    def __init__(self, state):
        self.assignment = np.asarray(state.assignment)
        self.leader_slot = np.asarray(state.leader_slot)
        self.leader_load = np.asarray(state.leader_load, np.float32)
        self.follower_load = np.asarray(state.follower_load, np.float32)
        self.leader_cap_load = self.leader_load
        self.follower_cap_load = self.follower_load
        self.broker_capacity = np.asarray(state.broker_capacity, np.float32)
        self.broker_rack = np.asarray(state.broker_rack)
        self.broker_state = np.asarray(state.broker_state)
        self.partition_topic = np.asarray(state.partition_topic)
        self.replica_offline = np.asarray(state.replica_offline)
        self.replica_disk = (
            None if state.replica_disk is None
            else np.asarray(state.replica_disk)
        )
        self.disk_capacity = (
            None if state.disk_capacity is None
            else np.asarray(state.disk_capacity)
        )
        self.disk_offline = (
            None if state.disk_offline is None
            else np.asarray(state.disk_offline)
        )


class DeltaReplanner:
    """Per-facade warm-replan state machine.

    Thread-safety: the facade's single-flight compute lock already
    serializes plan computation; the internal lock only guards snapshot
    swaps against concurrent state readers."""

    def __init__(self, load_monitor, config: Optional[ReplanConfig] = None):
        self.monitor = load_monitor
        self.config = config or ReplanConfig()
        self.snapshot: Optional[ReplanSnapshot] = None
        self.carry = ReplanCarry()
        self._lock = threading.Lock()
        self.warm_plans = 0
        self.cold_plans = 0
        self.last_mode: Optional[str] = None
        self.last_reason: Optional[str] = None

    # ---- model build (caller holds the model-generation semaphore) ---------------
    def build_model(self, requirements=None):
        """→ ``(state, delta_or_None, agg_mark)``.  ``delta=None`` means
        the cold builder ran (no snapshot / replan disabled); the mark is
        captured BEFORE aggregation so samples racing the build re-flag
        as dirty next time instead of being missed."""
        mark = self.monitor.aggregation_mark()
        with self._lock:
            snap = self.snapshot
        if snap is None or not self.config.enabled:
            return self.monitor.cluster_model(requirements), None, mark
        state, delta = self.monitor.cluster_model_delta(
            snap.state, snap.agg_mark, requirements,
            prev_generation=snap.generation,
            rel_threshold=self.config.dirty_load_rel_threshold,
        )
        return state, delta, mark

    # ---- warm-start decision -----------------------------------------------------
    def warm_start_for(self, state, delta: Optional[ModelDelta]):
        """→ ``(WarmStart | None, reason)`` — None = cold, with why."""
        with self._lock:
            snap = self.snapshot
        if not self.config.enabled:
            return None, "disabled"
        if snap is None:
            return None, "no-snapshot"
        if delta is None or delta.full:
            return None, (delta.reason if delta is not None else "cold-build")
        P = state.num_partitions
        budget = max(1, int(self.config.dirty_partition_budget_ratio * P))
        if delta.n_dirty_partitions > budget:
            return None, (
                f"dirty-budget-exceeded ({delta.n_dirty_partitions} > "
                f"{budget})"
            )
        prev_final = snap.result.final_state
        seed_assign = np.array(prev_final.assignment, np.int32)
        seed_ls = np.array(prev_final.leader_slot, np.int32)
        # rows the CLUSTER moved since the snapshot (failover, external
        # reassignment, an executed plan) seed from the live placement —
        # the previous plan's decisions for them are void
        moved = delta.dirty_topology
        if moved is not None and moved.any():
            cur_a = np.asarray(state.assignment)
            cur_l = np.asarray(state.leader_slot)
            seed_assign[moved] = cur_a[moved]
            seed_ls[moved] = cur_l[moved]
            prev_actions = [
                a for a in snap.result.actions
                if not moved[a.partition] and not (
                    a.action_type == ActionType.INTER_BROKER_REPLICA_SWAP
                    and moved[a.swap_partition]
                )
            ]
        else:
            prev_actions = list(snap.result.actions)
        # device carry eligibility: same broker axis, same capacity/rack
        # bits (the pool tables normalize by mean capacity, so any drift
        # there invalidates every row)
        if self.carry.valid and (
            delta.shape_changed
            or not np.array_equal(
                np.asarray(snap.state.broker_capacity),
                np.asarray(state.broker_capacity),
            )
            or not np.array_equal(
                np.asarray(snap.state.broker_rack),
                np.asarray(state.broker_rack),
            )
        ):
            self.carry.invalidate()
        ws = WarmStart(
            assignment=seed_assign,
            leader_slot=seed_ls,
            replica_disk=None,
            prev_actions=prev_actions,
            dirty_partitions=np.asarray(delta.dirty_partitions, bool).copy(),
            prev_signatures=snap.signatures,
            prev_violations=dict(snap.violations_after),
            full_verify=self.config.full_verify,
        )
        return ws, "warm"

    def servable_snapshot(self, engine: Optional[str], delta):
        """The previous result, when it is EXACTLY servable for this
        request: the delta proved the new model bit-identical to the
        snapshot's (zero dirty rows, no topology/shape change), the
        requested engine matches the snapshot's plan, and the full-verify
        safety net is off.  Returns the OptimizerResult or None."""
        if self.config.full_verify:
            return None
        if (
            delta is None or delta.full or delta.topology_changed
            or delta.shape_changed or delta.n_dirty_partitions != 0
        ):
            return None
        with self._lock:
            snap = self.snapshot
        if snap is None:
            return None
        if engine is not None and snap.result.engine != engine:
            return None
        return snap.result

    def engine_kwargs(self, warm_start):
        """kwargs for ``engine.optimize`` — the carry rides only when the
        table carry is enabled (it is harmless but wasted otherwise)."""
        out = {"warm_start": warm_start}
        if self.config.table_carry:
            out["carry"] = self.carry
        return out

    # ---- commit -------------------------------------------------------------------
    def commit(self, state, result, generation: str, agg_mark: int) -> None:
        """Retain the just-computed plan as the next diff base."""
        verify = getattr(result, "replan_verify", None)
        if verify is not None and verify.get("signatures"):
            sigs = verify["signatures"]
        else:
            from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
            from cruise_control_tpu_torch.analyzer.verifier import (
                goal_input_signatures,
            )

            sigs = goal_input_signatures(
                _SigView(result.final_state),
                make_goals(),
            )
        with self._lock:
            self.snapshot = ReplanSnapshot(
                state=state,
                result=result,
                generation=generation,
                agg_mark=agg_mark,
                signatures=sigs,
                violations_after=dict(result.violations_after),
            )

    def record_mode(self, mode: str, reason: str) -> None:
        if mode == "warm":
            self.warm_plans += 1
        else:
            self.cold_plans += 1
        self.last_mode, self.last_reason = mode, reason

    def reset(self, reason: str = "reset") -> None:
        """Drop the snapshot + carry (the next plan is cold)."""
        with self._lock:
            self.snapshot = None
        self.carry.invalidate()
        self.last_reason = reason

    def state_summary(self) -> dict:
        with self._lock:
            snap = self.snapshot
        return {
            "enabled": self.config.enabled,
            "snapshotGeneration": snap.generation if snap else None,
            "warmPlans": self.warm_plans,
            "coldPlans": self.cold_plans,
            "lastMode": self.last_mode,
            "lastReason": self.last_reason,
            "carryValid": self.carry.valid,
            "carryTables": self.carry.tables is not None,
        }

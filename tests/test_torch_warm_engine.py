"""The cuda engine's warm start and cross-plan carry, on the CPU (the
kernels' plain twins).

* The carry is a pure diet: a warm plan that rides the carried pool row
  tables equals the carry-less warm plan from the same
  :class:`WarmStart` in actions and final placement, whether the first
  repool refreshes only the marked rows (budget < P) or rebuilds them all
  — the reference's ``test_tpu_warm_carry_matches_carryless_warm``.
* Quality: the warm plan passes ``verify_result`` and scores within the
  reference's warm tolerance of the cold plan on the same model (or, where
  the reference engine's own warm plan misses it, no worse than that), and
  within the parity tolerance of the reference engine's warm plan from the
  same warm start, reusing the same goals' verdicts.
* The eligibility guard: shape, capacity and exclusion drift each give
  cold tables, and the export still leaves a valid carry.
* The carry owns its tensors: a search of another state of the same shape
  between the cold and the warm plan changes neither the carry nor the
  warm plan, which still rides the carried tables.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.context import (
    AnalyzerContext as RefContext,
)
from cruise_control_tpu.analyzer.goal_optimizer import make_goals as ref_goals
from cruise_control_tpu.analyzer.tpu_optimizer import (
    TpuGoalOptimizer,
    TpuSearchConfig,
)
from cruise_control_tpu.analyzer.verifier import (
    goal_input_signatures as ref_signatures,
)
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu.replan.delta import WarmStart as RefWarmStart
from cruise_control_tpu_torch.analyzer.context import (
    AnalyzerContext,
    OptimizationOptions,
)
from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
    CudaGoalOptimizer,
    CudaSearchConfig,
    carry_nbytes,
)
from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
from cruise_control_tpu_torch.analyzer.verifier import (
    goal_input_signatures,
    verify_result,
    violation_score,
)
from cruise_control_tpu_torch.common.resources import (
    FOLLOWER_CPU_RATIO,
    Resource,
)
from cruise_control_tpu_torch.models.generators import random_cluster
from cruise_control_tpu_torch.replan.delta import ReplanCarry, WarmStart
from cruise_control_tpu_torch.tools.served_stack import WINDOW_MS as WINDOW
from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

SMALL = dict(steps_per_call=16, repool_steps=4, device_batch_per_step=8,
             max_rounds=40)
BUDGETS = {"incremental": dict(repool_incremental=True,
                               repool_rows_budget=24),
           "full": {}}


def warm_tolerance(cold_score: int) -> int:
    """The reference's warm bar (``tests/test_replan.py``): no more than
    max(1, 2 %) above the cold plan on the same model."""
    return cold_score + max(1, round(0.02 * cold_score))


def within_parity(score: int, ref_score: int) -> bool:
    return score <= ref_score + max(2, 0.05 * ref_score)


def acts(result):
    return [(a.action_type, a.partition, a.slot, a.source_broker,
             a.dest_broker, a.dest_slot) for a in result.actions]


def drift(state, dirty, factor=1.7):
    """``state`` with the loads of the ``dirty`` partitions scaled (the
    follower rows rebuilt from the leader rows), every other row's bits
    kept."""
    lead = np.asarray(state.leader_load)
    new_lead = lead.copy()
    new_lead[dirty] *= factor
    new_fol = new_lead.copy()
    new_fol[:, Resource.NW_OUT] = 0.0
    new_fol[:, Resource.CPU] *= FOLLOWER_CPU_RATIO
    return state.replace(
        leader_load=torch.tensor(np.where(dirty[:, None], new_lead, lead)),
        follower_load=torch.tensor(np.where(
            dirty[:, None], new_fol, np.asarray(state.follower_load))))


def warm_start_from(prev, dirty, cls=WarmStart, ctx_cls=AnalyzerContext,
                    signatures=goal_input_signatures, goals=None):
    fctx = ctx_cls(prev.final_state)
    return cls(
        assignment=np.asarray(prev.final_state.assignment),
        leader_slot=np.asarray(prev.final_state.leader_slot),
        prev_actions=list(prev.actions),
        dirty_partitions=dirty.copy(),
        prev_signatures=signatures(fctx, goals or make_goals()),
        prev_violations=prev.violations_after,
    )


def engine(cfg, **kw):
    return CudaGoalOptimizer(config=cfg, device="cpu", **kw)


def cold_then_drift(seed=13, budget="full", num_brokers=10,
                    num_partitions=80):
    """A cold plan with a carry on a random cluster, and the cluster with
    the partitions led by broker 0 drifted → (cfg, state, prev, carry,
    dirty, drifted)."""
    cfg = CudaSearchConfig(**SMALL, **BUDGETS[budget])
    state = random_cluster(seed=seed, num_brokers=num_brokers, num_racks=5,
                           num_partitions=num_partitions)
    carry = ReplanCarry()
    prev = engine(cfg).optimize(state, carry=carry)
    dirty = np.asarray(state.leader_broker()) == 0
    return cfg, state, prev, carry, dirty, drift(state, dirty)


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_warm_carry_matches_carryless_warm(budget):
    cfg, _, prev, carry, dirty, drifted = cold_then_drift(budget=budget)
    assert carry.valid and carry.model is not None
    assert carry.tables is not None and carry_nbytes(carry) > 0
    with_carry = engine(cfg).optimize(
        drifted, warm_start=warm_start_from(prev, dirty), carry=carry)
    without = engine(cfg).optimize(
        drifted, warm_start=warm_start_from(prev, dirty))
    assert acts(with_carry) == acts(without)
    assert np.array_equal(np.asarray(with_carry.final_state.assignment),
                          np.asarray(without.final_state.assignment))
    assert np.array_equal(np.asarray(with_carry.final_state.leader_slot),
                          np.asarray(without.final_state.leader_slot))
    warm = with_carry.goal_summaries[0]["warm"]
    assert warm["table_carry"] and warm["dirty_rows"] == int(dirty.sum())
    assert not without.goal_summaries[0]["warm"]["table_carry"]
    if budget == "incremental":
        # the first repool refreshed only the marked rows: every repool of
        # the first call was incremental
        assert warm["marked_rows"] <= warm["rows_budget"]
        assert warm["first_call_incremental"] == warm["first_call_repools"]
    goals = make_goals()
    verify_result(drifted, with_carry, goals)
    cold = engine(cfg).optimize(drifted)
    assert violation_score(with_carry.final_state, goals) <= warm_tolerance(
        violation_score(cold.final_state, goals))


def drifted_stack_model(stack, seed):
    """The reference's seeded drift on its own fixture
    (``tests/test_replan.py::test_warm_plan_score_within_parity_tolerance``):
    the monitor's model, then up to four partitions of a random broker
    scaled by 1.5-4 and two windows rolled → (previous model, delta model,
    delta)."""
    rng = np.random.default_rng(seed)
    cc, _, reporter = stack()
    mon = cc.load_monitor
    prev = mon.cluster_model()
    mark = mon.aggregation_mark()
    broker = int(rng.integers(0, 4))
    factor = float(rng.uniform(1.5, 4.0))
    w = reporter.workload
    for p in [p for p, reps in w.assignment.items() if broker in reps][:4]:
        w.bytes_in[p] *= factor
        w.bytes_out[p] *= factor
    for k in (3, 4):
        reporter.report(time_ms=k * WINDOW + 500)
        mon.run_sampling_iteration((k + 1) * WINDOW)
    state, delta = mon.cluster_model_delta(prev, mark)
    assert not delta.full and delta.dirty_partitions.any()
    return prev, state, delta


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_warm_against_cold_tracks_the_reference(seed):
    """Warm against cold on the reference's seeded drifts, at the default
    config, on the port and on the reference engine: the port's warm plan
    verifies, its warm and cold scores are within the parity tolerance of
    the reference engine's, and it meets the reference's warm bar (2 %
    over cold) or scores no worse than the reference engine's warm plan
    (on seed 3 both engines' warm plans score 6 against a cold 3)."""
    prev, state, delta = drifted_stack_model(
        lambda: full_stack(engine="greedy", device="cpu"), seed)
    carry = ReplanCarry()
    first = CudaGoalOptimizer(device="cpu").optimize(prev, carry=carry)
    warm = CudaGoalOptimizer(device="cpu").optimize(
        state, warm_start=warm_start_from(first, delta.dirty_partitions),
        carry=carry)
    cold = CudaGoalOptimizer(device="cpu").optimize(state)

    ref_prev, ref_state, ref_delta = drifted_stack_model(ref_full_stack, seed)
    assert np.array_equal(ref_delta.dirty_partitions, delta.dirty_partitions)
    ref_first = TpuGoalOptimizer().optimize(ref_prev)
    ref_warm = TpuGoalOptimizer().optimize(ref_state, warm_start=(
        warm_start_from(ref_first, ref_delta.dirty_partitions,
                        cls=RefWarmStart, ctx_cls=RefContext,
                        signatures=ref_signatures, goals=ref_goals())))
    ref_cold = TpuGoalOptimizer().optimize(ref_state)

    goals = make_goals()
    verify_result(state, warm, goals)
    assert warm.goal_summaries[0]["warm"]["table_carry"]
    assert warm.actions[:len(first.actions)] == first.actions
    s_warm = violation_score(warm.final_state, goals)
    s_cold = violation_score(cold.final_state, goals)
    r_warm = violation_score(ref_warm.final_state, ref_goals())
    r_cold = violation_score(ref_cold.final_state, ref_goals())
    assert within_parity(s_warm, r_warm) and within_parity(s_cold, r_cold)
    assert s_warm <= max(warm_tolerance(s_cold), r_warm), (
        s_warm, s_cold, r_warm, r_cold)


def test_warm_plan_tracks_the_reference_warm_plan():
    """The port's warm plan and the reference engine's, from the same warm
    start: both verify, the port's score is within the parity tolerance of
    the reference's, and both reuse the same goals' verdicts."""
    cfg, state, prev, carry, dirty, drifted = cold_then_drift()
    port = engine(cfg).optimize(
        drifted, warm_start=warm_start_from(prev, dirty), carry=carry)

    ref_state = ref_gen.random_cluster(seed=13, num_brokers=10, num_racks=5,
                                       num_partitions=80)
    assert np.array_equal(np.asarray(ref_state.assignment),
                          np.asarray(state.assignment))
    ref_drifted = ref_state.replace(
        leader_load=np.asarray(drifted.leader_load),
        follower_load=np.asarray(drifted.follower_load))
    ref_cfg = TpuSearchConfig(**SMALL)
    ref_prev = TpuGoalOptimizer(config=ref_cfg).optimize(ref_state)
    ref = TpuGoalOptimizer(config=ref_cfg).optimize(
        ref_drifted, warm_start=warm_start_from(
            ref_prev, dirty, cls=RefWarmStart, ctx_cls=RefContext,
            signatures=ref_signatures, goals=ref_goals()))
    goals = make_goals()
    verify_result(drifted, port, goals)
    assert within_parity(violation_score(port.final_state, goals),
                         ref.violation_score_after)
    for key in ("reusedBefore", "reusedAfter", "fullVerify"):
        assert port.replan_verify[key] == ref.replan_verify[key], key


def _shape_drift(state, carry):
    # a different cluster: another broker axis and partition count
    return random_cluster(seed=14, num_brokers=12, num_racks=5,
                          num_partitions=96)


def _capacity_drift(state, carry):
    cap = np.asarray(state.broker_capacity).copy()
    cap[0] *= 1.25
    return state.replace(broker_capacity=torch.tensor(cap))


def _excluded(state, carry):
    return state


@pytest.mark.parametrize("change", [_shape_drift, _capacity_drift,
                                    _excluded])
def test_guard_uploads_in_full_and_exports_a_valid_carry(change):
    cfg, state, prev, carry, dirty, _ = cold_then_drift()
    changed = change(state, carry)
    options = None
    if change is _excluded:
        topic = int(np.asarray(state.partition_topic)[0])
        options = OptimizationOptions(excluded_topics={topic})
    if changed.num_partitions == state.num_partitions:
        ws = warm_start_from(prev, dirty)
    else:
        ws = WarmStart(assignment=np.asarray(changed.assignment),
                       leader_slot=np.asarray(changed.leader_slot),
                       dirty_partitions=np.ones(changed.num_partitions,
                                                bool))
    res = engine(cfg).optimize(changed, options, warm_start=ws, carry=carry)
    warm = res.goal_summaries[0]["warm"]
    assert not warm["table_carry"] and warm["marked_rows"] is None
    assert carry.valid and carry.model is not None
    assert carry.assignment.shape == (changed.num_partitions,
                                      np.asarray(changed.assignment).shape[1])
    assert np.array_equal(carry.assignment,
                          np.asarray(res.final_state.assignment))
    assert carry.model.capacity.shape[0] == changed.num_brokers


def test_carry_survives_an_intervening_same_shape_search():
    """The carry owns its tensors: planning another state of the same
    shape between the cold and the warm plan (a user rebalance, say),
    which overwrites the kept step loop's buffers, leaves the carry's
    tensors and the warm plan as they were, and the warm plan still rides
    the carried tables."""
    cfg, state, prev, carry, dirty, drifted = cold_then_drift(
        budget="incremental")
    kept = [t.clone() for t in carry.tables]
    kept_host = (carry.assignment.copy(), carry.leader_slot.copy(),
                 carry.pending_touched.copy())
    twin = ReplanCarry()
    twin_prev = engine(cfg).optimize(state, carry=twin)
    assert acts(twin_prev) == acts(prev)
    undisturbed = engine(cfg).optimize(
        drifted, warm_start=warm_start_from(prev, dirty), carry=twin)
    other = random_cluster(seed=99, num_brokers=10, num_racks=5,
                           num_partitions=80)
    engine(cfg).optimize(other)
    assert all(torch.equal(a, b) for a, b in zip(carry.tables, kept))
    assert all(np.array_equal(a, b) for a, b in zip(
        (carry.assignment, carry.leader_slot, carry.pending_touched),
        kept_host))
    warm = engine(cfg).optimize(
        drifted, warm_start=warm_start_from(prev, dirty), carry=carry)
    rode = warm.goal_summaries[0]["warm"]
    assert rode["table_carry"]
    assert rode["first_call_incremental"] == rode["first_call_repools"] >= 1
    assert acts(warm) == acts(undisturbed)
    assert np.array_equal(np.asarray(warm.final_state.assignment),
                          np.asarray(undisturbed.final_state.assignment))

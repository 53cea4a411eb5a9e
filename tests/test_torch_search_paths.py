"""Whole plans on the search's off-default paths, against the JAX reference
at the same config, on the CPU: the score-only rounds (``steps_per_call=0``
and ``scoring="columnar"``), polish after the resident search
(``polish_rounds``) and the corrected cohort (``cohort_mode="corrected"``,
with and without ``cohort_stack_tol``).  Each mirrors a reference test
(tests/test_tpu_optimizer.py: the dead-broker drain, the scoring paths,
the non-default knobs' quality bar).  Every plan must verify, score no
worse than the port's greedy oracle and land within max(2, 5 %) of the
reference's plan."""

import pytest

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.goal_optimizer import (
    make_goals as ref_make_goals,
)
from cruise_control_tpu.analyzer.verifier import (
    violation_score as ref_violation_score,
)
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
    CudaGoalOptimizer,
    CudaSearchConfig,
)
from cruise_control_tpu_torch.analyzer.goal_optimizer import (
    GoalOptimizer,
    make_goals,
)
from cruise_control_tpu_torch.analyzer.verifier import (
    verify_result,
    violation_score,
)
from cruise_control_tpu_torch.models import generators as gen


def plan(kw, cfg_kw, greedy=None):
    """The port's plan of ``random_cluster(**kw)`` at ``cfg_kw``, held to
    the bars → (result, score)."""
    state = gen.random_cluster(**kw)
    goals = make_goals()
    res = CudaGoalOptimizer(config=CudaSearchConfig(**cfg_kw),
                            device="cpu").optimize(state)
    verify_result(state, res, goals)
    score = violation_score(res.final_state, goals)
    if greedy is None:
        greedy = violation_score(
            GoalOptimizer(goals).optimize(state).final_state, goals)
    assert score <= greedy, (score, greedy)
    ref = T.TpuGoalOptimizer(config=T.TpuSearchConfig(**cfg_kw)).optimize(
        ref_gen.random_cluster(**kw))
    ref_score = ref_violation_score(ref.final_state, ref_make_goals())
    assert abs(score - ref_score) <= max(2, 0.05 * ref_score), (score,
                                                                ref_score)
    return res, score


def test_score_only_rounds_drain_dead_broker():
    """``steps_per_call=0``: the score-only rounds are the search, and a
    dead broker drains through per-source rows (reference
    test_score_only_path_drains_large_dead_broker)."""
    kw = dict(seed=17, num_brokers=12, num_racks=4, num_partitions=600,
              dead_brokers=1)
    res, _ = plan(kw, dict(max_rounds=150, steps_per_call=0, scoring="grid"))
    assert not (res.final_state.assignment.numpy() == 11).any()
    summ = res.goal_summaries[0]
    assert summ["goal"] == "CudaSearch" and "steps" not in summ
    assert summ["rounds"] > 1 and summ["accepted"] > 0
    assert set(summ["timing_s"]) == {"upload", "score", "fetch", "recheck",
                                     "resync"}
    assert all(a.goal == "CudaSearch" for a in res.actions[:summ["accepted"]])


@pytest.mark.parametrize("scoring", ["columnar", "grid"])
def test_scoring_paths_agree(scoring):
    """Both scoring forms plan to the same bar (reference
    test_engine_scoring_paths_agree); "columnar" runs the score-only
    rounds even with ``steps_per_call`` > 0."""
    kw = dict(seed=29, num_brokers=16, num_racks=4, num_partitions=96,
              mean_utilization=0.45)
    res, _ = plan(kw, dict(max_rounds=40, topk_per_round=64,
                           scoring=scoring))
    score_only = "steps" not in res.goal_summaries[0]
    assert score_only == (scoring == "columnar")


@pytest.fixture(scope="module")
def greedy_60b():
    """One greedy oracle on the 60b/1200p fixture the reference holds its
    non-default knobs to (tests/test_tpu_optimizer.py greedy_60b_baseline)."""
    kw = dict(seed=21, num_brokers=60, num_racks=6, num_partitions=1200)
    state = gen.random_cluster(**kw)
    goals = make_goals()
    return kw, violation_score(GoalOptimizer(goals).optimize(state)
                               .final_state, goals)


@pytest.mark.parametrize("stack_tol", [1.0, 0.25])
def test_corrected_cohort_holds_quality_bar(stack_tol, greedy_60b):
    kw, greedy = greedy_60b
    res, _ = plan(kw, dict(cohort_mode="corrected",
                           cohort_stack_tol=stack_tol), greedy)
    assert res.goal_summaries[0]["steps"] > 0


def test_polish_after_resident_search():
    """``polish_rounds=2``: the score-only rounds run after the resident
    search as "CudaPolish", on a model resynced from the host, and never
    leave the plan worse than the same search without them.  The resident
    search is cut short (two calls' action budget) so the polish has work
    left."""
    kw = dict(seed=3, num_brokers=20, num_racks=5, num_partitions=300,
              mean_utilization=0.4, distribution=gen.Distribution.EXPONENTIAL)
    cfg = dict(max_rounds=2, topk_per_round=128, max_moves_per_round=16,
               steps_per_call=4, device_batch_per_step=4)
    state = gen.random_cluster(**kw)
    goals = make_goals()
    base = CudaGoalOptimizer(config=CudaSearchConfig(**cfg),
                             device="cpu").optimize(state)
    res = CudaGoalOptimizer(config=CudaSearchConfig(polish_rounds=2, **cfg),
                            device="cpu").optimize(state)
    verify_result(state, res, goals)
    score = violation_score(res.final_state, goals)
    assert score <= violation_score(base.final_state, goals)
    goals_run = [s["goal"] for s in res.goal_summaries]
    assert goals_run[:2] == ["CudaSearch", "CudaPolish"]
    polish = res.goal_summaries[1]
    assert polish["rounds"] == 2 and polish["accepted"] > 0
    assert polish["timing_s"]["resync"] > 0
    assert [a.goal for a in res.actions].count("CudaPolish") == \
        polish["accepted"]
    ref_kw = dict(kw, distribution=ref_gen.Distribution.EXPONENTIAL)
    ref = T.TpuGoalOptimizer(config=T.TpuSearchConfig(
        polish_rounds=2, **cfg)).optimize(ref_gen.random_cluster(**ref_kw))
    ref_score = ref_violation_score(ref.final_state, ref_make_goals())
    assert abs(score - ref_score) <= max(2, 0.05 * ref_score)


@pytest.mark.parametrize("knob", [
    {"steps_per_call": 0},
    {"scoring": "columnar"},
    {"polish_rounds": 2},
    {"cohort_mode": "corrected"},
    {"incremental_rescore": True},
    {"time_budget_s": 1.0},
])
def test_ported_knobs_construct(knob):
    """The knobs of the off-default paths construct (they raised before
    their kernels were ported); the rest still raise
    (tests/test_torch_engine.py test_out_of_slice_knobs_raise)."""
    opt = CudaGoalOptimizer(config=CudaSearchConfig(**knob), device="cpu")
    assert opt.config == CudaSearchConfig(**knob)

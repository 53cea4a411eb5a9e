"""The anytime time budget (``time_budget_s``) on the CPU, against the JAX
reference.

The reference binds the budget at step granularity: a runtime step cap
``t_cap`` in its ``while_loop`` carry (``tpu_optimizer.py:1400-1406``),
sized by the host from a measured step rate (:3515-3594), and it never
cuts a plan before the hard goals hold.  The port carries the cap in the
device carry (``analyzer/step_state.py`` T_CAP), so capped and uncapped
calls run one step loop (on the card one captured chunk).  Mirrors
tests/test_tpu_optimizer.py ``test_time_budget_still_satisfies_hard_goals``
and ``test_anytime_budget_per_step_deadline``."""

import numpy as np
import pytest

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
from cruise_control_tpu_torch.analyzer.verifier import verify_result
from cruise_control_tpu_torch.models import generators as gen

ANYTIME = dict(seed=11, num_brokers=24, num_racks=6, num_partitions=300,
               mean_utilization=0.45)


def test_time_budget_still_satisfies_hard_goals():
    """A near-zero budget may cut soft-goal refinement short but never the
    hard goals: the dead broker is drained and the plan verifies (the
    reference's test of that name)."""
    kw = dict(seed=23, num_brokers=12, num_racks=4, num_partitions=200,
              dead_brokers=1)
    state = gen.random_cluster(**kw)
    cfg = C.CudaSearchConfig(max_rounds=60, time_budget_s=1e-6)
    res = C.CudaGoalOptimizer(config=cfg, device="cpu").optimize(state)
    verify_result(state, res, make_goals())
    assert not (res.final_state.assignment.numpy() == 11).any()
    ref = T.TpuGoalOptimizer(config=T.TpuSearchConfig(
        max_rounds=60, time_budget_s=1e-6)).optimize(
        ref_gen.random_cluster(**kw))
    assert not (np.asarray(ref.final_state.assignment) == 11).any()


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["default", "incremental"])
def test_capped_calls_share_one_loop(incremental):
    """A call capped at ``t_cap`` runs at most ``t_cap`` steps, and calls
    at caps 1, 7 and 48 all step on one loop (on the card: replay one
    captured chunk); the capped call equals the uncapped call's first
    ``t_cap`` steps."""
    state = gen.random_cluster(**ANYTIME,
                               distribution=gen.Distribution.EXPONENTIAL)
    cfg = C.CudaSearchConfig(steps_per_call=48, device_batch_per_step=8,
                             incremental_rescore=incremental)
    opt = C.CudaGoalOptimizer(config=cfg, device="cpu")
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    cfg = C._resolve_batch(cfg, ctx.num_brokers)
    consts = C.grid_consts(cfg, ca, "cpu")
    loop = C._StepLoop(m, cfg, ca, consts, K, D, 48)
    chunk = loop.chunk
    full, _, _ = C._scan_call(m, cfg, ca, consts, K, D, 48, C._cold_tables(m),
                              loop)
    assert full.diag["steps_run"] > 7
    for cap in (1, 7, 48):
        res, _, _ = C._scan_call(m, cfg, ca, consts, K, D, 48,
                                 C._cold_tables(m), loop, t_cap=cap)
        steps = res.diag["steps_run"]
        assert 0 < steps <= cap, (cap, steps)
        n = int(res.step_counts.sum())
        np.testing.assert_array_equal(res.step_counts,
                                      full.step_counts[:steps])
        for f in ("kind", "p", "s", "d"):
            np.testing.assert_array_equal(getattr(res, f),
                                          getattr(full, f)[:n])
        assert loop.chunk is chunk
    with pytest.raises(ValueError, match="step cap"):
        C._scan_call(m, cfg, ca, consts, K, D, 48, C._cold_tables(m), loop,
                     t_cap=49)


def test_step_cap_rides_the_carry():
    """The carry's step cap: the first step stays active, and the tail
    ends the loop at ``min(T, t_cap)`` steps (the plain twin of K8's)."""
    st = SS.StepState.empty(8, 4, 100, "cpu")
    st.state.copy_(st.initial(False))
    assert int(st.state[SS.T_CAP]) == 8
    SS.cap(st, 3)
    assert int(st.state[SS.ACTIVE]) == 1
    for step in range(3):
        SS.advance(st, 1, 0, 0, 0)
        assert int(st.state[SS.ACTIVE]) == (step < 2)
    for bad in (0, 9):
        with pytest.raises(ValueError):
            SS.cap(st, bad)


def test_anytime_budget_caps_calls_once_hard_goals_hold(monkeypatch):
    """While a dead broker is still being drained the budget never caps a
    call; once the hard goals hold, the first capped call is the probe
    (``min(steps_per_call, 256)``) and later caps come from the measured
    step rate, clipped to [1, steps_per_call]."""
    caps = []
    real = C._scan_call

    def spy(*a, t_cap=None, **k):
        caps.append(t_cap)
        return real(*a, t_cap=t_cap, **k)

    monkeypatch.setattr(C, "_scan_call", spy)
    state = gen.random_cluster(seed=23, num_brokers=12, num_racks=4,
                               num_partitions=200, dead_brokers=1)
    cfg = C.CudaSearchConfig(steps_per_call=2, device_batch_per_step=4,
                             time_budget_s=600.0)
    res = C.CudaGoalOptimizer(config=cfg, device="cpu").optimize(state)
    verify_result(state, res, make_goals())
    first = caps.index(next(c for c in caps if c is not None))
    assert first > 0 and all(c is None for c in caps[:first])
    assert caps[first] == 2 and all(1 <= c <= 2 for c in caps[first:])
    assert res.goal_summaries[0]["capped_calls"] == len(caps) - first


def test_budgeted_plan_commits_with_hard_goals_held():
    """A budgeted end-to-end run still commits work with the hard goals
    held (the reference's anytime test, its last part)."""
    state = gen.random_cluster(**ANYTIME,
                               distribution=gen.Distribution.EXPONENTIAL)
    for inc in (False, True):
        res = C.CudaGoalOptimizer(config=C.CudaSearchConfig(
            time_budget_s=0.5, steps_per_call=48, incremental_rescore=inc),
            device="cpu").optimize(state)
        assert res.actions, "budgeted run must still commit work"
        final_ctx = AnalyzerContext(res.final_state)
        for g in make_goals():
            if g.is_hard:
                assert g.violations(final_ctx) == 0, g.name


def test_budget_ends_the_score_only_rounds():
    """A spent budget starts no further score-only round once the hard
    goals hold (the reference's :3703): the rack repairs still run, then
    the rounds stop — fewer than without the budget — and the plan
    verifies."""
    state = gen.random_cluster(seed=5, num_brokers=12, num_racks=4,
                               num_partitions=120)
    goals = make_goals()
    assert any(g.violations(AnalyzerContext(state)) for g in goals
               if g.is_hard)

    def rounds(budget):
        res = C.CudaGoalOptimizer(config=C.CudaSearchConfig(
            steps_per_call=0, time_budget_s=budget), device="cpu"
        ).optimize(state)
        verify_result(state, res, goals)
        return res.goal_summaries[0]["rounds"]

    assert 1 <= rounds(1e-6) < rounds(0.0)

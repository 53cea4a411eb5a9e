"""The port's search engine against the JAX reference, on the CPU.

Selection primitives run on the same tie-free inputs (continuous random
scores) and must give the same integer outputs exactly; whole plans must
verify, beat or match the greedy oracle and land within the reference
engine's score (max(2, 5 %)); plans must repeat run to run."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import (
    AnalyzerContext as RefContext,
    OptimizationOptions as RefOptions,
)
from cruise_control_tpu.analyzer.goal_optimizer import (
    GoalOptimizer as RefGreedy,
    make_goals as ref_make_goals,
)
from cruise_control_tpu.analyzer.verifier import (
    violation_score as ref_violation_score,
)
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer import pool_kernels as PK
from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
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
from cruise_control_tpu_torch.models.convert import device_model_from_numpy

FAST = dict(max_rounds=40, topk_per_round=128, max_moves_per_round=32)


def _tuples(result):
    return [(int(a.action_type), a.partition, a.slot, a.source_broker,
             a.dest_broker, a.dest_slot) for a in result.actions]


def _t(x):
    return torch.tensor(np.asarray(x))


# ---- configuration ------------------------------------------------------------

def test_config_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(T.TpuSearchConfig)}
    port = {f.name: f.default for f in dataclasses.fields(CudaSearchConfig)}
    assert list(port) == list(ref)
    assert port == ref


@pytest.mark.parametrize("knob", [
    {"profiler_trace_dir": "trace"},
])
def test_out_of_slice_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        CudaGoalOptimizer(config=CudaSearchConfig(**knob), device="cpu")


def test_warm_start_and_mesh_raise():
    with pytest.raises(NotImplementedError, match="A11"):
        CudaGoalOptimizer(device="cpu", mesh=object())
    state = gen.random_cluster(seed=1, num_brokers=6, num_partitions=20)
    with pytest.raises(NotImplementedError, match="warm"):
        CudaGoalOptimizer(device="cpu").optimize(state, warm_start=object())


def test_unknown_knob_values_rejected():
    with pytest.raises(ValueError):
        CudaGoalOptimizer(config=CudaSearchConfig(scoring="bogus"),
                          device="cpu")


# ---- selection primitives ------------------------------------------------------

def test_match_batch_reference_example():
    score = [[-3.0, -1.0], [-2.0, -0.5], [-1.5, -0.2], [-1.0, -0.9]]
    dst = [[5, 6], [5, 7], [6, 4], [3, 2]]
    src, p = [0, 1, 2, 3], [10, 11, 12, 12]
    ref = T._match_batch(jnp.array(score), jnp.array(dst, jnp.int32),
                         jnp.array(src, jnp.int32), jnp.array(p, jnp.int32),
                         tol=-1e-4, B=8, P=16)
    got = C._match_batch(torch.tensor(score), torch.tensor(dst),
                         torch.tensor(src), torch.tensor(p), tol=-1e-4, B=8,
                         P=16)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed,caps", [(0, (1, 1)), (1, (1, 1)),
                                       (2, (2, 2)), (3, (3, 1))])
def test_match_batch_matches_reference(seed, caps):
    rng = np.random.default_rng(seed)
    N, A, B = 96, 4, 20
    score = np.sort(-rng.exponential(1.0, (N, A)), axis=1).astype(np.float32)
    score[rng.random((N, A)) < 0.1] = np.inf
    dst = rng.integers(0, B, (N, A)).astype(np.int32)
    src = rng.integers(0, B, N).astype(np.int32)
    p = rng.integers(0, N // 2, N).astype(np.int32)
    used = (rng.random(B) < 0.1, rng.random(B) < 0.1, rng.random(N) < 0.05)
    kw = dict(tol=-1e-4, B=B, P=N, dest_cap=caps[0], src_cap=caps[1])
    ref = T._match_batch(jnp.asarray(score), jnp.asarray(dst),
                         jnp.asarray(src), jnp.asarray(p),
                         init_used=tuple(jnp.asarray(u) for u in used), **kw)
    got = C._match_batch(_t(score), _t(dst), _t(src), _t(p),
                         init_used=tuple(_t(u) for u in used), **kw)
    assert np.asarray(ref[0]).any()
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_seg_prefix_fits_reference_example():
    ids = torch.tensor([5, 5, 2, 5, 2])
    vec = torch.tensor([[1.0], [1.0], [2.0], [1.0], [2.0]])
    budget = torch.zeros((8, 1))
    budget[5, 0], budget[2, 0] = 2.0, 3.0
    fits = C._seg_prefix_fits(ids, vec, budget, torch.ones(5, dtype=bool))
    assert fits.tolist() == [True, True, True, False, False]
    el2 = torch.tensor([False, True, True, True, True])
    assert C._seg_prefix_fits(ids, vec, budget, el2).tolist() == \
        [False, True, True, True, False]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_prefix_fits_and_budget_accept_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, nb, B = 200, 6, 12
    ids = rng.integers(0, B, n).astype(np.int32)
    sids = rng.integers(0, B, n).astype(np.int32)
    vec = rng.uniform(0.0, 1.0, (n, nb)).astype(np.float32)
    budget = rng.uniform(0.0, 6.0, (B, nb)).astype(np.float32)
    sbudget = rng.uniform(0.0, 6.0, (B, nb)).astype(np.float32)
    budget[0, 3] = np.inf
    elig = rng.random(n) < 0.8
    ref = T._seg_prefix_fits(jnp.asarray(ids), jnp.asarray(vec),
                             jnp.asarray(budget), jnp.asarray(elig))
    got = C._seg_prefix_fits(_t(ids), _t(vec), _t(budget), _t(elig))
    assert np.asarray(ref).any()
    assert np.array_equal(np.asarray(ref), got.numpy())
    ref_acc = T._budget_accept(jnp.asarray(ids), jnp.asarray(sids),
                               jnp.asarray(vec), jnp.asarray(budget),
                               jnp.asarray(sbudget), jnp.asarray(elig))
    got_acc = C._budget_accept(_t(ids), _t(sids), _t(vec), _t(budget),
                               _t(sbudget), _t(elig))
    assert np.array_equal(np.asarray(ref_acc), got_acc.numpy())


def test_topq_rows_per_src_reference_example():
    sb = torch.tensor([0, 0, 0, 1, 1, 2])
    score = torch.tensor([-5.0, -9.0, -7.0, -1.0, -2.0, float("inf")])
    rows, scores = C._topq_rows_per_src(sb, score, B=4, Q=2)
    assert rows.tolist() == [[1, 4, 6, 6], [2, 3, 6, 6]]
    assert scores[0, :2].tolist() == [-9.0, -2.0]
    assert torch.isinf(scores[:, 2:]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_topq_rows_per_src_matches_reference(seed):
    rng = np.random.default_rng(seed)
    K, B, Q = 500, 40, 4
    sb = rng.integers(0, B, K).astype(np.int32)
    best = rng.standard_normal(K).astype(np.float32)
    best[rng.random(K) < 0.2] = np.inf
    ref = T._topq_rows_per_src(jnp.asarray(sb), jnp.asarray(best), B, Q)
    got = C._topq_rows_per_src(_t(sb), _t(best), B, Q)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def _carried(seed=4, dead=1):
    state = ref_gen.random_cluster(seed=seed, num_brokers=16, num_racks=4,
                                   num_partitions=240, dead_brokers=dead)
    ctx = RefContext(state)
    opt = T.TpuGoalOptimizer()
    m = opt._device_model(ctx)
    can = opt._constraint_arrays_np(ctx)
    fields = {f.name: (None if getattr(m, f.name) is None
                       else np.asarray(getattr(m, f.name)))
              for f in dataclasses.fields(m)}
    return (m, {k: jnp.asarray(v) for k, v in can.items()},
            device_model_from_numpy(fields, "cpu"),
            {k: torch.as_tensor(v) for k, v in can.items()}, opt, ctx)


def test_leadership_scoring_and_reduction_match_reference():
    m, ca_r, pm, ca, opt, ctx = _carried()
    P, S = ctx.num_partitions, ctx.max_rf
    L = T._leadership_pool_size(P, S, 256)
    lp_r, lsl_r = T._leadership_pool(m, ca_r, L)
    lp, lsl = C._build_pools(pm, CudaSearchConfig(), ca, 256, 8)[3:]
    assert set(zip(lp.tolist(), lsl.tolist())) == set(
        zip(np.asarray(lp_r).tolist(), np.asarray(lsl_r).tolist()))
    prio_r = T._leadership_prio_rows(*T._leadership_prio_terms(m, ca_r),
                                     m.assignment, m.leader_slot,
                                     m.must_move, m.excluded)
    prio = PK._leadership_prio_rows(*PK._leadership_prio_terms(pm, ca),
                                   pm.assignment, pm.leader_slot,
                                   pm.must_move, pm.excluded)
    np.testing.assert_allclose(prio.numpy(), np.asarray(prio_r), rtol=1e-6)
    ones, zeros = jnp.ones(L, jnp.int32), jnp.zeros(L, jnp.int32)
    ls_r, f_r = T._score_candidates(m, opt.config, ca_r, ones, lp_r, lsl_r,
                                    zeros)
    ls, f = C._score_candidates(pm, CudaSearchConfig(), ca,
                                torch.ones(L, dtype=torch.int32), _t(lp_r),
                                _t(lsl_r), torch.zeros(L, dtype=torch.int32))
    assert np.array_equal(f.numpy(), np.asarray(f_r))
    fin = np.isfinite(np.asarray(ls_r))
    np.testing.assert_allclose(ls.numpy()[fin], np.asarray(ls_r)[fin],
                               rtol=1e-5, atol=1e-4)
    red_r = T._reduce_leadership_per_src(m, lp_r, lsl_r, ls_r)
    red = C._reduce_leadership_per_src(pm, _t(lp_r), _t(lsl_r), _t(ls_r))
    for a, b in zip(red_r, red):
        assert np.array_equal(np.asarray(a), b.numpy())
    sb_r, db_r = T._step_budgets(m, ca_r)
    sb, db = C._step_budgets(pm, ca)
    np.testing.assert_allclose(sb.numpy(), np.asarray(sb_r), rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_r), rtol=1e-5)


def test_recompute_aggregates_match_reference():
    m, _, pm, _, _, _ = _carried(seed=9, dead=2)
    got = C._recompute_aggregates(pm)
    for f in ("broker_load", "leader_nwin", "pot_nwout", "rcount", "lcount"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(m, f)), rtol=1e-6,
                                   err_msg=f)


# ---- whole plans -----------------------------------------------------------------

def _plan_pair(kw, excluded=None, ref_cfg=FAST):
    ref_state = ref_gen.random_cluster(**kw)
    ref_opts = RefOptions(excluded_topics=excluded) if excluded else None
    ref = T.TpuGoalOptimizer(config=T.TpuSearchConfig(**ref_cfg)).optimize(
        ref_state, ref_opts)
    ref_score = ref_violation_score(ref.final_state, ref_make_goals(),
                                    ref_opts)
    state = gen.random_cluster(**kw)
    opts = OptimizationOptions(excluded_topics=excluded) if excluded else None
    res = CudaGoalOptimizer(config=CudaSearchConfig(**ref_cfg),
                            device="cpu").optimize(state, opts)
    verify_result(state, res, make_goals(), opts)
    return state, res, violation_score(res.final_state, make_goals(), opts), \
        ref_score


def test_plan_beats_greedy_and_tracks_reference():
    kw = dict(seed=3, num_brokers=20, num_racks=5, num_partitions=300,
              mean_utilization=0.4)
    ref_kw = dict(kw, distribution=ref_gen.Distribution.EXPONENTIAL)
    ref_state = ref_gen.random_cluster(**ref_kw)
    ref = T.TpuGoalOptimizer(config=T.TpuSearchConfig(**FAST)).optimize(
        ref_state)
    ref_score = ref_violation_score(ref.final_state, ref_make_goals())
    state = gen.random_cluster(**dict(kw, distribution=gen.Distribution
                                      .EXPONENTIAL))
    goals = make_goals()
    res = CudaGoalOptimizer(config=CudaSearchConfig(**FAST),
                            device="cpu").optimize(state)
    verify_result(state, res, goals)
    score = violation_score(res.final_state, goals)
    greedy = violation_score(GoalOptimizer(goals).optimize(state).final_state,
                             goals)
    assert score <= greedy + 2, (score, greedy)
    assert abs(score - ref_score) <= max(2, 0.05 * ref_score), (score,
                                                                 ref_score)
    assert res.engine == "cuda" and res.goal_summaries[0]["steps"] > 0


def test_plan_dead_brokers_evacuated():
    kw = dict(seed=5, num_brokers=12, num_racks=4, num_partitions=120,
              dead_brokers=2)
    _, res, score, ref_score = _plan_pair(kw)
    fa = res.final_state.assignment.numpy()
    assert not np.isin(fa, [10, 11]).any()
    assert abs(score - ref_score) <= max(2, 0.05 * ref_score)


def test_plan_excluded_topics():
    kw = dict(seed=7, num_brokers=10, num_partitions=80, num_topics=4)
    _, res, score, ref_score = _plan_pair(kw, excluded={1})
    assert abs(score - ref_score) <= max(2, 0.05 * ref_score)


def test_plans_repeat_run_to_run():
    state = gen.random_cluster(seed=21, num_brokers=24, num_racks=6,
                               num_partitions=360, dead_brokers=1)
    cfg = CudaSearchConfig(steps_per_call=16, repool_steps=4,
                           repool_rows_budget=32, device_batch_per_step=16)
    a = CudaGoalOptimizer(config=cfg, device="cpu").optimize(state)
    b = CudaGoalOptimizer(config=cfg, device="cpu").optimize(state)
    assert _tuples(a) and _tuples(a) == _tuples(b)
    # several device calls with the incremental pool-table diet in play
    assert a.goal_summaries[0]["rounds"] > 1


def test_greedy_copy_matches_reference():
    kw = dict(seed=8, num_brokers=12, num_racks=4, num_partitions=150)
    ref_state = ref_gen.random_cluster(**kw)
    state = gen.random_cluster(**kw)
    ref = RefGreedy(ref_make_goals()).optimize(ref_state)
    res = GoalOptimizer(make_goals()).optimize(state)
    assert _tuples(res) == _tuples(ref)
    assert violation_score(res.final_state, make_goals()) == \
        ref_violation_score(ref.final_state, ref_make_goals())


def test_scan_call_matches_reference_with_and_without_pool_diet():
    """One device call of the step loop commits the same actions, step by
    step, as the reference's compiled scan — with the pool-table diet off,
    and on with a row budget small enough to force both the incremental
    refresh and its full-rebuild fallback (mirrors tests/test_drive_loop.py
    test_incremental_repool_scan_equivalence)."""
    kw = dict(seed=3, num_brokers=20, num_racks=5, num_partitions=300,
              mean_utilization=0.4)
    ref_state = ref_gen.random_cluster(
        **kw, distribution=ref_gen.Distribution.EXPONENTIAL)
    ctx = RefContext(ref_state)
    opt = T.TpuGoalOptimizer()
    can = opt._constraint_arrays_np(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    base = dict(steps_per_call=32, repool_steps=4, device_batch_per_step=32)
    cfg = T.TpuSearchConfig(repool_incremental=False, **base)
    packed, _, _ = T._cached_scan_fn(cfg, K, D, 32, None)(
        opt._device_model(ctx), {k: jnp.asarray(v) for k, v in can.items()},
        np.int32(32))
    kind, p, s, d, counts, done, _ = T._fetch_scan_result(packed, 32)

    state = gen.random_cluster(**kw, distribution=gen.Distribution.EXPONENTIAL)
    popt = CudaGoalOptimizer(device="cpu")
    pctx = C.AnalyzerContext(state)
    ca = {k: torch.as_tensor(v) for k, v in can.items()}
    consts = C.grid_consts(CudaSearchConfig(), ca, "cpu")
    incr = {}
    for diet, budget in ((False, 8192), (True, 24), (True, 128)):
        pcfg = CudaSearchConfig(repool_incremental=diet,
                                repool_rows_budget=budget, **base)
        m = popt._device_model(pctx)
        res, _, _ = C._scan_call(m, pcfg, ca, consts, K, D, 32,
                                 C._cold_tables(m))
        n = res.step_counts.size
        assert np.array_equal(res.step_counts, counts[:n]), (diet, budget)
        assert not counts[n:].any() and res.done == done
        for a, b in ((res.kind, kind), (res.p, p), (res.s, s), (res.d, d)):
            assert np.array_equal(a, b), (diet, budget)
        incr[budget] = res.diag["n_incremental_repool"]
    assert incr[128] > 0 and incr[24] <= incr[128]


def test_plan_heterogeneous_capacity_beats_greedy():
    """Budgeted-cohort safety under heterogeneous broker capacities (the
    capacity-normalized pivot of _step_budgets)."""
    B = 24
    scale = np.random.default_rng(11).uniform(0.4, 2.5, size=(B, 1))
    cap = (gen.DEFAULT_CAPACITY[None, :] * scale).astype(np.float32)
    state = gen.random_cluster(
        seed=11, num_brokers=B, num_racks=6, num_partitions=320,
        capacity=cap, mean_utilization=0.4,
        distribution=gen.Distribution.EXPONENTIAL,
    )
    goals = make_goals()
    res = CudaGoalOptimizer(config=CudaSearchConfig(**FAST),
                            device="cpu").optimize(state)
    verify_result(state, res, goals)
    greedy = GoalOptimizer(goals).optimize(state)
    assert violation_score(res.final_state, goals) <= \
        violation_score(greedy.final_state, goals) + 2


def test_plan_drains_dead_broker_over_many_calls():
    """A dead broker's replicas drain through many short device calls;
    host-recheck rejections resync the device model from the host and
    the search carries on."""
    state = gen.random_cluster(seed=17, num_brokers=12, num_racks=4,
                               num_partitions=600, dead_brokers=1)
    cfg = CudaSearchConfig(max_rounds=6, topk_per_round=256,
                           max_moves_per_round=512, steps_per_call=4,
                           device_batch_per_step=16)
    res = CudaGoalOptimizer(config=cfg, device="cpu").optimize(state)
    verify_result(state, res, make_goals())
    assert not (res.final_state.assignment.numpy() == 11).any()
    summary = res.goal_summaries[0]
    assert summary["rounds"] > 1 and summary["rejected"]


def test_plan_saturated_cluster_uses_swap_repair():
    """Count-saturated, over-capacity cluster: no single move is feasible,
    so the host swap repair fixes the residual hard violation."""
    from cruise_control_tpu_torch.analyzer.actions import ActionType
    from cruise_control_tpu_torch.analyzer.goals.base import (
        BalancingConstraint,
    )
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.models.builder import ClusterModelBuilder

    b = ClusterModelBuilder()
    cap = {Resource.CPU: 1e9, Resource.NW_IN: 1e9, Resource.NW_OUT: 1e9,
           Resource.DISK: 100.0}
    b0, b1 = b.add_broker("r0", cap), b.add_broker("r1", cap)
    for brokers, mb in (([b0], 60.0), ([b0], 30.0), ([b1], 10.0),
                        ([b1], 5.0)):
        b.add_partition("T", brokers, {Resource.CPU: 0.1, Resource.NW_IN: 0.1,
                                       Resource.NW_OUT: 0.1,
                                       Resource.DISK: mb})
    state = b.build()
    constraint = BalancingConstraint(max_replicas_per_broker=2)
    res = CudaGoalOptimizer(config=CudaSearchConfig(**FAST),
                            constraint=constraint,
                            device="cpu").optimize(state)
    verify_result(state, res, make_goals(constraint=constraint))
    assert [a.action_type for a in res.actions] == \
        [ActionType.INTER_BROKER_REPLICA_SWAP]


def test_plan_raises_on_impossible_hard_goal():
    from cruise_control_tpu_torch.analyzer.goals.base import (
        OptimizationFailure,
    )
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.models.builder import ClusterModelBuilder

    b = ClusterModelBuilder()
    cap = {r: 1e9 for r in Resource}
    b.add_broker("r0", cap)
    b.add_broker("r0", cap)
    b.add_partition("T", [0, 1], {Resource.DISK: 1.0})  # same rack, RF 2
    with pytest.raises(OptimizationFailure):
        CudaGoalOptimizer(config=CudaSearchConfig(**FAST),
                          device="cpu").optimize(b.build())

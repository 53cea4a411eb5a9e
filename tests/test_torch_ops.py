"""The port's device ops against the JAX reference, on the CPU: the fused
broker cost, the move grid (terms, scores, per-row top-R through the
kernel wrapper's plain path), the candidate-pool row tables and the
deterministic segment sums.

Both packages score the SAME model: the reference builds its DeviceModel
and pools, and ``device_model_from_numpy`` carries the arrays across.
Tolerances: the +inf (infeasible) mask must be identical; finite scores
agree within rtol 1e-5 / atol 1e-4 (f32 sums in another order, on scores
that carry 1e6 / 1e4 repair bonuses)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import (
    AnalyzerContext as RefContext,
    OptimizationOptions as RefOptions,
)
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.ops import cost as ref_cost
from cruise_control_tpu.ops import grid as ref_grid
from cruise_control_tpu.ops import pools as ref_pools
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
    CudaGoalOptimizer,
    CudaSearchConfig,
    _recompute_aggregates,
)
from cruise_control_tpu_torch.models.convert import device_model_from_numpy
from cruise_control_tpu_torch.models.generators import random_cluster
from cruise_control_tpu_torch.ops import cost, grid, pools
from cruise_control_tpu_torch.ops.segment import (
    segment_excl_prefix_sorted,
    segment_sum,
)

RTOL, ATOL = 1e-5, 1e-4
CFG = CudaSearchConfig()

CASES = {
    "healthy": (dict(seed=3, num_brokers=20, num_racks=5,
                     num_partitions=300), None),
    # dead brokers put must-move replicas (and offline origins) in the
    # pools; excluded topics switch the exclusion mask on
    "dead_excluded": (dict(seed=5, num_brokers=14, num_racks=4,
                           num_partitions=200, num_topics=4,
                           dead_brokers=2), {1, 2}),
}


@functools.lru_cache(maxsize=None)
def _carried(case):
    """(reference model/constraints/pools, port model/constraints/pools)
    over one placement."""
    kw, excl = CASES[case]
    ref_state = ref_random(**kw)
    ctx = RefContext(ref_state, RefOptions(excluded_topics=excl)
                     if excl else None)
    opt = T.TpuGoalOptimizer()
    m = opt._device_model(ctx)
    can = opt._constraint_arrays_np(ctx)
    ca_ref = {k: jnp.asarray(v) for k, v in can.items()}
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    kp, ks, dest_pool, lp, lsl = T._build_pools(m, opt.config, ca_ref, K, D)
    fields = {f.name: (None if getattr(m, f.name) is None
                       else np.asarray(getattr(m, f.name)))
              for f in dataclasses.fields(m)}
    pm = device_model_from_numpy(fields, device="cpu")
    ca = {k: torch.as_tensor(v) for k, v in can.items()}
    to_t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    ref = (m, opt.config, ca_ref, kp, ks, dest_pool)
    port = (pm, CFG, ca, to_t(kp), to_t(ks), to_t(dest_pool))
    return ref, port


def test_broker_cost_matches_reference():
    ref, port = _carried("healthy")
    m, _, ca_ref, *_ = ref
    pm, _, ca, *_ = port
    rng = np.random.default_rng(1)
    n = 64
    b = rng.integers(0, m.capacity.shape[0], n)
    load = np.asarray(m.broker_load)[b] * rng.uniform(0.5, 1.5, (n, 1))
    lnwin = np.asarray(m.leader_nwin)[b] * rng.uniform(0.5, 1.5, n)
    pot = np.asarray(m.pot_nwout)[b] * rng.uniform(0.5, 1.5, n)
    rc = np.asarray(m.rcount)[b] + rng.integers(-3, 4, n)
    lc = np.asarray(m.lcount)[b] + rng.integers(-3, 4, n)
    cap = np.asarray(m.capacity)[b]
    args = [x.astype(np.float32) for x in (cap, load, lnwin, pot, rc, lc)]
    want = np.asarray(ref_cost.broker_cost(T.TpuSearchConfig(), ca_ref,
                                           *map(jnp.asarray, args)))
    got = cost.broker_cost(CFG, ca, *map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_move_grid_matches_reference(case):
    ref, port = _carried(case)
    m, cfg_r, ca_r, kp, ks, dp = ref
    pm, cfg, ca, pkp, pks, pdp = port
    t_ref = ref_grid.move_grid_terms(m, cfg_r, ca_r, kp, ks)
    t = grid.move_grid_terms(pm, cfg, ca, pkp, pks)
    for k in ("row", "origin_row", "other_racks", "src", "leader_now",
              "slot_exists", "excluded", "must_move"):
        assert np.array_equal(t[k].numpy(), np.asarray(t_ref[k])), k
    for k in ("move_load", "cmove_load", "l_delta", "lnwin_delta",
              "pot_delta", "src_term"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(t_ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    g_ref = np.asarray(ref_grid.move_grid_scores(m, cfg_r, ca_r, kp, ks, dp))
    g = grid.move_grid_scores(pm, cfg, ca, pkp, pks, pdp).numpy()
    assert np.array_equal(np.isinf(g), np.isinf(g_ref))
    fin = np.isfinite(g_ref)
    assert fin.any()
    np.testing.assert_allclose(g[fin], g_ref[fin], rtol=RTOL, atol=ATOL)
    if case == "dead_excluded":
        assert t["must_move"].any() and t["excluded"].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_top_r_plain_matches_reference(case):
    ref, port = _carried(case)
    m, cfg_r, ca_r, kp, ks, dp = ref
    pm, cfg, ca, pkp, pks, pdp = port
    R = min(T.DESTS_PER_SOURCE, dp.shape[0])
    g_ref = ref_grid.move_grid_scores(m, cfg_r, ca_r, kp, ks, dp)
    neg, idx_ref = T._grid_top_r(cfg_r, -g_ref, R)
    s_ref, idx_ref = -np.asarray(neg), np.asarray(idx_ref)
    terms = grid.move_grid_terms(pm, cfg, ca, pkp, pks)
    before = grid.launch_grid_top_r.launches
    s, idx = grid.grid_top_r_plain(pm, cfg, ca, pkp, pks, pdp, terms, R)
    assert grid.launch_grid_top_r.launches == before
    s, idx = s.numpy(), idx.numpy()
    assert s.shape == (pkp.shape[0], R) and idx.dtype == np.int32
    assert np.array_equal(np.isinf(s), np.isinf(s_ref))
    fin = np.isfinite(s_ref)
    np.testing.assert_allclose(s[fin], s_ref[fin], rtol=RTOL, atol=ATOL)
    # tie-free rows (adjacent ranked scores further apart than the
    # tolerance, over R+1 ranks) pick the same destinations in order
    full = np.sort(np.asarray(g_ref), axis=1)[:, : R + 1]
    with np.errstate(invalid="ignore"):
        gap = np.diff(full, axis=1)
        # +inf entries order by index on both sides, so they never tie
        tie_free = np.all((gap > ATOL + RTOL * np.abs(full[:, 1:]))
                          | np.isinf(full[:, 1:]), axis=1)
    assert tie_free.sum() > 0
    assert np.array_equal(idx[tie_free], idx_ref[tie_free])


def test_grid_top_r_ops_counts_cells():
    assert grid.grid_top_r_ops(10, 0, 3, 0) == 10 * (grid.GRID_CELL_OPS + 9)
    assert (grid.grid_top_r_ops(10, 4, 3, 0)
            - grid.grid_top_r_ops(10, 0, 3, 0) == 4 * grid.GRID_FEASIBLE_OPS)
    # the leader-count terms: two a column, once a launch, not once a cell
    assert (grid.grid_top_r_ops(10, 4, 3, 5)
            - grid.grid_top_r_ops(10, 4, 3, 0) == 5 * 2 * 12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_row_tables_match_reference(case):
    ref, port = _carried(case)
    m, _, ca_r, *_ = ref
    pm, _, ca, *_ = port
    size_r, base_r = (np.asarray(x) for x in ref_pools.pool_row_tables(m))
    size, base = (x.numpy() for x in pools.pool_row_tables(pm))
    np.testing.assert_allclose(size, size_r, rtol=RTOL)
    assert np.array_equal(base, base_r)
    prio_r = np.asarray(ref_pools.pool_prio(m, ca_r, size_r, base_r))
    prio = pools.pool_prio(pm, ca, torch.as_tensor(size),
                           torch.as_tensor(base)).numpy()
    assert np.array_equal(np.isinf(prio), np.isinf(prio_r))
    fin = np.isfinite(prio_r)
    np.testing.assert_allclose(prio[fin], prio_r[fin], rtol=RTOL, atol=ATOL)


def test_incremental_pool_row_tables_bit_identical():
    """Refreshing only the touched rows after a batch of placement
    mutations reproduces the from-scratch tables bit-for-bit (mirrors
    tests/test_drive_loop.py's reference check)."""
    state = random_cluster(seed=17, num_brokers=20, num_racks=5,
                           num_partitions=300)
    opt = CudaGoalOptimizer(device="cpu")
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    size0, base0 = pools.pool_row_tables(m)
    rng = np.random.default_rng(0)
    P, S = ctx.num_partitions, ctx.max_rf
    touched = np.zeros(P, bool)
    assignment = m.assignment.numpy().copy()
    leader_slot = m.leader_slot.numpy().copy()
    for _ in range(4):
        for p in rng.choice(P, size=12, replace=False):
            s = int(rng.integers(0, S))
            if rng.random() < 0.5 and assignment[p, s] >= 0:
                assignment[p, s] = int(rng.integers(0, ctx.num_brokers))
            occupied = np.nonzero(assignment[p] >= 0)[0]
            leader_slot[p] = int(rng.choice(occupied))
            touched[p] = True
    m2 = _recompute_aggregates(dataclasses.replace(
        m, assignment=torch.as_tensor(assignment),
        leader_slot=torch.as_tensor(leader_slot)))
    full = pools.pool_row_tables(m2)
    incr = pools.pool_row_tables_update(m2, size0, base0,
                                        torch.as_tensor(touched), 64)
    for a, b in zip(full, incr):
        assert torch.equal(a, b)


def test_segment_sum_exact_and_order_free():
    rng = np.random.default_rng(5)
    n, b = 5000, 37
    v = (rng.standard_normal((n, 4)) * 10.0 ** rng.integers(-3, 6, (n, 1))
         ).astype(np.float32)
    ids = rng.integers(0, b, n)
    want = np.zeros((b, 4))
    np.add.at(want, ids, v.astype(np.float64))
    got = segment_sum(torch.as_tensor(v), torch.as_tensor(ids), b)
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                               rtol=1e-6, atol=1e-6 * np.abs(v).sum())
    perm = rng.permutation(n)
    again = segment_sum(torch.as_tensor(v[perm]), torch.as_tensor(ids[perm]),
                        b)
    assert torch.equal(got, again)            # summation order is irrelevant
    cnt = segment_sum(torch.ones(n, dtype=torch.int32), torch.as_tensor(ids),
                      b)
    assert np.array_equal(cnt.numpy(), np.bincount(ids, minlength=b))


def test_segment_excl_prefix_sorted():
    sv = torch.tensor([[1.0], [2.0], [4.0], [8.0], [16.0]])
    first = torch.tensor([True, False, False, True, False])
    out = segment_excl_prefix_sorted(sv, first)
    assert out[:, 0].tolist() == [0.0, 1.0, 3.0, 0.0, 8.0]

"""The repool's wrappers on the CPU — K10 ``pool_tables`` (the row tables,
priorities and destination scores) and K11 ``top_select`` (exact top-k) —
against the JAX reference.

On CPU tensors the wrappers run their plain twins, the versions the card's
kernels are held to bit for bit in ``chip_smoke.py``.  Both packages read
the same model (``tests/test_torch_ops.py``'s carried cases).  Tolerances
as there: ``base`` and every -inf pattern exact, ``size`` within rtol
1e-5, priorities within rtol 1e-5 / atol 1e-4 (f32 sums in another order,
on priorities that carry 1e6 / 1e5 repair bonuses).  K11's indices must
equal ``jax.lax.top_k``'s exactly, in order, on tie-rich keys."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.ops import pools as ref_pools
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer import pool_kernels as PK
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
    CudaGoalOptimizer,
    _recompute_aggregates,
)
from cruise_control_tpu_torch.models.generators import random_cluster
from test_torch_ops import ATOL, CASES, RTOL, _carried


def _carry(pt_valid=False, active=1, need_pool=1):
    st = SS.StepState.empty(4, 4, 8, "cpu")
    st.state.copy_(st.initial(pt_valid))
    st.state[SS.ACTIVE] = active
    st.state[SS.NEED_POOL] = need_pool
    return st.state


def _buffers(m, K=16, D=4, L=16):
    P, S = m.assignment.shape
    return PK.PoolBuffers.empty(P, S, m.capacity.shape[0], K, D, L, "cpu")


def _close(got, want):
    want = np.asarray(want)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.array_equal(got[np.isinf(got)], want[np.isinf(want)])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_tables_match_reference(case):
    ref, port = _carried(case)
    m, _, ca_r, *_ = ref
    pm, _, ca, *_ = port
    pb, state = _buffers(pm), _carry()
    pb.tpp[::7] = True
    before = PK.pool_tables.launches
    PK.pool_tables(pm, ca, pb, state, -1)
    assert PK.pool_tables.launches == before        # CPU: the plain twin
    size_r, base_r = ref_pools.pool_row_tables(m)
    np.testing.assert_allclose(pb.size.numpy(), np.asarray(size_r),
                               rtol=RTOL)
    assert np.array_equal(pb.base.numpy(), np.asarray(base_r))
    _close(pb.prio.numpy(), ref_pools.pool_prio(m, ca_r, size_r, base_r))
    _close(pb.lprio.numpy(), T._leadership_prio_rows(
        *T._leadership_prio_terms(m, ca_r), m.assignment, m.leader_slot,
        m.must_move, m.excluded))
    util = m.broker_load / jnp.maximum(m.capacity, 1e-9)
    _close(pb.dneg.numpy(), -(jnp.max(util, axis=1)
                              + jnp.where(m.dest_ok, 0.0, jnp.inf)))
    # the carry: a full repool ran and consumed the touched set
    s = state.tolist()
    assert (s[SS.REPOOL], s[SS.FULL], s[SS.N_INCR], s[SS.N_REPOOL]) \
        == (1, 1, 0, 1)
    assert (s[SS.SINCE_POOL], s[SS.PT_VALID], s[SS.NEED_POOL]) == (0, 1, 0)
    assert not pb.tpp.any()


def test_pool_tables_incremental_equals_full_and_follows_the_carry():
    """Refreshing only the touched rows reproduces the full rebuild
    bit for bit; an inactive step, a step that needs no repool and an
    over-budget touched set behave as the reference's :1016-1022."""
    state = random_cluster(seed=17, num_brokers=20, num_racks=5,
                           num_partitions=300)
    opt = CudaGoalOptimizer(device="cpu")
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    stored = _buffers(m)
    PK.pool_tables(m, ca, stored, _carry(), -1)
    rng = np.random.default_rng(0)
    P, S = ctx.num_partitions, ctx.max_rf
    touched = np.zeros(P, bool)
    assignment = m.assignment.numpy().copy()
    leader_slot = m.leader_slot.numpy().copy()
    for p in rng.choice(P, size=40, replace=False):
        s = int(rng.integers(0, S))
        if assignment[p, s] >= 0:
            assignment[p, s] = int(rng.integers(0, ctx.num_brokers))
        leader_slot[p] = int(rng.choice(np.nonzero(assignment[p] >= 0)[0]))
        touched[p] = True
    m2 = _recompute_aggregates(dataclasses.replace(
        m, assignment=torch.as_tensor(assignment),
        leader_slot=torch.as_tensor(leader_slot)))
    full = _buffers(m2)
    PK.pool_tables(m2, ca, full, _carry(), -1)

    incr = copy.deepcopy(stored)
    incr.tpp.copy_(torch.as_tensor(touched))
    st = _carry(pt_valid=True)
    PK.pool_tables(m2, ca, incr, st, 64)
    assert (int(st[SS.FULL]), int(st[SS.N_INCR])) == (0, 1)
    for f in dataclasses.fields(full):
        assert torch.equal(getattr(incr, f.name), getattr(full, f.name)), \
            f.name

    # over budget, or tables not valid: every row is rebuilt
    for budget, valid in ((39, True), (64, False)):
        over = copy.deepcopy(stored)
        over.tpp.copy_(torch.as_tensor(touched))
        st = _carry(pt_valid=valid)
        PK.pool_tables(m2, ca, over, st, budget)
        assert (int(st[SS.FULL]), int(st[SS.N_INCR])) == (1, 0)
        assert torch.equal(over.prio, full.prio)
    # no repool asked for, or an inactive step: nothing is written
    for active, need in ((1, 0), (0, 1)):
        idle = copy.deepcopy(stored)
        st = _carry(active=active, need_pool=need)
        PK.pool_tables(m2, ca, idle, st, 64)
        assert int(st[SS.REPOOL]) == 0
        for f in dataclasses.fields(idle):
            assert torch.equal(getattr(idle, f.name),
                               getattr(stored, f.name)), f.name


def _keys(kind, rng):
    """Seeded tie-rich keys: a few values (±0.0, -inf and +inf among
    them) with some normal noise, or mostly -inf (fewer finite than k)."""
    vals = np.array([-np.inf, -0.0, 0.0, 1.0, 2.5, -3.0, 1e5, np.inf],
                    np.float32)
    if kind == "few_finite":
        x = np.full(5000, -np.inf, np.float32)
        x[rng.choice(5000, 40, replace=False)] = rng.choice(vals[:6], 40)
        return x, 300, 1
    n = 20000 if kind == "tie_rich" else 3 * 4001
    x = rng.choice(vals, n)
    noisy = rng.random(n) < 0.2
    x[noisy] = rng.normal(size=int(noisy.sum())).astype(np.float32)
    return x, (2048 if kind == "tie_rich" else 4096), \
        (1 if kind == "tie_rich" else 3)


@pytest.mark.parametrize("kind", ["tie_rich", "few_finite", "slots"])
def test_top_select_matches_xla_top_k(kind):
    x, k, S = _keys(kind, np.random.default_rng(7))
    _, want = jax.lax.top_k(jnp.asarray(x), k)
    want = np.asarray(want)
    hi = torch.full((k,), -1, dtype=torch.int32)
    lo, flat = hi.clone(), torch.full((k,), -1, dtype=torch.int64)
    before = PK.top_select.launches
    PK.top_select(torch.tensor(x), hi, lo, flat, S=S)
    assert PK.top_select.launches == before
    assert np.array_equal(flat.numpy(), want)
    assert np.array_equal(hi.numpy(), want // S)
    assert np.array_equal(lo.numpy(), want % S)
    # the carry's repool flag gates it: no repool, nothing written
    state = torch.zeros(SS.NSTATE, dtype=torch.int32)
    idle = torch.full((k,), -1, dtype=torch.int32)
    PK.top_select(torch.tensor(x), idle, state=state)
    assert (idle == -1).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_pools_matches_reference(case):
    """A whole repool (K10, then K11 three times) selects the reference's
    pools: its top-K move slots and top-D destinations exactly; its top-L
    leadership slots as ``jax.lax.top_k`` orders them over the reference's
    priority (the reference's own ``approx_max_k`` keeps the same slots but
    orders ties its own way on the CPU)."""
    ref, port = _carried(case)
    m, cfg, ca_r, kp_r, ks_r, dp_r = ref
    pm, pcfg, ca, *_ = port
    K, D = kp_r.shape[0], dp_r.shape[0]
    P, S = pm.assignment.shape
    kp, ks, dp, lp, lsl = C._build_pools(pm, pcfg, ca, K, D)
    for name, a, b in (("kp", kp, kp_r), ("ks", ks, ks_r),
                       ("dest_pool", dp, dp_r)):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    L = C._leadership_pool_size(P, S, K)
    flat = T._leadership_prio_rows(
        *T._leadership_prio_terms(m, ca_r), m.assignment, m.leader_slot,
        m.must_move, m.excluded).reshape(-1)
    want = np.asarray(jax.lax.top_k(flat, L)[1])
    assert np.array_equal(lp.numpy(), want // S)
    assert np.array_equal(lsl.numpy(), want % S)
    lp_r, lsl_r = T._leadership_pool(m, ca_r, L)
    assert set(zip(lp.tolist(), lsl.tolist())) == set(
        zip(np.asarray(lp_r).tolist(), np.asarray(lsl_r).tolist()))

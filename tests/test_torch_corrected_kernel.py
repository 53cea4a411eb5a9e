"""K15's wrapper (the corrected cohort, B16) on the CPU, against the JAX
reference.

The rows are the compacted rows of a first step — what the step hands the
cohort — of the port's own step loop on the seeded fixtures of
tests/test_torch_step_kernels.py, with mean and with percentile capacity
loads, at ``cohort_stack_tol`` 1.0 (no stacking guard) and 0.25.  The
reference sums each row's segment prefix in f32 in XLA's order, the port
exactly (fixed point), so an accept decision could differ only on a row
that sits on one of the comparisons' boundaries: the tests recompute
every compared quantity in f64 and fail unless each is clear of its
boundary by MARGIN relative to its terms, then hold the accept masks
equal.  One whole scan call with the corrected cohort must commit the
reference's actions step by step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu_torch.analyzer import corrected_kernel as K15
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.models import generators as gen
from test_torch_step_kernels import carried

#: the least distance, relative to the magnitudes compared, between an f64
#: recomputation of a compared quantity and its boundary: f32 sums of a
#: few dozen terms in another order stay ~1e-6 relative apart
MARGIN = 1e-4


def first_step_rows(pm, ca, cfg):
    """The compacted rows the port's first step hands its cohort."""
    P, S = pm.assignment.shape
    K, D = C.CudaGoalOptimizer(device="cpu")._pool_sizes(
        P, S, pm.capacity.shape[0])
    cfg = C._resolve_batch(cfg, pm.capacity.shape[0])
    seen = []
    real = C.compact_rows

    def shim(*a, **k):
        out = real(*a, **k)
        if not seen:
            seen.append(out)
        return out

    C.compact_rows = shim
    try:
        C._scan_call(pm, cfg, ca, C.grid_consts(cfg, ca, "cpu"), K, D, 1,
                     C._cold_tables(pm))
    finally:
        C.compact_rows = real
    return seen[0]


def f64_margins(pm, cfg, can, c):
    """(stacked rows, the least relative distance of any compared quantity
    of a qualified row from its boundary), every sum and cost in f64."""
    R = NUM_RESOURCES
    has_cap = pm.broker_cload is not None
    vec = c.move_vec.numpy().astype(np.float64)
    qual = c.qual.numpy()
    d0 = c.d0.numpy()
    src = np.maximum(c.cand_src.numpy(), 0)

    def excl(ids):
        out = np.zeros_like(vec)
        run = {}
        for i, b in enumerate(ids):
            out[i] = run.get(b, 0.0)
            if qual[i]:
                run[b] = run.get(b, 0.0) + vec[i]
        return out

    Xd, Ys = excl(d0), excl(src)
    bl = pm.broker_load.numpy().astype(np.float64)
    bcl = pm.broker_cload.numpy().astype(np.float64) if has_cap else bl
    cap = pm.capacity.numpy().astype(np.float64)
    rc, po, lnw, lc = (getattr(pm, f).numpy().astype(np.float64) for f in
                       ("rcount", "pot_nwout", "leader_nwin", "lcount"))
    L, n1, pot1 = vec[:, :R], vec[:, R], vec[:, R + 1]
    Lc = vec[:, R + 2:] if has_cap else L
    XdC = Xd[:, R + 2:] if has_cap else Xd[:, :R]
    YsC = Ys[:, R + 2:] if has_cap else Ys[:, :R]

    def cost(b, load, pot, rcount, cl):
        return C._np_broker_cost_batch(cfg, can, cap[b], load, lnw[b], pot,
                                     rcount, lc[b],
                                     cload=cl if has_cap else None)

    d_lo = cost(d0, bl[d0] + Xd[:, :R], po[d0] + Xd[:, R + 1],
                rc[d0] + Xd[:, R], bcl[d0] + XdC)
    d_hi = cost(d0, bl[d0] + Xd[:, :R] + L, po[d0] + Xd[:, R + 1] + pot1,
                rc[d0] + Xd[:, R] + n1, bcl[d0] + XdC + Lc)
    s_lo = cost(src, bl[src] - Ys[:, :R], po[src] - Ys[:, R + 1],
                rc[src] - Ys[:, R], bcl[src] - YsC)
    s_hi = cost(src, bl[src] - Ys[:, :R] - L, po[src] - Ys[:, R + 1] - pot1,
                rc[src] - Ys[:, R] - n1, bcl[src] - YsC - Lc)
    mags = np.abs(d_lo) + np.abs(d_hi) + np.abs(s_lo) + np.abs(s_hi) + 1.0
    corrected = (d_hi - d_lo) + (s_hi - s_lo)
    # friction and the evacuation / rack-repair bonuses
    extra = (vec[:, Resource.DISK] / float(can["avg_disk_cap"])
             * cfg.w_move_size)
    S = pm.assignment.shape[1]
    cs = np.clip(c.cand_s.numpy(), 0, S - 1)
    p = c.cand_p.numpy()
    row = pm.assignment.numpy()[p]
    racks = np.where(row != -1, pm.rack.numpy()[np.maximum(row, 0)], -1)
    mine = racks[np.arange(len(p)), cs]
    lower = np.arange(S)[None, :] < cs[:, None]
    viol = (lower & (racks == mine[:, None]) & (row != -1)).any(1)
    must = pm.must_move.numpy()[p, cs]
    extra = extra + np.where(must, -1e6, 0.0) + np.where(viol, -1e4, 0.0)
    corrected = corrected + extra
    dist = [np.abs(corrected - cfg.improvement_tol) / mags]
    stack = (bcl[d0] + XdC + Lc)
    lim = cap[d0] * can["cap_threshold"][None, :] + 1e-6
    dist.append((np.abs(stack - lim) / (np.abs(stack) + np.abs(lim)
                                        + 1.0)).min(axis=1))
    stacked = (Xd[:, R] + Ys[:, R]) > 0
    if cfg.cohort_stack_tol < 1.0:
        snap = c.cand_score[:, 0].numpy().astype(np.float64)
        guard = snap * (1.0 - cfg.cohort_stack_tol)
        dist.append(np.where(stacked, np.abs(corrected - guard)
                             / (mags + np.abs(guard)), np.inf))
    least = min(float(d[qual].min()) for d in dist) if qual.any() else \
        np.inf
    return stacked & qual, least


@pytest.mark.parametrize("stack_tol", [1.0, 0.25])
@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_corrected_accept_matches_reference(cload, stack_tol):
    (m, ca_r, _, _), (pm, ca, _) = carried(4, cload)
    cfg = C.CudaSearchConfig(cohort_mode="corrected",
                             cohort_stack_tol=stack_tol)
    c = first_step_rows(pm, ca, cfg)
    can = {k: v.numpy() for k, v in ca.items()}
    stacked, least = f64_margins(pm, cfg, can, c)
    assert stacked.sum() >= 3, "no stacked qualified rows to test"
    assert least > MARGIN, ("a compared quantity sits within MARGIN of its "
                            "boundary", least)
    got = K15._corrected_accept(
        pm, cfg, ca, c.cand_p, c.cand_s, c.cand_src, c.d0, c.move_vec,
        c.qual, cfg.improvement_tol, snap_score=c.cand_score[:, 0])
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    want = T._corrected_accept(
        m, T.TpuSearchConfig(cohort_mode="corrected",
                             cohort_stack_tol=stack_tol), ca_r,
        j(c.cand_p), j(c.cand_s), j(c.cand_src), j(c.d0), j(c.move_vec),
        j(c.qual), cfg.improvement_tol, snap_score=j(c.cand_score[:, 0]))
    want = np.asarray(want)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)
    # accepted rows include stacked ones (the point of the cohort)
    assert (want & stacked).any()


def test_corrected_wrapper_on_cpu_is_the_twin():
    (_, _, _, _), (pm, ca, _) = carried(4, True)
    cfg = C.CudaSearchConfig(cohort_mode="corrected", cohort_stack_tol=0.25)
    c = first_step_rows(pm, ca, cfg)
    args = (pm, cfg, ca, c.cand_p, c.cand_s, c.cand_src, c.d0, c.move_vec,
            c.qual, cfg.improvement_tol)
    before = K15.corrected_accept.launches
    got = K15.corrected_accept(*args, snap_score=c.cand_score[:, 0])
    assert K15.corrected_accept.launches == before
    assert torch.equal(got, K15._corrected_accept(
        *args, snap_score=c.cand_score[:, 0]))
    # without a snapshot score the guard is off
    assert torch.equal(K15.corrected_accept(*args),
                       K15._corrected_accept(*args))


@pytest.mark.parametrize("stack_tol", [1.0, 0.25])
def test_scan_call_with_corrected_cohort_matches_reference(stack_tol):
    """One device call of the step loop with the corrected cohort commits
    the reference's actions, step by step."""
    kw = dict(seed=3, num_brokers=20, num_racks=5, num_partitions=300,
              mean_utilization=0.4)
    ref_state = ref_gen.random_cluster(
        **kw, distribution=ref_gen.Distribution.EXPONENTIAL)
    ctx = RefContext(ref_state)
    opt = T.TpuGoalOptimizer()
    can = opt._constraint_arrays_np(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    base = dict(steps_per_call=32, repool_steps=4, device_batch_per_step=32,
                cohort_mode="corrected", cohort_stack_tol=stack_tol)
    packed, _, _ = T._cached_scan_fn(T.TpuSearchConfig(**base), K, D, 32,
                                     None)(
        opt._device_model(ctx), {k: jnp.asarray(v) for k, v in can.items()},
        np.int32(32))
    kind, p, s, d, counts, done, _ = T._fetch_scan_result(packed, 32)

    state = gen.random_cluster(**kw, distribution=gen.Distribution.EXPONENTIAL)
    popt = C.CudaGoalOptimizer(device="cpu")
    pctx = C.AnalyzerContext(state)
    ca = {k: torch.as_tensor(v) for k, v in can.items()}
    pcfg = C.CudaSearchConfig(**base)
    m = popt._device_model(pctx)
    before = (C.corrected_accept.launches, C.budget_accept.launches)
    res, _, _ = C._scan_call(m, pcfg, ca, C.grid_consts(pcfg, ca, "cpu"), K,
                             D, 32, C._cold_tables(m))
    assert (C.corrected_accept.launches, C.budget_accept.launches) == before
    n = res.step_counts.size
    assert n > 1 and res.step_counts.sum() > 0
    np.testing.assert_array_equal(res.step_counts, counts[:n])
    assert not counts[n:].any() and res.done == done
    for a, b in ((res.kind, kind), (res.p, p), (res.s, s), (res.d, d)):
        np.testing.assert_array_equal(a, b)

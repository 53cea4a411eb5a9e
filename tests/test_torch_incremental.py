"""The incremental rescore (``incremental_rescore=True``, B15) on the CPU,
against the JAX reference.

* K16's and K17's plain twins, and the gated K1 / K6 on a row list, on a
  second step's carry of the port's own step loop: the stale sets, index
  lists and decision, the merged ``(dt, bd)`` of the patch's part (a) and
  the whole patch's ``(dt, bd, ls)`` must equal those the reference's
  ``patch_rescore`` lines (``tpu_optimizer.py:1079-1150``, transcribed
  below on the reference's own functions) compute from the same arrays —
  exactly, bits included.
* One scan call step by step against ``_cached_scan_fn(...,
  incremental_rescore=True)``: actions, step counts, done and
  ``n_overflow``, at the default budgets (where it departs from the
  default path) and at a budget mix where some steps patch and some
  overflow; a second call started from the first call's tables (the carry
  resets); chunks of 1, 3 and 16 masked steps.
* A whole plan at the bar of tests/test_torch_search_paths.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu.ops import grid as ref_grid
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer import rescore_kernels as RK
from cruise_control_tpu_torch.analyzer import score_kernel as K6
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.models import generators as gen
from cruise_control_tpu_torch.ops import grid as G
from test_torch_commit_kernel import to_ref_model
from test_torch_search_paths import plan
from test_torch_step_kernels import carried

#: the scan fixture: 20 brokers, 300 partitions, one call of 48 steps with
#: no repool inside it (so only the budgets and the refresh force a full
#: rescore) and 4 commits a step
SCAN = dict(seed=3, num_brokers=20, num_racks=5, num_partitions=300,
            mean_utilization=0.4)
SCAN_CFG = dict(steps_per_call=48, repool_steps=48, device_batch_per_step=4,
                incremental_rescore=True)
#: budgets under which some steps patch and others overflow (25 of 48 on
#: this fixture, measured on the reference)
MIX = dict(rescore_lead_budget=450)


def j(x):
    return jnp.asarray(x.numpy())


# ---- the reference's patch, transcribed (tpu_optimizer.py:1079-1150) -----

def ref_patch(m, cfg, ca, kp, ks, dest_pool, lp, lsl, tb, tpm, dt_l, bd_l,
              ls_l):
    """The stale sets, lists and patched carry the reference's step
    computes from these arrays (mesh-free branch, Kl = K, Ll = L)."""
    K, L, D = kp.shape[0], lp.shape[0], dest_pool.shape[0]
    R = dt_l.shape[1]
    RB = min(K, cfg.rescore_rows_budget)
    CB = min(D, cfg.rescore_cols_budget)
    LB = min(L, cfg.rescore_lead_budget)
    terms = ref_grid.move_grid_terms(m, cfg, ca, kp, ks)
    src_term_l = terms["src_term"]
    row_stale = tpm[kp]
    col_stale = (dest_pool >= 0) & tb[jnp.clip(dest_pool, 0)]
    lb_l = jnp.clip(jnp.take_along_axis(
        m.assignment[lp], m.leader_slot[lp][:, None], axis=1)[:, 0], 0)
    slb_l = jnp.clip(m.assignment[lp, lsl], 0)
    l_stale = tpm[lp] | tb[lb_l] | tb[slb_l]
    out = {"counts": [int(jnp.sum(x)) for x in (row_stale, col_stale,
                                                l_stale)],
           "overflow": bool((jnp.sum(row_stale) > RB)
                            | (jnp.sum(col_stale) > CB)
                            | (jnp.sum(l_stale) > LB))}
    # (a)
    corder = jnp.argsort(~col_stale)
    cidx = corder[:CB]
    dp_c = jnp.where(col_stale[cidx], dest_pool[cidx], -1)
    g_c = ref_grid.move_grid_scores(m, cfg, ca, kp, ks, dp_c, terms=terms)
    dt_c = g_c - src_term_l[:, None]
    stored_bid = dest_pool[jnp.clip(bd_l, 0)]
    stored = jnp.where(tb[jnp.clip(stored_bid, 0)], jnp.inf, dt_l)
    merged_s = jnp.concatenate([stored, dt_c], axis=1)
    cidx_m = jnp.where(col_stale[cidx], cidx.astype(jnp.int32), -1)
    merged_d = jnp.concatenate(
        [bd_l, jnp.broadcast_to(cidx_m[None, :], (K, CB))], axis=1)
    negm, mi = jax.lax.top_k(-merged_s, R)
    new_dt = -negm
    new_bd = jnp.take_along_axis(merged_d, mi, axis=1)
    out.update(cidx=cidx_m, dt_a=new_dt, bd_a=new_bd)
    # (b)
    rorder = jnp.argsort(~row_stale)
    ridx = rorder[:RB]
    rok = row_stale[ridx]
    g_r = ref_grid.move_grid_scores(m, cfg, ca, kp[ridx], ks[ridx],
                                    dest_pool)
    negr, bir = T._grid_top_r(cfg, -g_r, R)
    dt_r = -negr - src_term_l[ridx][:, None]
    new_dt = new_dt.at[ridx].set(
        jnp.where(rok[:, None], dt_r, new_dt[ridx]))
    new_bd = new_bd.at[ridx].set(jnp.where(rok[:, None], bir, new_bd[ridx]))
    # (c)
    lorder = jnp.argsort(~l_stale)
    lidx = lorder[:LB]
    lok = l_stale[lidx]
    ls_f, _ = T._score_candidates(m, cfg, ca, jnp.ones(LB, jnp.int32),
                                  lp[lidx], lsl[lidx],
                                  jnp.zeros(LB, jnp.int32))
    new_ls = ls_l.at[lidx].set(jnp.where(lok, ls_f, ls_l[lidx]))
    out.update(ridx=ridx, lidx=lidx, dt=new_dt, bd=new_bd, ls=new_ls)
    return out


def second_step(cload):
    """What the port's second step hands K16 and K17 (copies, taken when
    each is called) on the seeded 16-broker fixture with a dead broker, and
    the reference model and constraints on the same placement."""
    (_, ca_r, _, _), (pm, ca, _) = carried(4, cload)
    cfg = C._resolve_batch(C.CudaSearchConfig(incremental_rescore=True),
                           pm.capacity.shape[0])
    K, D = C.CudaGoalOptimizer(device="cpu")._pool_sizes(
        *pm.assignment.shape, pm.capacity.shape[0])
    seen = {"stale_sets": [], "grid_patch": []}
    real = {n: getattr(C, n) for n in seen}

    def shim(n):
        def f(*a, **k):
            seen[n].append(copy.deepcopy((a, k)))
            return real[n](*a, **k)
        return f

    for n in seen:
        setattr(C, n, shim(n))
    try:
        C._scan_call(pm, cfg, ca, C.grid_consts(cfg, ca, "cpu"), K, D, 2,
                     C._cold_tables(pm))
    finally:
        for n, f in real.items():
            setattr(C, n, f)
    return cfg, ca_r, seen["stale_sets"][1], seen["grid_patch"][1]


REF_CFG = T.TpuSearchConfig(incremental_rescore=True)


@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_stale_sets_match_reference(cload):
    """K16's twin on a second step: the counts, lists and decision."""
    _, ca_r, (args, kw), _ = second_step(cload)
    m, kp, dp, lp, lsl, tb, tpm, state, ridx, cidx, lidx, nstale, _ = args
    assert int(state[SS.REPOOL]) == 0 and int(state[SS.ACTIVE]) == 1
    before = RK.stale_sets.launches
    RK.stale_sets(*args, **kw)          # CPU tensors: the plain twin
    assert RK.stale_sets.launches == before
    K, L = kp.shape[0], lp.shape[0]
    ref = ref_patch(to_ref_model(m), REF_CFG, ca_r, j(kp),
                    jnp.zeros(K, jnp.int32), j(dp), j(lp), j(lsl), j(tb),
                    j(tpm), jnp.full((K, 1), jnp.inf),
                    jnp.full((K, 1), -1, jnp.int32), jnp.full(L, jnp.inf))
    assert nstale.tolist() == ref["counts"]
    assert all(c > 0 for c in ref["counts"]), ref["counts"]
    # a patch step: nothing over its budget, no repool, no refresh due
    assert not ref["overflow"] and int(state[SS.FRESH]) == 0
    assert (int(state[SS.SINCE_FULL]), int(state[SS.N_OVF]),
            int(state[SS.N_PATCH])) == (1, 0, 1)
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(ref["ridx"]))
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(ref["cidx"]))
    np.testing.assert_array_equal(lidx.numpy(), np.asarray(ref["lidx"]))


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a))
    b = np.ascontiguousarray(np.asarray(b))
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_patch_matches_reference(cload):
    """K17's twin (part (a): the stale columns and the exact R + CB
    merge), then K1 on the stale rows (b) and K6 on the stale leadership
    entries (c), gated on the carry, on a second step: the carry equals
    the reference's patched (dt, bd) after (a) and (dt, bd, ls) after all
    three, bit for bit."""
    cfg, ca_r, (sargs, _), (args, kw) = second_step(cload)
    m, pcfg, ca, kp, ks, dp, packed, cidx, tb, dt, bd, state = args
    tpm, lp, lsl = sargs[6], sargs[3], sargs[4]
    ls = torch.full((lp.shape[0],), float("inf"))
    ref = ref_patch(to_ref_model(m), REF_CFG, ca_r, j(kp), j(ks), j(dp),
                    j(lp), j(lsl), j(tb), j(tpm), j(dt), j(bd), j(ls))
    assert (np.asarray(ref["bd_a"]) != bd.numpy()).any()   # the merge moved
    before = RK.grid_patch.launches
    RK.grid_patch(*args, **kw)
    assert RK.grid_patch.launches == before
    _bits_equal(dt.numpy(), ref["dt_a"])
    _bits_equal(bd.numpy(), ref["bd_a"])
    # (b) and (c) on the lists K16 wrote (the same as the reference's)
    ridx, lidx, nstale = sargs[8], sargs[10], sargs[11]
    RK.stale_sets(*sargs)
    G.grid_rescore_carry(m, pcfg, ca, kp, ks, dp, packed, dt.shape[1], dt, bd,
                         state, 0, rows=ridx, n_rows=nstale[0:1])
    L = lp.shape[0]
    K6.score_candidates(
        m, pcfg, ca, torch.full((L,), K6.KIND_LEADERSHIP, dtype=torch.int32),
        lp, lsl, torch.zeros(L, dtype=torch.int32), out=(
            ls, torch.zeros(L, dtype=torch.bool)), rows=lidx,
        n_rows=nstale[2:3], gate=state, want=0)
    _bits_equal(dt.numpy(), ref["dt"])
    _bits_equal(bd.numpy(), ref["bd"])
    _bits_equal(ls.numpy(), ref["ls"])
    # the gates: a step that rescores in full leaves the patch's carry be
    state[SS.FRESH] = 1
    dt0 = dt.clone()
    RK.grid_patch(*args[:9], dt, bd, state)
    G.grid_rescore_carry(m, pcfg, ca, kp, ks, dp, packed, dt.shape[1], dt, bd,
                         state, 0, rows=ridx, n_rows=nstale[0:1])
    assert torch.equal(dt, dt0)


def scan_call(kw, cfg_kw, T_=48, tables=None, m=None, loop=None, **call):
    """One port scan call on ``random_cluster(**kw)`` (EXPONENTIAL) →
    (result, model, tables, loop)."""
    state = gen.random_cluster(**kw, distribution=gen.Distribution
                               .EXPONENTIAL)
    opt = C.CudaGoalOptimizer(device="cpu")
    ctx = C.AnalyzerContext(state)
    m0 = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    cfg = C._resolve_batch(C.CudaSearchConfig(**cfg_kw), ctx.num_brokers)
    consts = C.grid_consts(cfg, ca, "cpu")
    m = m0 if m is None else m
    loop = loop or C._StepLoop(m, cfg, ca, consts, K, D, T_,
                               call.pop("chunk", C.STEP_CHUNK))
    res, m_out, tab = C._scan_call(
        m, cfg, ca, consts, K, D, T_,
        C._cold_tables(m) if tables is None else tables, loop, **call)
    return res, m_out, tab, loop


def ref_scan(kw, cfg_kw, T_=48, calls=1):
    """The reference's scan calls, each from the last one's model and
    tables → [(kind, p, s, d, counts, done, diag)]."""
    state = ref_gen.random_cluster(
        **kw, distribution=ref_gen.Distribution.EXPONENTIAL)
    ctx = RefContext(state)
    opt = T.TpuGoalOptimizer()
    can = opt._constraint_arrays_np(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    fn = T._cached_scan_fn(T.TpuSearchConfig(**cfg_kw), K, D, T_, None)
    m, ca = opt._device_model(ctx), {k: jnp.asarray(v)
                                     for k, v in can.items()}
    out, tab = [], None
    for _ in range(calls):
        packed, m, tab = fn(m, ca, np.int32(T_),
                            None if tab is None else tab + (np.True_,))
        out.append(T._fetch_scan_result(packed, T_))
    return out


def assert_same_call(res, ref):
    kind, p, s, d, counts, done, diag = ref
    n = res.step_counts.size
    assert n > 1 and res.step_counts.sum() > 0
    np.testing.assert_array_equal(res.step_counts, counts[:n])
    assert not counts[n:].any() and res.done == done
    assert res.diag["steps_run"] == diag["steps_run"]
    assert res.diag["n_overflow"] == diag["n_overflow"]
    for a, b in ((res.kind, kind), (res.p, p), (res.s, s), (res.d, d)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("budgets", [{}, MIX], ids=["default", "mix"])
def test_scan_call_matches_reference(budgets):
    """One incremental scan call commits the reference's actions step by
    step, with its overflow count: at the default budgets every step after
    the first patches (and the call departs from the default path's), at
    MIX some steps patch and some overflow."""
    cfg_kw = dict(SCAN_CFG, **budgets)
    res = scan_call(SCAN, cfg_kw)[0]
    assert_same_call(res, ref_scan(SCAN, cfg_kw)[0])
    steps, ovf = res.diag["steps_run"], res.diag["n_overflow"]
    if budgets:
        assert 0 < ovf < steps - 1 and res.diag["patch_steps"] > 0
    else:
        assert ovf == 0 and res.diag["patch_steps"] > 0
        plain = scan_call(SCAN, dict(SCAN_CFG, incremental_rescore=False))[0]
        assert plain.diag["patch_steps"] == 0
        assert not np.array_equal(
            np.stack([res.kind, res.p, res.s, res.d]),
            np.stack([plain.kind, plain.p, plain.s, plain.d]))


def test_second_call_starts_from_a_reset_carry():
    """A second call on the same loop, from the first call's model and
    tables, resets the incremental carry (its first step repools and
    rescores in full) and commits the reference's second call."""
    cfg_kw = dict(SCAN_CFG, steps_per_call=12, **MIX)
    res1, m1, tab1, loop = scan_call(SCAN, cfg_kw, T_=12)
    assert not res1.done and res1.diag["steps_run"] == 12
    # whatever the carry holds after a call, the next one starts afresh
    sc = loop.sc
    for x, v in ((sc.dt, -1e30), (sc.bd, 0), (sc.ls, -1e30), (sc.tb, True),
                 (sc.tpm, True), (sc.marks, 0)):
        x.fill_(v)
    loop.st.state[SS.N_OVF] = 99
    res2 = scan_call(SCAN, cfg_kw, T_=12, tables=tab1 + (True,), m=m1,
                     loop=loop)[0]
    ref1, ref2 = ref_scan(SCAN, cfg_kw, T_=12, calls=2)
    assert_same_call(res1, ref1)
    assert_same_call(res2, ref2)


def test_chunks_equal_the_per_step_loop():
    """Chunks of 1, 3 and 16 masked incremental steps give the same call:
    masked steps past the end move neither the overflow and patch counts
    nor the marks."""
    kw = dict(SCAN_CFG, steps_per_call=40, **MIX)
    runs = {n: scan_call(SCAN, kw, T_=40, chunk=n) for n in (1, 3, 16)}
    ref = runs[1][0]
    steps = ref.diag["steps_run"]
    # the chunks of 3 and 16 run masked steps past the end
    assert steps % 3 and steps % 16
    assert ref.diag["n_overflow"] > 0 and ref.diag["patch_steps"] > 0
    for n, (res, m_out, tab, loop) in runs.items():
        for f in ("kind", "p", "s", "d", "step_counts"):
            assert np.array_equal(getattr(res, f), getattr(ref, f)), (n, f)
        for f in ("steps_run", "repools", "n_overflow", "patch_steps"):
            assert res.diag[f] == ref.diag[f], (n, f)
        for f in dataclasses.fields(loop.sc):
            a, b = getattr(loop.sc, f.name), getattr(runs[1][3].sc, f.name)
            if f.name not in ("marks", "ridx", "cidx", "lidx", "nstale"):
                assert torch.equal(a, b), (n, f.name)


def test_default_loop_has_no_incremental_carry(monkeypatch):
    """The default path allocates no carry for the incremental rescore and
    never reaches K16 or K17."""
    def boom(*a, **k):
        raise AssertionError("the default path ran the incremental rescore")

    monkeypatch.setattr(C, "stale_sets", boom)
    monkeypatch.setattr(C, "grid_patch", boom)
    res, _, _, loop = scan_call(SCAN, dict(SCAN_CFG,
                                           incremental_rescore=False))
    assert loop.sc is None and res.diag["patch_steps"] == 0


def test_incremental_plan_holds_the_bar():
    """A whole plan at ``incremental_rescore=True``: verified, no worse
    than greedy, within max(2, 5 %) of the reference's plan, with steps
    that patched."""
    res, _ = plan(dict(seed=42, num_brokers=50, num_racks=10,
                       num_partitions=1000), dict(incremental_rescore=True))
    summ = res.goal_summaries[0]
    assert summ["patch_steps"] > 0 and summ["steps"] > summ["patch_steps"]

"""The incremental rescore's two twins on their hard cases, against the JAX
reference's patch lines (``tpu_optimizer.py:1079-1127``, with the
decision :1087-1095 and :1157).

K16's twin ``stale_sets_plain`` (counts, the three index lists, the
decision and the carry) and K17's ``grid_patch_plain`` (part (a): the
stale columns' grid and the exact R + CB merge into the stored top-R)
take a port second step's arrays, made hard — nothing stale, every list
at its budget and one over it, every row stale with RB = K on the 50 /
1 000 fixture, a repool and a refresh due, every column stale, every
stored entry touched, ±0.0 and tied stored values, every cell infeasible,
replication factors 1 and 8 — and must equal, bits included, what
``test_torch_incremental.ref_patch`` (the reference's lines transcribed
on its own functions) computes from the same arrays.  K17's ``cidx`` is
always the list K16's twin wrote, the form the kernel takes (stale
columns first, then -1).  The kernels themselves are held to these twins
on the card by ``chip_smoke.py`` (``rescore_cases``)."""

import copy
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer import rescore_kernels as RK
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.models import generators as gen
from cruise_control_tpu_torch.ops import grid as G
from test_torch_commit_kernel import to_ref_model
from test_torch_incremental import _bits_equal, j, ref_patch, second_step

#: the 50-broker / 1 000-partition fixture; and the replication-factor
#: fixtures (8 racks so 8 replicas place), 4 commits a step so the second
#: step patches
SMALL = dict(seed=42, num_brokers=50, num_racks=10, num_partitions=1000)
RF = dict(seed=9, num_brokers=24, num_racks=8, num_partitions=160)


def second_step_at(kw, cfg_kw):
    """What the port's second step hands K16 and K17 (copies) on
    ``random_cluster(**kw)`` at ``cfg_kw``, and the reference's
    constraints on the same placement → (ca_r, (K16 args, kw), (K17 args,
    kw))."""
    state = gen.random_cluster(**kw)
    opt = C.CudaGoalOptimizer(device="cpu")
    ctx = C.AnalyzerContext(state)
    m, ca = opt._device_model(ctx), opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    cfg = C._resolve_batch(C.CudaSearchConfig(incremental_rescore=True,
                                              **cfg_kw), ctx.num_brokers)
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
        C._scan_call(m, cfg, ca, C.grid_consts(cfg, ca, "cpu"), K, D, 2,
                     C._cold_tables(m))
    finally:
        for n, f in real.items():
            setattr(C, n, f)
    ref_opt = T.TpuGoalOptimizer()
    ca_r = {k: jnp.asarray(v) for k, v in ref_opt._constraint_arrays_np(
        RefContext(ref_gen.random_cluster(**kw))).items()}
    return ca_r, seen["stale_sets"][1], seen["grid_patch"][1]


@functools.lru_cache(maxsize=None)
def _step(fixture):
    if fixture == "base":
        _, ca_r, s16, s17 = second_step(False)
        return ca_r, s16, s17
    if fixture == "50b_1k":
        return second_step_at(SMALL, {})
    rf = int(fixture[2:])
    return second_step_at(dict(RF, replication_factor=rf),
                          {"device_batch_per_step": 4})


def step(fixture="base"):
    """A fresh copy of a fixture's second step → (ca_r, K16 args as a list,
    K16 kw, K17 args as a list)."""
    ca_r, (a16, kw16), (a17, _) = _step(fixture)
    a16, a17 = copy.deepcopy(a16), copy.deepcopy(a17)
    return ca_r, list(a16), kw16, list(a17)


def budgets(a16, RB, CB, LB):
    """K16's arguments with lists of RB / CB / LB entries (its budgets)."""
    i32 = functools.partial(torch.empty, dtype=torch.int32)
    a16[8], a16[9], a16[10] = i32(RB), i32(CB), i32(LB)
    return a16


def ref_cfg(a16):
    """The reference's config at K16's budgets and refresh."""
    return T.TpuSearchConfig(
        incremental_rescore=True, rescore_rows_budget=a16[8].shape[0],
        rescore_cols_budget=a16[9].shape[0],
        rescore_lead_budget=a16[10].shape[0],
        rescore_refresh_steps=a16[12])


def ref_decision(overflow, need_pool, since_full, n_ovf, refresh):
    """The reference's decision and its carry (:1087-1095, :1157)."""
    refresh_due = (refresh > 0) and (since_full >= refresh)
    fresh = need_pool | overflow | refresh_due
    n_ovf = n_ovf + jnp.where(overflow & ~need_pool, 1, 0)
    since_full = jnp.where(fresh, 0, since_full + 1)
    return bool(fresh), int(n_ovf), int(since_full)


def run_k16(ca_r, a16, kw16, ks=None, dt=None, bd=None):
    """K16's twin on ``a16`` against the reference: counts, lists,
    decision and carry → the reference's output (its patch (a) from the
    slots ``ks`` and the carried ``dt`` / ``bd``, where given)."""
    m, kp, dp, lp, lsl, tb, tpm, state = a16[:8]
    st0 = state.clone()
    RK.stale_sets(*a16, **kw16)            # CPU tensors: the plain twin
    K, L = kp.shape[0], lp.shape[0]
    R = 1 if dt is None else dt.shape[1]
    ref = ref_patch(
        to_ref_model(m), ref_cfg(a16), ca_r, j(kp),
        jnp.zeros(K, jnp.int32) if ks is None else j(ks), j(dp), j(lp),
        j(lsl), j(tb), j(tpm),
        jnp.full((K, R), jnp.inf) if dt is None else j(dt),
        jnp.full((K, R), -1, jnp.int32) if bd is None else j(bd),
        jnp.full(L, jnp.inf))
    assert a16[11].tolist() == ref["counts"]
    for got, want in ((a16[8], ref["ridx"]), (a16[9], ref["cidx"]),
                      (a16[10], ref["lidx"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fresh, n_ovf, since = ref_decision(
        jnp.asarray(ref["overflow"]), jnp.asarray(bool(st0[SS.REPOOL])),
        int(st0[SS.SINCE_FULL]), int(st0[SS.N_OVF]), a16[12])
    assert (int(state[SS.FRESH]), int(state[SS.N_OVF]),
            int(state[SS.SINCE_FULL]), int(state[SS.N_PATCH])) == (
        int(fresh), n_ovf, since, int(st0[SS.N_PATCH]) + (not fresh))
    return ref


def run_k17(ca_r, a16, kw16, a17, model=None):
    """K16's twin on ``a16`` (its marks also K17's), then K17's twin on the
    list and count it wrote, on a patching carry, both against the
    reference, bit for bit → the reference's output."""
    a17[9] = a16[5].clone()
    if model is not None:
        a17[0] = a16[0] = model
    m, cfg, ca, kp, ks, dp, packed, cidx, n_cols, tb, dt, bd, state = a17
    ref = run_k16(ca_r, a16, kw16, ks, dt.clone(), bd.clone())
    a17[7], a17[8] = a16[9], a16[11][1:2]
    state[SS.ACTIVE], state[SS.FRESH] = 1, 0
    n = int(a16[11][1])
    assert (a17[7][:n] >= 0).all() and (a17[7][n:] == -1).all()
    RK.grid_patch(*a17)
    _bits_equal(dt.numpy(), ref["dt_a"])
    _bits_equal(bd.numpy(), ref["bd_a"])
    return ref


def test_nothing_stale():
    """No marks: every count 0, the lists in index order, a patch step
    whose merge keeps the stored entries (n = 0: every column -1)."""
    ca_r, a16, kw16, a17 = step()
    a16[5].zero_()
    a16[6].zero_()
    ref = run_k17(ca_r, a16, kw16, a17)
    assert ref["counts"] == [0, 0, 0] and not ref["overflow"]
    assert (a16[9] == -1).all()


@pytest.mark.parametrize("over", [0, 1], ids=["at_budget", "over_budget"])
def test_lists_at_and_over_their_budgets(over):
    """Each list's budget equal to its stale count (a patch), then one
    below it (an overflow: FRESH, N_OVF, the lists still written)."""
    ca_r, a16, kw16, a17 = step()
    counts = [int(x.sum()) for x in RK._stale_masks(*a16[:7])]
    assert all(c > 1 for c in counts), counts
    a16 = budgets(a16, *(c - over for c in counts))
    if over:
        ref = run_k16(ca_r, a16, kw16)
        assert ref["overflow"] and int(a16[7][SS.FRESH]) == 1
    else:
        ref = run_k17(ca_r, a16, kw16, a17)
        assert not ref["overflow"] and int(a16[7][SS.FRESH]) == 0


def test_every_row_stale_with_rb_equal_to_k():
    """50 / 1 000: every pool row's partition marked, RB = K (the whole
    row list is stale, in order); the columns' patch as the step marked
    them."""
    ca_r, a16, kw16, a17 = step("50b_1k")
    K = a16[1].shape[0]
    a16[6].fill_(True)
    a16 = budgets(a16, K, a16[9].shape[0], a16[3].shape[0])
    ref = run_k17(ca_r, a16, kw16, a17)
    assert ref["counts"][0] == K
    np.testing.assert_array_equal(a16[8].numpy(), np.arange(K))


@pytest.mark.parametrize("carry", ["repool", "refresh_due"])
def test_decision_on_a_repool_and_a_refresh(carry):
    """A step that repools, and one whose refresh is due, rescore in
    full; the lists are written all the same."""
    ca_r, a16, kw16, _ = step()
    state = a16[7]
    if carry == "repool":
        state[SS.REPOOL] = 1
    else:
        state[SS.SINCE_FULL] = a16[12]
    run_k16(ca_r, a16, kw16)
    assert int(state[SS.FRESH]) == 1 and int(state[SS.SINCE_FULL]) == 0


@pytest.mark.parametrize("marks", ["all_columns", "stored_brokers"])
def test_every_column_or_every_stored_entry_stale(marks):
    """Every pool broker marked (n = CB = D here), or only the stored
    entries' brokers (every stored entry +inf before the merge)."""
    ca_r, a16, kw16, a17 = step()
    dp, tb, bd = a16[2], a16[5], a17[11]
    tb.zero_()
    if marks == "all_columns":
        tb[dp[dp >= 0].long()] = True
    else:
        tb[dp[bd.clamp_min(0).long()].clamp_min(0).long()] = True
    ref = run_k17(ca_r, a16, kw16, a17)
    if marks == "all_columns":
        assert ref["counts"][1] == a16[9].shape[0] == dp.shape[0]
    else:
        assert ref["counts"][1] < dp.shape[0]
        assert bool(tb[dp[bd.clamp_min(0).long()].clamp_min(0).long()].all())


def test_signed_zeros_and_ties_in_the_merge():
    """Two pool brokers marked (two stale columns), stored values of -0.0
    and +0.0, stored values tied with the two columns' fresh values and
    with each other: the merge keeps the floats' total order and the
    lower position."""
    ca_r, a16, kw16, a17 = step()
    dp, tb = a16[2], a16[5]
    tb.zero_()
    tb[dp[dp >= 0][:2].long()] = True
    s16 = copy.deepcopy(a16)
    RK.stale_sets(*s16, **kw16)
    m, cfg, ca, kp, ks, _, packed = a17[:7]
    cidx = s16[9]
    dp_c = torch.where(cidx >= 0, dp[cidx.clamp_min(0).long()], -1)
    dt_c = (G.move_grid_scores(m, cfg, ca, kp, ks, dp_c.to(torch.int32),
                               terms=packed.get("terms"))
            - packed["src_f"][:, G.SRC_TERM_COL][:, None])
    dt = a17[10]
    dt[:, 0], dt[:, 1], dt[:, 2], dt[:, 3] = -0.0, 0.0, 0.0, -0.0
    dt[:, 4], dt[:, 5] = dt_c[:, 0], dt_c[:, 1]
    dt[:, 6] = dt[:, 7]
    run_k17(ca_r, a16, kw16, a17)
    neg, zero = torch.signbit(dt), dt == 0
    assert (zero & neg).any() and (zero & ~neg).any()


def test_every_cell_infeasible():
    """No destination accepts a replica: every stale column's cell is
    +inf, the stored entries that are not touched stay."""
    ca_r, a16, kw16, a17 = step()
    m = dataclasses.replace(a17[0], dest_ok=torch.zeros_like(a17[0].dest_ok))
    m17, cfg, ca, kp, ks, dp, packed = a17[:7]
    a17[6] = C.grid_terms(m, cfg, ca, kp, ks, dp)
    ref = run_k17(ca_r, a16, kw16, a17, model=m)
    assert ref["counts"][1] > 0


@pytest.mark.parametrize("rf", [1, 8])
def test_replication_factors(rf):
    """The second step of a cluster at replication factor 1 and 8."""
    ca_r, a16, kw16, a17 = step(f"rf{rf}")
    assert a17[0].assignment.shape[1] == rf
    ref = run_k17(ca_r, a16, kw16, a17)
    assert ref["counts"][1] > 0

"""K8's wrapper (the step's commit, B6 + B9) and K9's (the aggregate
rebuild, B9) on the CPU, against the JAX reference.

K8's inputs are recorded from the first step of the port's own step loop
(so the cohort and the auction have picked real commits); the reference
side is :func:`ref_commit`, a jnp transcript of the step's commit
(``cruise_control_tpu/analyzer/tpu_optimizer.py:1335-1391``: the merge,
the commit-order ``sort_key_val`` :1342, ``take_f``, the
``dynamic_update_slice`` output, ``tpp``) around the reference's own
``_apply_batch_on_device`` (:751).  On CPU tensors the wrappers run their
plain twins, the versions the card's kernels are held to in
``chip_smoke.py``.  Placement, output rows, touched marks and counts match
exactly; float aggregates within rtol 1e-6 / atol 1e-5 (the port's sums
are exact fixed point, the reference's f32 in XLA's order)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import commit_kernels as K89
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.models.generators import random_cluster
from test_torch_step_kernels import carried

RTOL, ATOL = 1e-6, 1e-5
AGGREGATES = ("broker_load", "leader_nwin", "pot_nwout", "rcount", "lcount",
              "broker_cload")


def ref_commit(m, acc_b, take_d, win_score_d, win_dst_d, cand_score, d0,
               is_move_row, cand_p, cand_s, cand_src, M_, out, count, tpp):
    """jnp transcript of tpu_optimizer.py:1335-1391 (the commit)."""
    Cn = acc_b.shape[0]
    P = m.assignment.shape[0]
    ci = jnp.arange(Cn, dtype=jnp.int32)
    take = acc_b | take_d
    win_score = jnp.where(acc_b, cand_score[:, 0], win_score_d)
    win_dst = jnp.where(acc_b, d0, win_dst_d)
    vals_all, order_all = jax.lax.sort_key_val(
        jnp.where(take, win_score, jnp.inf), ci)
    order = order_all[:M_]
    sel_ok = jnp.isfinite(vals_all[:M_])
    take_f = jnp.zeros(Cn, bool).at[order].max(sel_ok)
    c_step = jnp.sum(sel_ok.astype(jnp.int32))
    m = T._apply_batch_on_device(m, take_f, is_move_row, cand_p, cand_s,
                                 win_dst, cand_src, win_dst)
    batch = jnp.stack([
        jnp.where(is_move_row[order], T.KIND_MOVE, T.KIND_LEADERSHIP)
        .astype(jnp.float32),
        cand_p[order].astype(jnp.float32),
        cand_s[order].astype(jnp.float32),
        win_dst[order].astype(jnp.float32),
    ])
    out = jax.lax.dynamic_update_slice(out, batch, (0, count))
    tpm = jnp.zeros(P, bool).at[jnp.clip(cand_p, 0)].max(take_f)
    return m, tpp | tpm, c_step, out


def with_percentile(state, seed=3):
    g = torch.Generator().manual_seed(seed)
    P, R = state.leader_load.shape
    f = lambda x: (x[:, None, :] * (0.7 + 0.8 * torch.rand(  # noqa: E731
        (P, 6, R), generator=g))).to(torch.float32)
    return dataclasses.replace(
        state, leader_load_windows=f(state.leader_load),
        follower_load_windows=f(state.follower_load),
        capacity_percentile=90.0)


def first_commit(cload: bool):
    """The arguments of the first step's commit, recorded from the port's
    step loop on a seeded cluster with a dead broker."""
    state = random_cluster(seed=11, num_brokers=24, num_racks=6,
                           num_partitions=400, dead_brokers=1)
    if cload:
        state = with_percentile(state)
    opt = C.CudaGoalOptimizer(device="cpu")
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    cfg = C._resolve_batch(opt.config, ctx.num_brokers)
    saved, calls = C.commit_batch, []

    def shim(*a, **k):
        calls.append(copy.deepcopy(a))
        return saved(*a, **k)

    C.commit_batch = shim
    try:
        C._scan_call(m, cfg, ca, C.grid_consts(cfg, ca, "cpu"), K, D, 1,
                     C._cold_tables(m))
    finally:
        C.commit_batch = saved
    return calls[0]


def to_ref_model(pm):
    """The reference's DeviceModel holding the port model's values."""
    def conv(x):
        if x is None:
            return None
        x = x.numpy()
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
    return T.DeviceModel(**{f.name: conv(getattr(pm, f.name))
                            for f in dataclasses.fields(T.DeviceModel)})


@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_commit_batch_matches_reference(cload):
    args = first_commit(cload)
    pm = args[0]
    assert (pm.broker_cload is not None) == cload
    before = K89.commit_batch.launches
    m1, tpp1, c1 = K89.commit_batch(*copy.deepcopy(args))
    assert K89.commit_batch.launches == before      # CPU tensors: plain twin
    plain = copy.deepcopy(args)
    m2, tpp2, c2 = K89.commit_batch_plain(*plain)
    assert torch.equal(tpp1, tpp2) and torch.equal(c1, c2)
    for f in dataclasses.fields(m1):
        a, b = getattr(m1, f.name), getattr(m2, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name

    conv = lambda x: jnp.asarray(  # noqa: E731
        x.numpy().astype(np.int32) if x.dtype == torch.int64 else x.numpy())
    rest = [conv(x) for x in args[1:11]]
    M_, out, tpp, st = args[11], args[12], args[13], args[15]
    count = int(st.state[SS.COUNT])
    rm, rtpp, rc, rout = ref_commit(to_ref_model(pm), *rest, M_,
                                    conv(out), count, conv(tpp))
    assert int(rc) == int(c1[0]) > 1              # real commits
    # the loop's carry advanced past the step's commits
    after = plain[15]
    assert int(after.state[SS.COUNT]) == count + int(rc)
    assert int(after.state[SS.STEP]) == int(st.state[SS.STEP]) + 1
    assert int(after.counts[0, int(st.state[SS.STEP])]) == int(rc)
    assert np.array_equal(tpp1.numpy(), np.asarray(rtpp))
    assert np.array_equal(plain[12].numpy(), np.asarray(rout))
    for f in ("assignment", "leader_slot", "must_move"):
        assert np.array_equal(getattr(m1, f).numpy(),
                              np.asarray(getattr(rm, f))), f
    moved = not np.array_equal(m1.assignment.numpy(),
                               pm.assignment.numpy())
    assert moved
    for f in AGGREGATES:
        a, b = getattr(m1, f), getattr(rm, f)
        if a is None:
            assert b is None and not cload
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f)


def test_recompute_aggregates_with_capacity_loads_match_reference():
    """K9's wrapper (plain twin on the CPU) against the reference rebuild,
    with percentile capacity loads and a dead broker."""
    (m, _, _, _), (pm, _, _) = carried(6, True)
    ref = T._recompute_aggregates(m)
    before = K89.recompute_aggregates.launches
    got = K89.recompute_aggregates(pm)
    assert K89.recompute_aggregates.launches == before
    plain = K89._recompute_aggregates(pm)
    for f in AGGREGATES:
        a = getattr(got, f)
        assert torch.equal(a, getattr(plain, f)), f
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(ref, f)),
                                   rtol=RTOL, err_msg=f)

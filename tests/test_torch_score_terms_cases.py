"""K2's and K6's plain twins against the JAX reference on the cases the
card holds the kernels to (``chip_smoke.py: score_terms_cases``,
``slot_cases``): replication factors 1 and 8, chosen slots emptied,
excluded partitions with and without a slot to move, a destination pool
padded with -1, brokers with a resource at zero capacity, the broker
tables tiled over three times the brokers, moves and transfers mixed —
with the mean loads' partition table (W = 9) and with capacity loads
(W = 17).

On CPU tensors the wrappers run their twins, so ``grid_terms`` is held
to the reference's ``move_grid_terms`` (``cruise_control_tpu/ops/
grid.py:54``) and its destination columns, ``score_candidates`` to the
reference's ``_score_candidates`` (``tpu_optimizer.py:513``), and the
brokers' cost table K2 writes for K6 (``ops/grid.py:
broker_costs_plain``) broker by broker to the reference's ``broker_cost``
(``cruise_control_tpu/ops/cost.py:69``).  The inputs come from one seeded
numpy state handed to both.  Integers and masks match exactly; floats
within the tolerances of tests/test_torch_ops.py (rtol 1e-5, atol 1e-4:
f32 sums in another order, on scores carrying 1e6 / 1e4 bonuses)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.ops import cost as ref_cost
from cruise_control_tpu.ops import grid as ref_grid
from cruise_control_tpu_torch.analyzer import score_kernel as K6
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.models.convert import device_model_from_numpy
from cruise_control_tpu_torch.ops import grid as G
from test_torch_step_kernels import CFG

RTOL, ATOL = 1e-5, 1e-4
R = NUM_RESOURCES
#: the broker tables' fields (tiled in the ``tiled`` case)
BROKER_FIELDS = ("capacity", "rack", "dest_ok", "lead_ok", "alive",
                 "broker_load", "broker_cload", "leader_nwin", "pot_nwout",
                 "rcount", "lcount")


@functools.lru_cache(maxsize=None)
def world(seed: int, rf: int, cload: bool):
    """One seeded placement with a dead broker as numpy fields, its
    constraints and pools (both sides') and the reference optimizer;
    ``cload`` adds the same seeded percentile capacity loads."""
    state = ref_random(seed=seed, num_brokers=16, num_racks=4,
                       num_partitions=240, replication_factor=rf,
                       dead_brokers=1)
    ctx = RefContext(state)
    opt = T.TpuGoalOptimizer()
    m = opt._device_model(ctx)
    if cload:
        rng = np.random.default_rng(seed)
        scale = lambda x: (np.asarray(x) * rng.uniform(  # noqa: E731
            1.0, 1.4, np.shape(x))).astype(np.float32)
        lc, fc = scale(m.leader_load), scale(m.follower_load)
        m = dataclasses.replace(
            m, leader_cload=jnp.asarray(lc), follower_cload=jnp.asarray(fc),
            broker_cload=jnp.asarray(scale(m.broker_load)),
            pload=ref_cost.pack_pload(m.leader_load, m.follower_load,
                                      m.excluded, jnp.asarray(lc),
                                      jnp.asarray(fc)))
    can = opt._constraint_arrays_np(ctx)
    ca_r = {k: jnp.asarray(v) for k, v in can.items()}
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    pools = tuple(np.asarray(x)
                  for x in T._build_pools(m, opt.config, ca_r, K, D))
    fields = {f.name: (None if getattr(m, f.name) is None
                       else np.asarray(getattr(m, f.name)))
              for f in dataclasses.fields(m)}
    return fields, can, pools, opt


def hard(case: str, fields, pools, seed: int = 41):
    """The fields and pools of ``case`` (a '+'-joined list of edits) →
    (fields, pools, moves-to-destinations or None)."""
    f = {k: (None if v is None else v.copy()) for k, v in fields.items()}
    kp, ks, dp, lp, lsl = (x.copy() for x in pools)
    rng = np.random.default_rng(seed)
    B = f["capacity"].shape[0]
    mixed = None
    for edit in case.split("+"):
        if edit == "empty_slot":
            f["assignment"][kp[::4], ks[::4]] = -1
            f["assignment"][lp[1::4], lsl[1::4]] = -1
        elif edit == "excluded":
            f["pload"][np.concatenate([kp[::3], lp[::3]]), 2 * R] = 1.0
            f["must_move"][kp[::6], ks[::6]] = True
            f["must_move"][lp[::6], lsl[::6]] = True
        elif edit == "pool_pad":
            dp[-4:] = -1
        elif edit == "zero_cap":
            b = np.arange(0, B, 7)
            f["capacity"][b, b % R] = 0.0
        elif edit == "tiled":
            tile = 3
            for name in BROKER_FIELDS:
                if f[name] is not None:
                    f[name] = np.concatenate([f[name]] * tile)
            a = f["assignment"]
            f["assignment"] = np.where(
                a >= 0, a + B * rng.integers(0, tile, a.shape), a
            ).astype(np.int32)
            dp = np.where(dp >= 0, dp + B * rng.integers(0, tile, dp.shape),
                          dp).astype(np.int32)
        elif edit == "mixed":
            cd = dp[rng.integers(0, dp.shape[0], kp.shape[0])]
            mixed = np.where(rng.random(kp.shape[0]) < 0.125, -1,
                             cd).astype(np.int32)
        else:
            assert edit == "base", edit
    return f, (kp, ks, dp, lp, lsl), mixed


def both(fields, can):
    """(reference model, constraints), (port model, constraints)."""
    m = T.DeviceModel(**{k: None if v is None else jnp.asarray(v)
                         for k, v in fields.items()})
    pm = device_model_from_numpy(fields, device="cpu")
    return ((m, {k: jnp.asarray(v) for k, v in can.items()}),
            (pm, {k: torch.as_tensor(v) for k, v in can.items()}))


def close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), what
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL,
                               err_msg=what)


# ---- K2: the packed source and destination tables ---------------------------

@pytest.mark.parametrize("rf,cload,case", [
    (1, False, "base"), (8, True, "base"), (3, False, "empty_slot"),
    (3, True, "excluded"), (3, False, "pool_pad+zero_cap"),
    (3, True, "tiled"),
], ids=["rf1", "rf8-percentile", "empty_slot", "excluded-percentile",
        "pool_pad-zero_cap", "tiled-percentile"])
def test_grid_terms_twin_matches_reference(rf, cload, case):
    """K2's twin on the case: every packed source column against the
    reference's ``move_grid_terms``, every destination column against the
    reference's broker tables and cost."""
    fields, can, pools, opt = world(6, rf, cload)
    fields, (kp, ks, dp, _, _), _ = hard(case, fields, pools)
    (m, ca_r), (pm, ca) = both(fields, can)
    t_ref = {k: np.asarray(v) for k, v in ref_grid.move_grid_terms(
        m, opt.config, ca_r, jnp.asarray(kp), jnp.asarray(ks)).items()}
    before = G.grid_terms.launches
    pk = G.grid_terms(pm, CFG, ca, *(torch.as_tensor(x) for x in (kp, ks,
                                                                  dp)))
    assert G.grid_terms.launches == before       # CPU tensors: plain twin
    S = pm.assignment.shape[1]
    assert S == rf
    src_f, src_i, dst_f, dst_i = (pk[k].numpy() for k in
                                  ("src_f", "src_i", "dst_f", "dst_i"))
    assert src_f.shape == (kp.shape[0], G._SF)
    assert src_i.shape == (kp.shape[0], 3 * S + 2)
    for cols, key in ((slice(0, R), "move_load"), (slice(R, 2 * R),
                      "cmove_load"), (2 * R, "l_delta"),
                      (2 * R + 1, "lnwin_delta"), (2 * R + 2, "pot_delta"),
                      (G.SRC_TERM_COL, "src_term")):
        close(src_f[:, cols], t_ref[key], key)
    for cols, key in ((slice(0, S), "row"), (slice(S, 2 * S), "origin_row"),
                      (slice(2 * S, 3 * S), "other_racks"), (3 * S, "src")):
        assert np.array_equal(src_i[:, cols], t_ref[key]), key
    flags = src_i[:, 3 * S + 1]
    assert np.array_equal(flags & 1, t_ref["leader_now"])
    assert np.array_equal(flags >> 1 & 1,
                          t_ref["slot_exists"] & ~t_ref["excluded"])
    # the destination columns
    d_c = np.maximum(dp, 0)
    cap = fields["capacity"][d_c]
    load = fields["broker_load"][d_c]
    rc1 = fields["rcount"][d_c] + np.float32(1.0)
    static_ok = (dp >= 0) & fields["dest_ok"][d_c] & (
        rc1 <= np.asarray(can["max_replicas"]))
    assert np.array_equal(dst_i[:, 0], d_c)
    assert np.array_equal(dst_i[:, 1], fields["rack"][d_c])
    assert np.array_equal(dst_i[:, 2] & 1, static_ok)
    assert np.array_equal(dst_i[:, 2] >> 1 & 1, fields["lead_ok"][d_c])
    np.testing.assert_array_equal(dst_f[:, :R], np.maximum(cap, 1e-9))
    np.testing.assert_array_equal(dst_f[:, 2 * R:3 * R], load)
    cl = load if not cload else fields["broker_cload"][d_c]
    np.testing.assert_array_equal(dst_f[:, 3 * R:4 * R], cl)
    f_old = ref_cost.broker_cost(
        opt.config, ca_r, m.capacity[d_c], m.broker_load[d_c],
        m.leader_nwin[d_c], m.pot_nwout[d_c], m.rcount[d_c], m.lcount[d_c],
        cload=m.broker_cload[d_c] if cload else None)
    close(dst_f[:, -1], f_old, "f_dst_old")
    if "zero_cap" in case:
        assert (cap == 0).any()
    if "pool_pad" in case:
        assert (dp == -1).sum() == 4 and not (dst_i[-4:, 2] & 1).any()


# ---- K6: candidate scoring ---------------------------------------------------

@pytest.mark.parametrize("rf,cload,case", [
    (1, False, "mixed"), (8, True, "mixed"), (3, True, "empty_slot"),
    (3, False, "excluded+mixed"), (3, False, "zero_cap+tiled+mixed"),
], ids=["rf1-mixed", "rf8-percentile-mixed", "empty_slot-percentile",
        "excluded-mixed", "zero_cap-tiled-mixed"])
def test_score_candidates_twin_matches_reference(rf, cload, case):
    """K6's twin on the case's leadership pool (and, mixed, every move
    row of the grid's pool to a seeded destination, one in eight -1)
    against the reference's ``_score_candidates``.  On CPU tensors the
    wrapper runs the twin, which takes no cost table; the kernel's reads
    of K2's table are held to the twin on the card only (chip_smoke.py)."""
    fields, can, pools, opt = world(9, rf, cload)
    fields, (kp, ks, _, lp, lsl), cd = hard(case, fields, pools)
    (m, ca_r), (pm, ca) = both(fields, can)
    cols = [np.ones_like(lp), lp, lsl, np.zeros_like(lp)]
    if cd is not None:
        cols = [np.concatenate(x) for x in zip(
            (np.zeros_like(kp), kp, ks, cd), cols)]
    d_r, f_r = (np.asarray(x) for x in T._score_candidates(
        m, opt.config, ca_r, *(jnp.asarray(x) for x in cols)))
    args = (pm, CFG, ca, *(torch.as_tensor(x.astype(np.int32))
                           for x in cols))
    before = K6.score_candidates.launches
    d, f = K6.score_candidates(*args)
    assert K6.score_candidates.launches == before     # CPU: plain twin
    assert np.array_equal(f.numpy(), f_r)
    assert f_r.any() and not f_r.all()
    close(d.numpy(), d_r, "delta")


# ---- the brokers' cost table K2 writes for K6 --------------------------------

def test_broker_cost_table_matches_reference_per_broker():
    """``broker_costs_plain`` — what K2 writes into ``bcost`` — against the
    reference's ``broker_cost`` of each broker alone, with mean and with
    capacity loads, and a zero capacity; ``grid_terms`` always returns
    the table (in the buffer given, else a new one) and ``grid_rescore``
    fills the buffer given, on the CPU too."""
    for cload in (False, True):
        fields, can, pools, opt = world(6, 3, cload)
        fields, (kp, ks, dp, _, _), _ = hard("zero_cap", fields, pools)
        (m, ca_r), (pm, ca) = both(fields, can)
        table = G.broker_costs_plain(pm, CFG, ca).numpy()
        B = fields["capacity"].shape[0]
        assert table.shape == (B,)
        for b in range(B):
            want = ref_cost.broker_cost(
                opt.config, ca_r, m.capacity[b], m.broker_load[b],
                m.leader_nwin[b], m.pot_nwout[b], m.rcount[b], m.lcount[b],
                cload=m.broker_cload[b] if cload else None)
            close(table[b:b + 1], np.asarray(want)[None], f"broker {b}")
        kp_t, ks_t, dp_t = (torch.as_tensor(x) for x in (kp, ks, dp))
        buf = torch.full((B,), np.nan)
        pk = G.grid_terms(pm, CFG, ca, kp_t, ks_t, dp_t, bcost=buf)
        assert pk["bcost"] is buf and torch.equal(buf, torch.as_tensor(table))
        assert torch.equal(G.grid_terms(pm, CFG, ca, kp_t, ks_t,
                                        dp_t)["bcost"], buf)
        buf2 = torch.full((B,), np.nan)
        G.grid_rescore(pm, CFG, ca, kp_t, ks_t, dp_t, 8, bcost=buf2)
        assert torch.equal(buf2, buf)

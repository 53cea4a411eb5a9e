"""The widths the redesigned K11 ``top_select`` and K1 ``grid_top_r`` must
hold, on the CPU, against the JAX reference, and the launch arithmetic
their wrappers keep as plain functions.

K11's plain twin (the version the card's kernel is held to bit for bit in
``chip_smoke.py``) must equal ``jax.lax.top_k`` exactly, in order, where
the new selection has its edge cases: k = N (no passes), k = 1, every key
equal (all ties at the k-th key) and one key past a block's 4 096-entry
slice.  K1's plain twin must agree with the reference's ``_grid_top_r``
over ``move_grid_scores`` at the replication factors whose slot instances
the kernel gains (1, 2 and 4; every other test runs S = 3), with
``tests/test_torch_ops.py``'s tolerances: identical +inf masks, finite
scores within rtol 1e-5 / atol 1e-4, identical destinations on tie-free
rows."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.ops import grid as ref_grid
from cruise_control_tpu_torch.analyzer import pool_kernels as PK
from cruise_control_tpu_torch.analyzer.cuda_optimizer import CudaSearchConfig
from cruise_control_tpu_torch.models.convert import device_model_from_numpy
from cruise_control_tpu_torch.ops import grid

RTOL, ATOL = 1e-5, 1e-4


# ---- K11: exact top-k at the selection's edge cases -------------------------

def _keys(case, rng):
    """(keys, k, S) of one edge case, seeded and tie-rich (±0.0 and -inf
    among a few values, a fifth normal noise)."""
    vals = np.array([-np.inf, -0.0, 0.0, 1.0, 2.5, 1e5], np.float32)

    def tie_rich(n):
        x = rng.choice(vals, n).astype(np.float32)
        noisy = rng.random(n) < 0.2
        x[noisy] = rng.normal(size=int(noisy.sum())).astype(np.float32)
        return x
    if case == "k_eq_n":
        return tie_rich(1000), 1000, 1
    if case == "k1":
        return tie_rich(9000), 1, 3
    if case == "all_equal":
        return np.full(6000, 2.5, np.float32), 2048, 3
    return tie_rich(4097), 2048, 3          # one key past a block's slice


@pytest.mark.parametrize("case", ["k_eq_n", "k1", "all_equal", "n4097"])
def test_top_select_edge_cases_match_xla_top_k(case):
    x, k, S = _keys(case, np.random.default_rng(11))
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
    hi = torch.full((k,), -1, dtype=torch.int32)
    lo, flat = hi.clone(), torch.full((k,), -1, dtype=torch.int64)
    before = PK.top_select.launches
    PK.top_select(torch.tensor(x), hi, lo, flat, S=S)
    assert PK.top_select.launches == before       # CPU tensors: plain twin
    assert np.array_equal(flat.numpy(), want)
    assert np.array_equal(hi.numpy(), want // S)
    assert np.array_equal(lo.numpy(), want % S)


def test_top_select_grid_and_workspace():
    """K11's grid: a block per 4 096 keys or per 64 kept, whichever is
    more, at most one an SM; its workspace covers the largest grid on any
    card and grows with k and n (one workspace serves a repool's three
    selections)."""
    assert PK.top_select_grid(60_000, 8192, 132) == 128      # the rank's
    assert PK.top_select_grid(60_000, 512, 132) == 15        # the slices'
    assert PK.top_select_grid(8_252_000, 2048, 132) == 132   # one an SM
    assert PK.top_select_grid(1000, 1000, 132) == 16
    assert PK.top_select_grid(10, 1, 132) == 1
    control = PK._TOP_CONTROL
    for k, n in ((8192, 60_000), (2048, 73_728), (1, 4097), (1000, 1000)):
        g = max(-(-n // 4096), -(-k // 64))
        assert PK.top_select_words(k, n) == control + 2 * g + 2 * k
        for sms in (1, 15, 132, 1024):
            assert PK.top_select_grid(n, k, sms) <= g
    assert PK.top_select_words(8192, 60_000) >= PK.top_select_words(1000,
                                                                    1000)
    # the kept keys staged for the rank fit in a block's shared memory
    assert 16_384 < PK.top_select_max_k() < 60_000


# ---- K1: the slot instances and the launch geometry -------------------------

def test_slot_instances():
    assert [grid.slot_instance(s) for s in range(1, 9)] == \
        [1, 2, 3, 4, 8, 8, 8, 8]
    for bad in (0, 9):
        with pytest.raises(ValueError):
            grid.slot_instance(bad)


def test_grid_top_r_geometry():
    """W warps a row (a power of two) only where the card has warps to
    spare for the rows, never more than a 32-column share of D or a
    block's warps; one persistent wave of at most SMs × resident blocks."""
    geo = grid.grid_top_r_geometry
    # the full mid-scale grid: one warp a row, one block an SM
    assert geo(8192, 1000, 132, 1) == (1, 132)
    # a row list of 512 (the stale rows' capacity): 8 warps a row
    assert geo(512, 1000, 132, 1) == (8, 128)
    assert geo(38, 1000, 132, 1) == (16, 19)
    # D bounds W: 77 destinations give at most two warps
    assert geo(1999, 77, 132, 1) == (2, 125)
    assert geo(10, 50, 132, 1) == (1, 1)
    W, g = geo(3000, 50, 132, 2)
    assert (W, g) == (1, 94)
    for n, D in ((1, 1000), (64, 2000), (5000, 300)):
        W, g = geo(n, D, 132, 1)
        assert W & (W - 1) == 0 and 1 <= W <= grid._WARPS
        assert 32 * W <= max(D, 32) and 1 <= g <= 132
    # the staged row is odd (no bank conflicts) and D must fit one block
    assert grid._CST % 2 == 1
    grid._check_widths(3, 1000)
    with pytest.raises(ValueError):
        grid._check_widths(3, 4000)


@functools.lru_cache(maxsize=None)
def _carried_rf(rf):
    """(reference, port) model, constraints and first pools of one
    seeded cluster of replication factor ``rf``."""
    ref_state = ref_random(seed=21, num_brokers=24, num_racks=6,
                           num_partitions=160, replication_factor=rf,
                           dead_brokers=1)
    ctx = RefContext(ref_state)
    opt = T.TpuGoalOptimizer()
    m = opt._device_model(ctx)
    can = opt._constraint_arrays_np(ctx)
    ca_r = {k: jnp.asarray(v) for k, v in can.items()}
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    kp, ks, dp, _, _ = T._build_pools(m, opt.config, ca_r, K, D)
    fields = {f.name: (None if getattr(m, f.name) is None
                       else np.asarray(getattr(m, f.name)))
              for f in dataclasses.fields(m)}
    pm = device_model_from_numpy(fields, device="cpu")
    ca = {k: torch.as_tensor(v) for k, v in can.items()}
    to_t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return ((m, opt.config, ca_r, kp, ks, dp),
            (pm, CudaSearchConfig(), ca, to_t(kp), to_t(ks), to_t(dp)))


@pytest.mark.parametrize("rf", [1, 2, 4])
def test_grid_top_r_plain_matches_reference_at_rf(rf):
    (m, cfg_r, ca_r, kp, ks, dp), port = _carried_rf(rf)
    pm, cfg, ca, pkp, pks, pdp = port
    assert pm.assignment.shape[1] == rf
    R = min(T.DESTS_PER_SOURCE, dp.shape[0])
    g_ref = ref_grid.move_grid_scores(m, cfg_r, ca_r, kp, ks, dp)
    neg, idx_ref = T._grid_top_r(cfg_r, -g_ref, R)
    s_ref, idx_ref = -np.asarray(neg), np.asarray(idx_ref)
    terms = grid.move_grid_terms(pm, cfg, ca, pkp, pks)
    s, idx = grid.grid_top_r_plain(pm, cfg, ca, pkp, pks, pdp, terms, R)
    s, idx = s.numpy(), idx.numpy()
    assert np.array_equal(np.isinf(s), np.isinf(s_ref))
    fin = np.isfinite(s_ref)
    assert fin.any()
    np.testing.assert_allclose(s[fin], s_ref[fin], rtol=RTOL, atol=ATOL)
    full = np.sort(np.asarray(g_ref), axis=1)[:, : R + 1]
    with np.errstate(invalid="ignore"):
        gap = np.diff(full, axis=1)
        tie_free = np.all((gap > ATOL + RTOL * np.abs(full[:, 1:]))
                          | np.isinf(full[:, 1:]), axis=1)
    assert tie_free.sum() > 0
    assert np.array_equal(idx[tie_free], idx_ref[tie_free])

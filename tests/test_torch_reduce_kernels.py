"""K3's wrapper (the per-broker reductions, B5) on the CPU, against the JAX
reference, and the order-preserving key K3 and K5 rank scores by.

On CPU tensors the wrapper runs its plain twin, the version the card's
kernel is held to in ``chip_smoke.py``.  Integers, masks and the reduced
scores match the reference exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import step_kernels as SK
from test_torch_step_kernels import as_t, carried


# ---- K3 / K5's order-preserving key ------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_order_key_preserves_float_order(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.standard_normal(200) * 10.0 ** rng.integers(-30, 30, 200),
        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 3.5, 3.5, -2.0, -2.0,
         np.finfo(np.float32).max, -np.finfo(np.float32).max],
    ]).astype(np.float32)
    k = SK.order_key(torch.as_tensor(x)).numpy()
    assert k.dtype == np.int64 and k.min() >= 0 and k.max() < 2 ** 32
    a, b = np.meshgrid(np.arange(x.size), np.arange(x.size))
    assert np.array_equal(k[a] < k[b], x[a] < x[b])
    assert np.array_equal(k[a] == k[b], x[a] == x[b])   # -0.0 == +0.0
    assert (k[np.isfinite(x)] < SK.order_key(torch.tensor(np.inf)).item()
            ).all()


# ---- K3's wrapper: the plain twin, held to the reference --------------------

def _reduce_inputs(seed):
    (m, ca_r, (kp, ks, dp, lp, lsl), opt), (pm, ca, pools) = carried(seed,
                                                                    False)
    L = lp.shape[0]
    ls_r, _ = T._score_candidates(m, opt.config, ca_r,
                                  jnp.ones(L, jnp.int32), lp, lsl,
                                  jnp.zeros(L, jnp.int32))
    rng = np.random.default_rng(seed)
    K = kp.shape[0]
    best = rng.standard_normal(K).astype(np.float32)
    best[rng.random(K) < 0.2] = np.inf
    S = np.asarray(m.assignment).shape[1]
    slot = np.asarray(kp).astype(np.int64) * S + np.asarray(ks)
    sb = np.maximum(np.asarray(m.assignment).reshape(-1)[slot],
                    0).astype(np.int32)
    return m, pm, lp, lsl, np.asarray(ls_r), slot, sb, best


@pytest.mark.parametrize("seed", [4, 9])
def test_per_src_top_matches_reference(seed):
    """K3's wrapper (plain twins on the CPU) against the reference's two
    reductions: +inf scores, brokers with no rows (index K or L) and a
    dead broker come out alike.  The wrapper reads each row's source
    broker from its slot and its best score as source term plus carried
    destination term (``dest_terms``): slots hold ``sb``, the source terms
    are 0 and the destination terms ``best``."""
    m, pm, lp, lsl, ls, slot, sb, best = _reduce_inputs(seed)
    B, Q = 16, 4
    moved = sb == 3              # broker 3 has no rows: its rows' slots
    sb[moved] = 0                # point at one of broker 0,
    slot[moved] = np.flatnonzero(np.asarray(m.assignment).reshape(-1)
                                 == 0)[0]
    best[sb == 5] = np.inf       # broker 5 only infeasible ones
    dt = np.stack([best, np.zeros_like(best)], axis=1)
    before = SK.per_src_top.launches
    (score, p, s, dst), (rows, scores), got_sb = SK.per_src_top(
        pm, as_t(lp), as_t(lsl), as_t(ls), as_t(slot),
        torch.zeros(len(best)), as_t(dt), B, Q, dest_terms=True)
    assert SK.per_src_top.launches == before
    assert np.array_equal(got_sb.numpy(), sb)
    red = T._reduce_leadership_per_src(m, lp, lsl, jnp.asarray(ls))
    for a, b in zip(red, (score, p, s, dst)):
        assert np.array_equal(np.asarray(a), b.numpy())
    top = T._topq_rows_per_src(jnp.asarray(sb), jnp.asarray(best), B, Q)
    for a, b in zip(top, (rows, scores)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert (rows.numpy()[:, [3, 5]] == sb.size).all()
    assert np.isinf(scores.numpy()[:, [3, 5]]).all()

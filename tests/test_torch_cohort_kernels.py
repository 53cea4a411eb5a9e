"""K4's wrapper (the budgeted cohort, B7) on the CPU, against the JAX
reference: the step's budgets with and without percentile capacity loads,
the order-free fixed-point sums K4 reproduces, and two rounds of
acceptance.

On CPU tensors the wrapper runs its plain twin, the version the card's
kernel is held to in ``chip_smoke.py``.  Masks match exactly; floats
within RTOL and ATOL of tests/test_torch_step_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.analyzer import step_kernels as SK
from cruise_control_tpu_torch.ops.segment import segment_sum
from test_torch_step_kernels import ATOL, RTOL, as_t, carried


# ---- K4's budgets (B7) ------------------------------------------------------

@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_step_budgets_match_reference(cload):
    (m, ca_r, _, _), (pm, ca, _) = carried(4, cload)
    assert (pm.broker_cload is not None) == cload
    sb_r, db_r = (np.asarray(x) for x in T._step_budgets(m, ca_r))
    sb, db = (x.numpy() for x in C._step_budgets(pm, ca))
    nb = NUM_RESOURCES + 2 + (NUM_RESOURCES if cload else 0)
    assert sb.shape == db.shape == (16, nb)
    for got, want in ((sb, sb_r), (db, db_r)):
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


# ---- K4's order-free fixed-point sums ---------------------------------------

@pytest.mark.parametrize("n,cols", [(1, 1), (37, 4), (1500, 6)])
def test_bounded_segment_sum_exact_and_order_free(n, cols):
    rng = np.random.default_rng(n)
    v = (rng.standard_normal((n, cols))
         * 10.0 ** rng.integers(-3, 6, (n, 1))).astype(np.float32)
    v[rng.random((n, cols)) < 0.1] = 0.0
    ids = rng.integers(0, 9, n)
    want = np.zeros((9, cols))
    np.add.at(want, ids, v.astype(np.float64))
    got = segment_sum(torch.as_tensor(v), torch.as_tensor(ids), 9)
    # 2^-60 of N·max|v| per row at most: f32 rounding dominates
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                               rtol=1e-6, atol=1e-6 * np.abs(v).sum())
    perm = rng.permutation(n)
    again = segment_sum(torch.as_tensor(v[perm]), torch.as_tensor(ids[perm]),
                        9)
    assert torch.equal(got, again)
    np.testing.assert_array_equal(
        SK._colsum(torch.as_tensor(v)).numpy(),
        segment_sum(torch.as_tensor(v), torch.zeros(n, dtype=torch.long),
                    1)[0].numpy())
    # no rows: zero sums at a finite scale
    empty = segment_sum(torch.zeros((0, cols)),
                        torch.zeros(0, dtype=torch.long), 9)
    assert torch.equal(empty, torch.zeros((9, cols)))


# ---- K4's wrapper: the plain twin, held to the reference --------------------

@pytest.mark.parametrize("slack", [1.0, 1.3])
def test_budget_accept_matches_reference(slack):
    """K4's wrapper (plain twin on the CPU): budgets from the model, the
    slack on the soft dims, two rounds of acceptance — against the
    reference composed the same way."""
    (m, ca_r, _, _), (pm, ca, _) = carried(4, False)
    rng = np.random.default_rng(7)
    n, B = 120, 16
    nb = NUM_RESOURCES + 2
    dst = rng.integers(0, B, n).astype(np.int32)
    src = rng.integers(0, B, n).astype(np.int64)
    budgets = np.asarray(T._step_budgets(m, ca_r)[1])[:, :NUM_RESOURCES]
    vec = np.concatenate([
        rng.uniform(0.0, 1.0, (n, NUM_RESOURCES)) * budgets.mean(0) / 3,
        np.ones((n, 1)), rng.uniform(0.0, 1.0, (n, 1))], 1).astype(
            np.float32)
    elig = rng.random(n) < 0.8
    before = SK.budget_accept.launches
    acc, sbud, dbud = SK.budget_accept(pm, ca, as_t(dst), as_t(src),
                                       as_t(vec), as_t(elig), slack)
    assert SK.budget_accept.launches == before
    sb_r, db_r = T._step_budgets(m, ca_r)
    if slack != 1.0:
        soft = NUM_RESOURCES + 2
        sb_r = sb_r.at[:, :soft].multiply(slack)
        db_r = db_r.at[:, :soft].multiply(slack)
    ref = T._budget_accept(jnp.asarray(dst), jnp.asarray(src),
                           jnp.asarray(vec), db_r, sb_r, jnp.asarray(elig))
    assert vec.shape[1] == nb and np.asarray(ref).any()
    assert np.array_equal(np.asarray(ref), acc.numpy())
    np.testing.assert_allclose(sbud.numpy(), np.asarray(sb_r), rtol=RTOL,
                               atol=ATOL)

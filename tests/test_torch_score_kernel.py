"""K6's wrapper (candidate scoring, B3) on the CPU, against the JAX
reference, and the kernel build's hash over the shared headers.

On CPU tensors the wrapper runs its plain twin ``_score_candidates``, the
version the card's kernel is held to in ``chip_smoke.py``.  Candidates
mix replica moves (to seeded destinations of the pool, some -1) and
leadership transfers, on placements with a dead broker, with and without
percentile capacity loads.  Feasibility matches the reference exactly;
finite deltas within the tolerances of tests/test_torch_ops.py (rtol
1e-5, atol 1e-4: f32 sums in another order, on scores carrying 1e6 / 1e4
bonuses) — and the wrapper equals the plain twin to the bit."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import score_kernel as K6
from cruise_control_tpu_torch.ops import kernels
from test_torch_step_kernels import CFG, as_t, carried

RTOL, ATOL = 1e-5, 1e-4


def mixed(pools, seed: int, ragged: bool):
    """(kind, cp, cs, cd) int32: every move row of the pool to a seeded
    destination of the destination pool (one in eight to -1), then the
    leadership pool; ``ragged`` keeps a seeded odd-sized subset."""
    kp, ks, dp, lp, lsl = (np.asarray(x) for x in pools)
    rng = np.random.default_rng(seed)
    cd = dp[rng.integers(0, dp.shape[0], kp.shape[0])]
    cd = np.where(rng.random(kp.shape[0]) < 0.125, -1, cd)
    kind = np.concatenate([np.zeros_like(kp), np.ones_like(lp)])
    cols = [kind, np.concatenate([kp, lp]), np.concatenate([ks, lsl]),
            np.concatenate([cd, np.zeros_like(lp)])]
    if ragged:
        keep = np.sort(rng.choice(kind.shape[0], 2 * (kind.shape[0] // 3) + 1,
                                  replace=False))
        cols = [c[keep] for c in cols]
    return [c.astype(np.int32) for c in cols]


@pytest.mark.parametrize("seed,cload,ragged", [
    (6, False, False), (6, True, False), (9, False, True), (9, True, True),
], ids=["mean", "percentile", "ragged", "ragged-percentile"])
def test_score_candidates_matches_reference_on_mixed_kinds(seed, cload,
                                                           ragged):
    (m, ca_r, pools_r, opt), (pm, ca, _) = carried(seed, cload)
    kind, cp, cs, cd = mixed(pools_r, seed, ragged)
    assert 0 < int((kind == 0).sum()) < kind.shape[0]
    assert bool(np.asarray(m.must_move).any())        # a dead broker
    d_r, f_r = T._score_candidates(m, opt.config, ca_r, *(
        jnp.asarray(x) for x in (kind, cp, cs, cd)))
    args = (pm, CFG, ca, *(as_t(x) for x in (kind, cp, cs, cd)))
    before = K6.score_candidates.launches
    d, f = K6.score_candidates(*args)
    assert K6.score_candidates.launches == before     # CPU: plain twin
    pd, pf = K6._score_candidates(*args)
    assert torch.equal(d, pd) and torch.equal(f, pf)
    f_r, d_r = np.asarray(f_r), np.asarray(d_r)
    assert np.array_equal(f.numpy(), f_r)
    assert f_r.any() and not f_r.all()
    fin = np.isfinite(d_r)
    assert np.array_equal(np.isfinite(d.numpy()), fin)
    np.testing.assert_allclose(d.numpy()[fin], d_r[fin], rtol=RTOL, atol=ATOL)


def test_kernel_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header — each one K2 and K6 include —
    gives every kernel a new library path, so no stale build of K2 or K6
    is loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    for name in ("broker_cost.cuh", "row_gather.cuh", "grid_cell.cuh",
                 "step_common.cuh", "score_common.cuh"):
        before = {n: kernels.library_path(n)
                  for n in ("grid_terms", "score_candidates")}
        header = csrc / name
        header.write_text(header.read_text() + "\n// edited\n")
        after = {n: kernels.library_path(n) for n in before}
        assert all(before[n] != after[n] for n in before), name
        assert kernels.library_path("grid_terms") == after["grid_terms"]

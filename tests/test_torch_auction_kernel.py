"""K5's wrapper (the auction, B8) on the CPU, against the JAX reference.

On CPU tensors the wrapper runs its plain twin, the version the card's
kernel is held to in ``chip_smoke.py``.  Every output matches the
reference exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import step_kernels as SK
from test_torch_step_kernels import as_t


@pytest.mark.parametrize("caps,ratio,rounds", [
    ((2, 2), 0.5, 0), ((2, 1), 0.8, 3), ((1, 3), 0.3, 0), ((1, 1), 0.5, 0),
])
def test_match_batch_wrapper_matches_reference(caps, ratio, rounds):
    """K5's wrapper (plain twin on the CPU) against the reference auction,
    on the ``track_bars`` branch (a cap above 1) and off it, with A = 8
    alternates as the step gives it."""
    rng = np.random.default_rng(caps[0] * 7 + caps[1])
    N, A, B = 128, 8, 24
    score = np.sort(-rng.exponential(1.0, (N, A)), axis=1).astype(np.float32)
    score[rng.random((N, A)) < 0.1] = np.inf
    dst = rng.integers(0, B, (N, A)).astype(np.int32)
    src = rng.integers(0, B, N).astype(np.int64)
    p = rng.integers(0, N // 2, N).astype(np.int64)
    used = (rng.random(B) < 0.1, rng.random(B) < 0.1, rng.random(N) < 0.05)
    kw = dict(tol=-1e-4, B=B, P=N, dest_cap=caps[0], src_cap=caps[1],
              stack_ratio=ratio, rounds=rounds)
    ref = T._match_batch(jnp.asarray(score), jnp.asarray(dst),
                         jnp.asarray(src), jnp.asarray(p),
                         init_used=tuple(jnp.asarray(u) for u in used), **kw)
    before = SK.match_batch.launches
    got = SK.match_batch(as_t(score), as_t(dst), as_t(src), as_t(p),
                         init_used=tuple(as_t(u) for u in used), **kw)
    assert SK.match_batch.launches == before
    assert np.asarray(ref[0]).any()
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())

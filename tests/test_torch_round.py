"""The score-only round (B14: kernels K13 and K14) on the CPU, against the
JAX reference.

The whole round of plain twins (``analyzer/round_kernels.py:
round_plain``) runs against the reference's ``_cached_round_fn(cfg, K, D,
None)(m, ca)`` on the seeded fixtures of tests/test_torch_step_kernels.py,
in both forms, with and without percentile capacity loads: the packed
kind / partition / slot / destination rows must be equal — the test first
asserts that no score within tolerance straddles the k-th boundary, so
the selected set is well defined — and the scores must agree within RTOL
/ ATOL.  The flat key's ±0.0 and tie order is held to ``lax.top_k``
itself, the pieces (reduced candidates, columnar scores, decode, unpack)
to their reference functions, and the wrappers on CPU tensors to the
twins, bit for bit, with no launch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.ops.grid import move_grid_scores
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer import pool_kernels as PK
from cruise_control_tpu_torch.analyzer import round_kernels as RK
from cruise_control_tpu_torch.models.convert import device_model_from_numpy
from cruise_control_tpu_torch.ops.grid import grid_rescore
from test_torch_step_kernels import ATOL, RTOL, as_t, carried


def sizes(pm):
    P, S = pm.assignment.shape
    return C.CudaGoalOptimizer(device="cpu")._pool_sizes(
        P, S, pm.capacity.shape[0])


def assert_clear_boundary(key: torch.Tensor, k: int) -> None:
    """The k-th largest key is apart from the (k+1)-th by more than the
    tolerance (or k takes every entry), so the top-k set is the same on
    both sides however their scores round."""
    if k >= key.shape[0]:
        return
    top = torch.sort(key, descending=True).values[k - 1:k + 1].double()
    gap = float(top[0] - top[1])
    assert gap > ATOL + RTOL * abs(float(top[1])) or \
        bool(torch.isinf(top).all()), ("k-th boundary tied", top)


def check_packed(got: np.ndarray, ref: np.ndarray) -> None:
    """Ids equal column by column over the finite scores (which rank
    first); the +inf tail as a set of candidates: the reference's
    leadership pool lists its -inf-priority entries in no index order
    (``approx_max_k`` on the CPU, ROADMAP.md §C), so their infeasible
    transfers may sit at other flat indices."""
    assert got.shape == ref.shape
    assert np.array_equal(np.isinf(got[0]), np.isinf(ref[0]))
    fin = np.isfinite(ref[0])
    n = int(fin.sum())
    assert fin[:n].all()
    np.testing.assert_array_equal(got[1:, :n], ref[1:, :n])
    np.testing.assert_allclose(got[0][fin], ref[0][fin], rtol=RTOL,
                               atol=ATOL)
    tail = lambda x: sorted(map(tuple, x[1:, n:].T.tolist()))  # noqa: E731
    assert tail(got) == tail(ref)


@pytest.mark.parametrize("scoring", ["grid", "columnar"])
@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_round_matches_reference(scoring, cload):
    (m, ca_r, _, _), (pm, ca, _) = carried(6, cload)
    K, D = sizes(pm)
    cfg = C.CudaSearchConfig(scoring=scoring)
    pools = C._build_pools(pm, cfg, ca, K, D)
    if scoring == "grid":
        _, _, rs, _, _, _, ls = RK.reduced_candidates_plain(pm, cfg, ca,
                                                             pools)
        key = RK.round_keys_plain(rs, ls)
    else:
        key = RK.round_keys_plain(RK.score_columnar_plain(
            pm, cfg, ca, *pools[:3]))
    k = min(cfg.topk_per_round, key.shape[0])
    assert k == 2048 < key.shape[0]
    assert_clear_boundary(key, k)
    ref = np.asarray(T._cached_round_fn(T.TpuSearchConfig(scoring=scoring),
                                        K, D, None)(m, ca_r))
    got = RK.round_plain(pm, cfg, ca, K, D, scoring, pools)
    check_packed(got.numpy(), ref)
    # moves and transfers both among the selected
    assert set(np.unique(ref[1])) == {0.0, 1.0}


def test_ragged_round_takes_every_entry():
    """6 brokers (D = R = 6) and 60 partitions: K·R + L = K·D + P·S = 1 260
    entries, all kept (k = N), the +inf ones last."""
    state = ref_random(seed=9, num_brokers=6, num_racks=3, num_partitions=60,
                       dead_brokers=1)
    opt = T.TpuGoalOptimizer()
    ctx = RefContext(state)
    m = opt._device_model(ctx)
    can = opt._constraint_arrays_np(ctx)
    ca_r = {k: jnp.asarray(v) for k, v in can.items()}
    pm = device_model_from_numpy(
        {f.name: (None if getattr(m, f.name) is None
                  else np.asarray(getattr(m, f.name)))
         for f in dataclasses.fields(m)}, device="cpu")
    ca = {k: torch.as_tensor(v) for k, v in can.items()}
    K, D = sizes(pm)
    for scoring in ("grid", "columnar"):
        ref = np.asarray(T._cached_round_fn(
            T.TpuSearchConfig(scoring=scoring), K, D, None)(m, ca_r))
        got = RK.round_plain(pm, C.CudaSearchConfig(scoring=scoring), ca, K,
                             D, scoring)
        check_packed(got.numpy(), ref)
        assert np.isinf(ref[0]).any(), scoring
    assert (K, D, ref.shape[1]) == (180, 6, 180 * 6 + 180)


def test_flat_key_zero_signs_and_ties_follow_top_k():
    """``round_keys_plain`` + ``_top_desc`` rank as ``lax.top_k(-x, k)``:
    a score of -0.0 ahead of +0.0, equal scores by lowest index, +inf
    last — on tie-rich vectors, grid layout (scores and leadership) and
    flat."""
    rng = np.random.default_rng(3)
    vals = np.array([-2.0, -0.0, 0.0, 1.5, np.inf], np.float32)
    for n, k in ((97, 40), (1000, 1000), (4096, 257)):
        x = rng.choice(vals, n)
        noise = rng.random(n) < 0.2
        x[noise] = rng.normal(size=int(noise.sum())).astype(np.float32)
        _, want = jax.lax.top_k(-jnp.asarray(x), k)
        got = PK._top_desc(RK.round_keys_plain(torch.tensor(x)), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        rows, ls = torch.tensor(x[: n - 17]).reshape(-1, 1), torch.tensor(
            x[n - 17:])
        got2 = PK._top_desc(RK.round_keys_plain(rows, ls), k)
        np.testing.assert_array_equal(got2.numpy(), np.asarray(want))


def test_reduced_candidates_and_columnar_scores_match_reference():
    (m, ca_r, pools_r, opt), (pm, ca, pools) = carried(6, True)
    K, D = sizes(pm)
    cfg = C.CudaSearchConfig()
    ref = T._reduced_candidates(m, opt.config, ca_r, K, D, move_grid_scores,
                                pools=pools_r)
    got = RK.reduced_candidates_plain(pm, cfg, ca, pools)
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        if a.is_floating_point():
            assert np.array_equal(np.isinf(a.numpy()), np.isinf(b)), i
            fin = np.isfinite(b)
            np.testing.assert_allclose(a.numpy()[fin], b[fin], rtol=RTOL,
                                       atol=ATOL)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=str(i))
    kind, cp, cs, cd = T._build_round_candidates(m, ca_r, K, D)
    ref_s, _ = T._score_candidates(m, opt.config, ca_r, kind, cp, cs, cd)
    got_s = RK.score_columnar_plain(pm, cfg, ca, *pools[:3]).numpy()
    ref_s = np.asarray(ref_s)
    assert got_s.shape == ref_s.shape == (K * D + pm.assignment.numel(),)
    assert np.array_equal(np.isinf(got_s), np.isinf(ref_s))
    fin = np.isfinite(ref_s)
    np.testing.assert_allclose(got_s[fin], ref_s[fin], rtol=RTOL, atol=ATOL)


def test_decode_and_unpack_match_reference():
    """Both decodes on every flat index (clips included: the grid layout
    past its end), and the host unpack, against the reference's."""
    rng = np.random.default_rng(5)
    K, R, L, D, S = 37, 5, 23, 11, 3
    kp = rng.integers(0, 50, K).astype(np.int32)
    ks = rng.integers(0, S, K).astype(np.int32)
    best_d = rng.integers(0, 40, (K, R)).astype(np.int32)
    lp = rng.integers(0, 50, L).astype(np.int32)
    lsl = rng.integers(0, S, L).astype(np.int32)
    idx = np.arange(K * R + L + 4).astype(np.int32)
    ref = T._decode_flat_idx(*(jnp.asarray(a) for a in
                               (idx, kp, ks, best_d, lp, lsl)))
    got = RK.decode_flat_idx(*(as_t(a) for a in
                               (idx, kp, ks, best_d, lp, lsl)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # columnar: the reference gathers the materialized columns
    dest = rng.integers(0, 40, D).astype(np.int32)
    n_l = 50 * S
    cols = (np.concatenate([np.repeat(kp, D), np.arange(n_l) // S]),
            np.concatenate([np.repeat(ks, D), np.arange(n_l) % S]),
            np.concatenate([np.tile(dest, K), np.zeros(n_l, np.int64)]))
    cidx = np.arange(K * D + n_l)
    is_move, kind, p, s, d = RK.decode_columnar(as_t(cidx), as_t(kp),
                                                as_t(ks), as_t(dest), S)
    np.testing.assert_array_equal(is_move.numpy(), cidx < K * D)
    np.testing.assert_array_equal(kind.numpy(), (cidx >= K * D).astype(int))
    for a, col in zip((p, s, d), cols):
        np.testing.assert_array_equal(a.numpy(), col[cidx])
    packed = np.stack([rng.normal(size=9), rng.integers(0, 2, 9),
                       rng.integers(0, 50, 9), rng.integers(0, 3, 9),
                       rng.integers(0, 40, 9)]).astype(np.float32)
    packed[1:, 4] = np.inf
    for a, b in zip(RK.unpack_round_result(packed),
                    T._unpack_round_result(packed)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("scoring", ["grid", "columnar"])
def test_round_wrappers_on_cpu_are_the_twins(scoring):
    """The search's round (K10/K11, K2/K1/K6 or K14, K13, K11, K13
    wrappers) on CPU tensors launches nothing and equals ``round_plain``
    bit for bit; K13 (b)'s twin from K1's pool indices equals the decode
    from broker ids."""
    (_, _, _, _), (pm, ca, _) = carried(4, False)
    K, D = sizes(pm)
    cfg = C.CudaSearchConfig(scoring=scoring)
    wrappers = (C.pool_tables, C.top_select, C.grid_terms,
                C.launch_grid_top_r, C.score_candidates, RK.score_columnar,
                RK.round_keys, RK.round_pack)
    before = [f.launches for f in wrappers]
    got = C._round(pm, cfg, ca, K, D)
    assert [f.launches for f in wrappers] == before
    assert torch.equal(got, RK.round_plain(pm, cfg, ca, K, D, scoring))
    if scoring == "grid":
        kp, ks, dp, lp, lsl = C._build_pools(pm, cfg, ca, K, D)
        _, vals, best_i = grid_rescore(pm, cfg, ca, kp, ks, dp, 8)
        _, _, _, _, _, _, ls = RK.reduced_candidates_plain(
            pm, cfg, ca, (kp, ks, dp, lp, lsl))
        key = RK.round_keys(vals, ls)
        sel = PK._top_desc(key, 100).to(torch.int32)
        assert torch.equal(
            RK.round_pack(key, sel, kp, ks, dp, best_i, lp, lsl),
            got[:, :100])

"""K3's plain twins (the per-broker reductions, B5, with the inputs K3
reads for itself) on the CPU against the JAX reference, on the cases its
card kernel is timed and held on: one source broker holding every row,
every row +inf, Q = 1 and Q = 8, the incremental rescore's form of the
row scores and -0.0 / +0.0 ties; and the columnar round's flat key, which
K14 now stores negated itself.

The inputs are made with numpy from a seed and handed to both sides.
The reference's step takes each row's source broker as
``clip(assignment[kp, ks], 0)`` and its best score as ``src_term + dt``
(``tpu_optimizer.py:1162, 1181-1183``); the port's twins take the row's
flat slot ``kp · S + ks`` and either the carried destination term
(``dest_terms``) or the row's top score (``dt = vals - src_term``).
Integer outputs match exactly, scores to the bit — except the sign of a
zero the reference's scatter-min picks among tied zeros (ROADMAP.md §C),
which :func:`test_zero_tie_sign_against_reference` pins."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer import round_kernels as RK
from cruise_control_tpu_torch.analyzer import step_kernels as SK
from test_torch_step_kernels import carried

B, P, S, K, L = 24, 160, 3, 300, 200


def make_case(case: str, seed: int = 31):
    """→ (inputs dict of numpy arrays, Q, dest_terms) for one case."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, B, (P, S)).astype(np.int32)
    a[rng.random((P, S)) < 0.05] = -1          # empty slots
    leader_slot = rng.integers(0, S, P).astype(np.int32)
    kp = rng.integers(0, P, K).astype(np.int32)
    ks = rng.integers(0, S, K).astype(np.int32)
    lp = rng.integers(0, P, L).astype(np.int32)
    lsl = rng.integers(0, S, L).astype(np.int32)
    # few distinct values: ties across rows of one broker
    ls = rng.integers(-20, 20, L).astype(np.float32) / 4
    ls[rng.random(L) < 0.2] = np.inf
    src = rng.integers(-40, 40, K).astype(np.float32) / 8
    vals = rng.integers(-40, 40, (K, 4)).astype(np.float32) / 8
    vals[rng.random(K) < 0.2, 0] = np.inf
    Q, dest_terms = 4, False
    if case == "one_src":
        a[kp, ks] = 7
    elif case == "all_inf":
        vals[:, 0] = np.inf
        ls[:] = np.inf
    elif case == "q1":
        Q = 1
    elif case == "q8":
        Q = 8
    elif case == "incremental":
        dest_terms = True
    elif case == "zero_ties":
        dest_terms = True
        zero = np.array([-0.0, 0.0], np.float32)
        src = zero[rng.integers(0, 2, K)]
        vals[:, 0] = np.array([-0.0, 0.0, -0.0, 1.0, -1.0],
                              np.float32)[rng.integers(0, 5, K)]
        ls = np.array([-0.0, 0.0, 0.5], np.float32)[rng.integers(0, 3, L)]
    return dict(a=a, leader_slot=leader_slot, kp=kp, ks=ks, lp=lp, lsl=lsl,
                ls=ls, src=src, vals=vals), Q, dest_terms


def run_both(x, Q, dest_terms):
    """→ (reference outputs, port outputs): (score, p, s, dst, rows,
    scores, sb, row_best), numpy."""
    cap = np.ones((B, 1), np.float32)
    ref_m = types.SimpleNamespace(assignment=jnp.asarray(x["a"]),
                                  leader_slot=jnp.asarray(x["leader_slot"]),
                                  capacity=jnp.asarray(cap))
    src, vals = jnp.asarray(x["src"]), jnp.asarray(x["vals"])
    dt = vals if dest_terms else vals - src[:, None]
    rs = src[:, None] + dt
    sb_r = jnp.clip(ref_m.assignment[x["kp"], x["ks"]], 0)
    ref = (*T._reduce_leadership_per_src(ref_m, jnp.asarray(x["lp"]),
                                         jnp.asarray(x["lsl"]),
                                         jnp.asarray(x["ls"])),
           *T._topq_rows_per_src(sb_r, rs[:, 0], B, Q), sb_r, rs[:, 0])
    pm = types.SimpleNamespace(assignment=torch.tensor(x["a"]),
                               leader_slot=torch.tensor(x["leader_slot"]),
                               capacity=torch.tensor(cap))
    slot = torch.tensor(x["kp"].astype(np.int64) * S + x["ks"])
    sb, rb = SK.per_src_top_inputs_plain(pm, slot, torch.tensor(x["src"]),
                                         torch.tensor(x["vals"]),
                                         dest_terms)
    bl, (rows, scores) = SK.per_src_top_plain(
        pm, torch.tensor(x["lp"]), torch.tensor(x["lsl"]),
        torch.tensor(x["ls"]), sb, rb, B, Q)
    port = (*bl, rows, scores, sb, rb)
    return ([np.asarray(r) for r in ref], [p.numpy() for p in port])


CASES = ["base", "one_src", "all_inf", "q1", "q8", "incremental",
         "zero_ties"]


@pytest.mark.parametrize("case", CASES)
def test_src_top_twins_match_reference(case):
    """Integers exact; the reduced scores and the row scores to the bit,
    -0.0 / +0.0 ties included."""
    x, Q, dest_terms = make_case(case)
    ref, port = run_both(x, Q, dest_terms)
    names = ("score", "p", "s", "dst", "rows", "scores", "sb", "row_best")
    for name, r, p in zip(names, ref, port):
        assert r.shape == p.shape, name
        if p.dtype == np.float32:
            assert np.array_equal(r.view(np.int32), p.view(np.int32)), name
        else:
            assert np.array_equal(r.astype(p.dtype), p), name
    rows, sb = port[4], port[6]
    if case == "one_src":
        assert (sb == 7).all() and (rows[:, 7] < K).all()
        assert (rows[:, np.arange(B) != 7] == K).all()
    if case == "all_inf":
        assert (rows == K).all() and np.isinf(port[5]).all()
        assert np.isinf(port[0]).all() and (port[0] > 0).all()
    if case == "zero_ties":
        rb = port[7]
        assert ((rb == 0) & np.signbit(rb)).any()
        assert ((rb == 0) & ~np.signbit(rb)).any()


def test_zero_tie_sign_against_reference():
    """Where a broker's best score is a zero tied across its rows, the
    reference's scatter-min writes -0.0 if any tied row still in play
    holds -0.0, whatever the rows' order; the port's twin (and K3 on the
    card) writes the same.  Rows of one broker in either order and three
    rows with the -0.0 last, first and between: the rows picked and every
    score's bits equal the reference's."""
    for best in ([0.0, -0.0], [-0.0, 0.0], [0.0, 0.0, -0.0],
                 [-0.0, 0.0, 0.0], [0.0, -0.0, 0.0]):
        best = np.array(best, np.float32)
        n = best.shape[0]
        sb = np.zeros(n, np.int32)
        rows_r, scores_r = T._topq_rows_per_src(jnp.asarray(sb),
                                                jnp.asarray(best), 1, n)
        rows, scores = SK._topq_rows_per_src(torch.tensor(sb),
                                             torch.tensor(best), 1, n)
        assert rows.numpy().ravel().tolist() == list(range(n))
        assert np.array_equal(np.asarray(rows_r), rows.numpy())
        assert np.array_equal(np.asarray(scores_r).view(np.int32),
                              scores.numpy().view(np.int32)), best
        # the last pick's score is its own row's zero
        assert np.signbit(scores.numpy()).ravel()[-1] == np.signbit(best[-1])


def test_columnar_round_key_is_k14s_negated_scores():
    """The columnar round's key, as the search makes it on CPU tensors
    (``_round_scores``: K14's wrapper, no K13 (a)), equals
    ``round_keys_plain(score_columnar_plain(...))`` bit for bit, and is
    -score there; the grid form's key is K13 (a)'s."""
    (_, _, _, _), (pm, ca, _) = carried(4, False)
    K_, D = C.CudaGoalOptimizer(device="cpu")._pool_sizes(
        *pm.assignment.shape, pm.capacity.shape[0])
    for scoring in ("columnar", "grid"):
        cfg = C.CudaSearchConfig(scoring=scoring)
        key, layout, pools = C._round_scores(pm, cfg, ca, K_, D)
        if scoring == "columnar":
            scores = RK.score_columnar_plain(pm, cfg, ca, *pools[:3])
            want = RK.round_keys_plain(scores)
            assert set(layout) == {"S"}
            assert torch.equal(key.view(torch.int32), (-scores).view(
                torch.int32))
        else:
            vals, ls, _ = C._grid_round_scores(pm, cfg, ca, pools)
            want = RK.round_keys_plain(vals, ls)
        assert key.dtype == torch.float32
        assert torch.equal(key.view(torch.int32), want.view(torch.int32))


def test_grid_round_key_is_the_references_negated_scores():
    """K13 (a)'s wrapper, on CPU tensors, makes the grid form's flat key
    as the reference's ``top_k(-scores)`` reads it: the rows' [K, R]
    scores then the leadership scores, negated, bit for bit — the zeros'
    signs flipped and the infinities kept."""
    rng = np.random.default_rng(37)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    ls = rng.standard_normal(17).astype(np.float32)
    vals[0] = [0.0, -0.0, np.inf]
    ls[:2] = [-0.0, np.inf]
    want = np.asarray(-jnp.concatenate([jnp.asarray(vals).ravel(),
                                        jnp.asarray(ls)]))
    for got, ref in ((RK.round_keys(torch.tensor(vals), torch.tensor(ls)),
                      want),
                     (RK.round_keys(torch.tensor(vals)), want[:vals.size])):
        assert got.dtype == torch.float32
        assert got.numpy().view(np.int32).tolist() == \
            ref.view(np.int32).tolist()

"""K8's and K5's wrappers (the step's commit and its auction) on the CPU,
against the JAX reference, on the inputs that are hard for the kernels.

On CPU tensors the wrappers run their plain twins, the versions the
card's kernels are held to bit for bit in ``chip_smoke.py``
(``commit_cases``, ``match_cases``).  The commit's inputs are the first
step's of the port's own step loop (:func:`first_commit`), rewritten from
a numpy seed: nothing taken, every row committed (M_step = C), tie-rich
merged scores with -0.0 and +0.0 across the M_step-th, every taken row on
one destination and on one source, and aggregates holding -0.0, which the
reference's zero sums turn into +0.0.  The reference side is
``ref_commit`` (a transcript of the step's commit around the reference's
own ``_apply_batch_on_device``).  Placement, output rows, marks and
counts match exactly; float aggregates within rtol 1e-6 / atol 1e-5 (the
port's sums are exact fixed point, the reference's f32 in XLA's order),
and every zero aggregate with the reference's sign.  The auction runs on
seeded candidates against the reference's ``_match_batch``: no finite
bid, tie-rich scores with -0.0 and +0.0, one destination, one source, a
fixed point after round 1 of 8, and N = 2 048 candidates; every output
matches exactly."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import commit_kernels as K89
from cruise_control_tpu_torch.analyzer import step_kernels as SK
from cruise_control_tpu_torch.analyzer import step_state as SS
from test_torch_commit_kernel import (
    AGGREGATES,
    ATOL,
    RTOL,
    first_commit,
    ref_commit,
    to_ref_model,
)
from test_torch_step_kernels import as_t

COMMIT_CASES = ("no_commit", "all_commit", "ties", "one_dst", "one_src",
                "neg_zero")
AUCTION_CASES = ("no_bid", "ties", "one_dst", "one_src", "fixed_point",
                 "n_2048")


def commit_case(case: str):
    """The first step's commit arguments rewritten for ``case``, and the
    rows of the aggregates set to -0.0 (None where none is)."""
    args = list(copy.deepcopy(first_commit(False)))
    (m, acc, take_d, ws_d, wd_d, cs, d0, _, cand_p, _, cand_src, M_step,
     out, _, _, st) = args
    C = acc.shape[0]
    P = m.assignment.shape[0]
    B = m.capacity.shape[0]
    rng = np.random.default_rng(COMMIT_CASES.index(case) + 41)
    taken = (acc | take_d).numpy()
    zeros = None
    if case in ("no_commit", "neg_zero"):
        # a zero sum reaches every broker that no commit touches: its -0.0
        # aggregates become +0.0
        dst = np.where(acc.numpy(), d0.numpy(), wd_d.numpy())
        touched = set(cand_src.numpy()[taken]) | set(dst[taken])
        free = np.array(sorted(set(range(B)) - touched))
        assert free.size > 0
        zeros = rng.choice(free, min(5, free.size), replace=False)
        m = copy.deepcopy(m)
        for f in AGGREGATES[:-1]:
            getattr(m, f)[zeros] = -0.0
        args[0] = m
    if case == "no_commit":
        args[1] = torch.zeros_like(acc)
        args[2] = torch.zeros_like(take_d)
    if case in ("all_commit", "ties"):
        # distinct partitions, as the step's disjoint batch has them
        args[8] = as_t(rng.permutation(P)[:C]).to(cand_p)
    if case == "all_commit":
        full = cs.clone()
        full[:, 0] = as_t(-1.0 - rng.random(C).astype(np.float32))
        args[1], args[5], args[11] = torch.ones_like(acc), full, C
        args[12] = torch.full((4, max(out.shape[1], C)), -1.0)
        args[15] = dataclasses.replace(st, slot_limit=args[12].shape[1] - C)
    if case == "ties":
        vals = np.array([-0.0, 0.0, -1.0, -2.0], np.float32)
        tie = cs.clone()
        tie[:, 0] = as_t(vals[rng.integers(0, 4, C)])
        a = rng.random(C) < 0.4
        args[1] = as_t(a)
        args[2] = as_t((rng.random(C) < 0.4) & ~a)
        args[3] = as_t(vals[rng.integers(0, 4, C)])
        args[5] = tie
    if case == "one_dst":
        dst = np.where(acc.numpy(), d0.numpy(), wd_d.numpy())[taken]
        hot = int(np.bincount(dst).argmax())
        args[6] = torch.full_like(d0, hot)
        args[4] = torch.full_like(wd_d, hot)
    if case == "one_src":
        hot = int(np.bincount(cand_src.numpy()[taken]).argmax())
        args[10] = torch.full_like(cand_src, hot)
    return args, zeros


@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_cases_match_reference(case):
    args, zeros = commit_case(case)
    pm, M_, out, tpp, st = args[0], args[11], args[12], args[13], args[15]
    count = int(st.state[SS.COUNT])
    conv = lambda x: jnp.asarray(  # noqa: E731
        x.numpy().astype(np.int32) if x.dtype == torch.int64 else x.numpy())
    rm, rtpp, rc, rout = ref_commit(to_ref_model(pm),
                                    *[conv(x) for x in args[1:11]], M_,
                                    conv(out), count, conv(tpp))
    before = K89.commit_batch.launches
    got = copy.deepcopy(args)
    m1, tpp1, c1 = K89.commit_batch(*got)
    assert K89.commit_batch.launches == before      # CPU tensors: plain twin
    C = args[1].shape[0]
    want_c = {"no_commit": 0, "all_commit": C}.get(case)
    assert int(c1[0]) == int(rc) and (want_c is None or int(rc) == want_c)
    if case not in ("no_commit",):
        assert int(rc) > 0
    assert np.array_equal(tpp1.numpy(), np.asarray(rtpp))
    assert np.array_equal(got[12].numpy(), np.asarray(rout))
    assert int(got[15].state[SS.COUNT]) == count + int(rc)
    for f in ("assignment", "leader_slot", "must_move"):
        assert np.array_equal(getattr(m1, f).numpy(),
                              np.asarray(getattr(rm, f))), f
    for f in AGGREGATES[:-1]:
        a, b = getattr(m1, f).numpy(), np.asarray(getattr(rm, f))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)
        # a zero keeps the reference's sign: -0.0 + 0.0 is +0.0
        z = b == 0
        assert np.array_equal(np.signbit(a[z]), np.signbit(b[z])), f
        if zeros is not None:
            assert (a[zeros] == 0).all() and not np.signbit(a[zeros]).any()


def auction_case(case: str):
    """Seeded auction inputs for ``case`` → (score, dst, src, p, used,
    kw)."""
    rng = np.random.default_rng(AUCTION_CASES.index(case) + 53)
    N, A, B = (2048, 8, 300) if case == "n_2048" else (128, 8, 24)
    score = np.sort(-rng.exponential(1.0, (N, A)), axis=1).astype(np.float32)
    score[rng.random((N, A)) < 0.1] = np.inf
    dst = rng.integers(0, B, (N, A)).astype(np.int32)
    src = rng.integers(0, B, N).astype(np.int64)
    p = rng.integers(0, N // 2, N).astype(np.int64)
    used = [rng.random(B) < 0.1, rng.random(B) < 0.1, rng.random(N) < 0.05]
    if case == "no_bid":
        score[:] = np.inf
    if case == "ties":
        vals = np.array([-0.0, 0.0, -0.5, -1.0, -2.0], np.float32)
        score = vals[rng.integers(0, 5, (N, A))]
    if case == "one_dst":
        dst[:] = 5
        used[1][5] = False
    if case == "one_src":
        src[:] = 7
        used[0][7] = False
    if case == "fixed_point":
        # half the candidates bid for distinct brokers and partitions and
        # all win in round 1; the rest start on claimed partitions: nothing
        # changes after round 1
        N = 2 * B
        score, dst = score[:N], np.zeros((N, A), np.int32)
        dst[:B] = np.arange(B)[:, None]
        dst[B:] = rng.integers(0, B, (B, A))
        score[:B, 0] = -1.0
        src = np.concatenate([rng.permutation(B),
                              rng.integers(0, B, B)]).astype(np.int64)
        p = np.arange(N, dtype=np.int64)
        used = [np.zeros(B, bool), np.zeros(B, bool), np.zeros(N, bool)]
        used[2][B:] = True
    kw = dict(tol=-1e-4, B=B, P=N, rounds=8)
    return score, dst, src, p, used, kw


@pytest.mark.parametrize("case", AUCTION_CASES)
def test_auction_cases_match_reference(case):
    score, dst, src, p, used, kw = auction_case(case)
    ref = T._match_batch(jnp.asarray(score), jnp.asarray(dst),
                         jnp.asarray(src), jnp.asarray(p),
                         init_used=tuple(jnp.asarray(u) for u in used), **kw)
    before = SK.match_batch.launches
    got = SK.match_batch(as_t(score), as_t(dst), as_t(src), as_t(p),
                         init_used=tuple(as_t(u) for u in used), **kw)
    assert SK.match_batch.launches == before      # CPU tensors: plain twin
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a).view(np.int32)
                              if np.asarray(a).dtype == np.float32
                              else np.asarray(a),
                              b.numpy().view(np.int32)
                              if b.dtype == torch.float32 else b.numpy())
    wins = int(got[0].sum())
    if case == "no_bid":
        assert wins == 0
    elif case in ("one_dst", "one_src"):
        assert 1 <= wins <= kw["rounds"]
    else:
        assert wins > 0
    if case == "fixed_point":
        one = T._match_batch(jnp.asarray(score), jnp.asarray(dst),
                             jnp.asarray(src), jnp.asarray(p),
                             init_used=tuple(jnp.asarray(u) for u in used),
                             **dict(kw, rounds=1))
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(one, ref))
        assert wins == kw["B"]
    if case == "n_2048":
        assert score.shape[0] > 1024

"""K7's wrapper (the step's compaction, B6) and K5's cohort form on the
CPU, against jnp transcripts of the reference's step body.

The reference has no function for the compaction: it is inline in the
step of ``_cached_scan_fn`` (``cruise_control_tpu/analyzer/
tpu_optimizer.py:1202-1309``), so :func:`ref_compaction` below copies
those lines in jnp — the key sort (``sort_key_val`` :1206), the candidate
gathers, ``leader_now_q`` (:1238), ``move_vec``, ``order_pc`` (:1293),
``rep`` and ``fminp`` (:1305) — and :func:`ref_footprint` copies the
cohort's footprint before the auction (:1322-1334).  On CPU tensors the
wrappers run their plain twins, the versions the card's kernels are held
to in ``chip_smoke.py``.  The keys are tie-rich, with -0.0, +0.0 and
+inf.  Every output matches exactly: the two sides do the same f32
operations on the same values."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu.ops.grid import gather_pload as ref_gather_pload
from cruise_control_tpu_torch.analyzer import compact_kernel as K7
from cruise_control_tpu_torch.analyzer import step_kernels as SK
from test_torch_step_kernels import as_t


def ref_compaction(m, q_scores, q_rows, bl, row_scores, best_d, dest_pool,
                   kp, ks, sb, C, tol):
    """jnp transcript of tpu_optimizer.py:1202-1309."""
    bl_score, bl_p, bl_s, bl_dst = bl
    Q, B = q_rows.shape
    K, R = row_scores.shape
    NROW = (Q + 1) * B
    rows_q = q_rows.reshape(-1)
    valid_q = rows_q < K
    mrow = jnp.clip(rows_q, 0, K - 1)
    is_move_row = jnp.arange(NROW) < Q * B
    key_all = jnp.concatenate([q_scores.reshape(-1), bl_score])
    _, crow_all = jax.lax.sort_key_val(
        key_all, jnp.arange(NROW, dtype=jnp.int32))
    crow = crow_all[:C]
    is_move_row = is_move_row[crow]
    mr_c = mrow[jnp.clip(crow, 0, Q * B - 1)]
    valid_c = valid_q[jnp.clip(crow, 0, Q * B - 1)]
    lrow_c = jnp.clip(crow - Q * B, 0, B - 1)
    imr = is_move_row[:, None]
    cand_score = jnp.where(
        imr,
        jnp.where(valid_c[:, None], row_scores[mr_c], jnp.inf),
        jnp.concatenate(
            [bl_score[lrow_c][:, None],
             jnp.full((C, R - 1), jnp.inf, row_scores.dtype)], axis=1),
    )
    bd_c = best_d[mr_c]
    move_dst = jnp.where(bd_c >= 0, dest_pool[jnp.clip(bd_c, 0)], -1)
    cand_dst = jnp.where(imr, move_dst, bl_dst[lrow_c][:, None])
    cand_src = jnp.where(is_move_row, sb[mr_c], lrow_c)
    cand_p = jnp.where(is_move_row, kp[mr_c], bl_p[lrow_c])
    cand_s = jnp.where(is_move_row, ks[mr_c], bl_s[lrow_c])
    leader_now_q = m.leader_slot[cand_p] == cand_s
    lead_c, fol_c, _excl_c, leadc_c, folc_c = ref_gather_pload(m, cand_p)
    ml = jnp.where((leader_now_q[:, None] & imr), lead_c, fol_c)
    ml = jnp.where(imr, ml, 0.0)
    move_vec = jnp.concatenate([
        ml, jnp.where(is_move_row, 1.0, 0.0)[:, None],
        jnp.where(is_move_row, lead_c[:, Resource.NW_OUT], 0.0)[:, None],
    ], axis=1)
    if m.leader_cload is not None:
        mlc = jnp.where((leader_now_q[:, None] & imr), leadc_c, folc_c)
        move_vec = jnp.concatenate([move_vec, jnp.where(imr, mlc, 0.0)],
                                   axis=1)
    qualified = is_move_row & ~leader_now_q & valid_c
    ci = jnp.arange(C, dtype=jnp.int32)
    order_pc = jnp.argsort(cand_p)
    sorted_p = cand_p[order_pc]
    firstp = jnp.concatenate([jnp.ones(1, bool), sorted_p[1:] != sorted_p[:-1]])
    start_pos = jax.lax.cummax(jnp.where(firstp, ci, -1))
    rep = jnp.zeros(C, jnp.int32).at[order_pc].set(order_pc[start_pos])
    improving = cand_score[:, 0] < tol
    qual = qualified & improving
    fminp = jnp.full(C, C, jnp.int32).at[rep].min(jnp.where(qual, ci, C))
    qual = qual & (ci == fminp[rep])
    return (is_move_row, cand_score, cand_dst, cand_src, cand_p, cand_s,
            move_vec, qual, rep, improving, jnp.clip(cand_dst[:, 0], 0))


def ref_footprint(acc, cand_dst, cand_src, rep, B, C):
    """jnp transcript of tpu_optimizer.py:1322-1326 (``used0``)."""
    d0 = jnp.clip(cand_dst[:, 0], 0)
    return (jnp.zeros(B, bool).at[jnp.clip(cand_src, 0)].max(acc),
            jnp.zeros(B, bool).at[d0].max(acc),
            jnp.zeros(C, bool).at[rep].max(acc))


def compaction_inputs(seed, cload, Q=4, B=60, K=200, R=8, P=150, S=3):
    """Tie-rich seeded inputs: scores drawn from a few values with -0.0,
    +0.0 and +inf, a fifth of the move rows invalid (index K)."""
    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32
    pick = np.array([-3.0, -1.0, -0.0, 0.0, 2.5, np.inf], f32)
    W = 4 * NUM_RESOURCES + 1 if cload else 2 * NUM_RESOURCES + 1
    pload = rng.random((P, W)).astype(f32)
    pload[:, 2 * NUM_RESOURCES] = rng.random(P) < 0.2
    vals = np.sort(rng.choice(pick[:5], (K, R)), axis=1)
    vals[rng.random((K, R)) < 0.2] = np.inf
    return dict(
        leader_slot=rng.integers(0, S, P).astype(i32), pload=pload,
        q_scores=rng.choice(pick, (Q, B)),
        q_rows=np.where(rng.random((Q, B)) < 0.2, K,
                        rng.integers(0, K, (Q, B))).astype(i32),
        bl=(rng.choice(pick[1:], B), rng.integers(0, P, B).astype(i32),
            rng.integers(0, S, B).astype(i32),
            rng.integers(0, B, B).astype(i32)),
        src_term=rng.choice(np.array([-1.5, 0.0, 4.0], f32), K),
        vals=vals, best_d=rng.integers(-1, 12, (K, R)).astype(i32),
        dest_pool=rng.integers(0, B, 12).astype(i32),
        kp=rng.integers(0, P, K).astype(i32),
        ks=rng.integers(0, S, K).astype(i32),
        sb=rng.integers(0, B, K).astype(i32))


@pytest.mark.parametrize("seed,cload,C", [
    (1, False, 64), (2, True, 200), (3, False, 300),
], ids=["C64", "percentile-C200", "C=NROW"])
def test_compact_rows_matches_reference_transcript(seed, cload, C):
    x = compaction_inputs(seed, cload)
    NR = NUM_RESOURCES
    lc = (x["pload"][:, 2 * NR + 1:3 * NR + 1] if cload else None)

    def model(conv):
        return types.SimpleNamespace(
            leader_slot=conv(x["leader_slot"]), pload=conv(x["pload"]),
            leader_cload=None if lc is None else conv(lc))

    keys = ("q_scores", "q_rows")
    tail = ("best_d", "dest_pool", "kp", "ks", "sb")
    st, vals = x["src_term"], x["vals"]
    row_scores = jnp.asarray(st)[:, None] + (jnp.asarray(vals)
                                             - jnp.asarray(st)[:, None])
    ref = ref_compaction(
        model(jnp.asarray), *(jnp.asarray(x[k]) for k in keys),
        tuple(jnp.asarray(b) for b in x["bl"]), row_scores,
        *(jnp.asarray(x[k]) for k in tail), C, -1e-4)
    before = K7.compact_rows.launches
    got = K7.compact_rows(
        model(as_t), *(as_t(x[k]) for k in keys),
        tuple(as_t(b) for b in x["bl"]), as_t(st), as_t(vals),
        *(as_t(x[k]) for k in tail), C, -1e-4)
    assert K7.compact_rows.launches == before      # CPU tensors: plain twin
    for name, a, b in zip(K7.Compacted._fields, got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    # the kept rows carry ties, both zeros and +inf, and more than one row
    # per partition
    key = np.concatenate([x["q_scores"].reshape(-1), x["bl"][0]])
    kept = np.sort(key)[:C]
    assert len(np.unique(kept)) < C and np.isinf(key).any()
    assert np.signbit(key[key == 0]).any() and (~np.signbit(key[key == 0])).any()
    assert len(np.unique(got.cand_p.numpy())) < C


@pytest.mark.parametrize("caps", [(1, 1), (2, 2)], ids=["disjoint",
                                                        "track_bars"])
def test_match_batch_from_cohort_matches_init_used_form(caps):
    """K5 from the cohort's rows (``acc``) equals the reference auction
    started from the reference's footprint with the cohort's scores masked,
    and the older ``init_used`` form of the same call."""
    rng = np.random.default_rng(caps[0] + 40)
    N, A, B = 128, 8, 24
    score = np.sort(-rng.exponential(1.0, (N, A)), axis=1).astype(np.float32)
    score[rng.random((N, A)) < 0.1] = np.inf
    dst = rng.integers(-1, B, (N, A)).astype(np.int32)
    src = rng.integers(0, B, N).astype(np.int64)
    rep = np.minimum(np.arange(N), rng.integers(0, N, N)).astype(np.int64)
    acc = rng.random(N) < 0.15
    kw = dict(tol=-1e-4, B=B, P=N, dest_cap=caps[0], src_cap=caps[1],
              stack_ratio=0.5, rounds=0)
    used_r = ref_footprint(jnp.asarray(acc), jnp.asarray(dst),
                           jnp.asarray(src), jnp.asarray(rep), B, N)
    ref = T._match_batch(
        jnp.where(jnp.asarray(acc)[:, None], jnp.inf, jnp.asarray(score)),
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(rep),
        init_used=used_r, **kw)
    before = SK.match_batch.launches
    got = SK.match_batch(as_t(score), as_t(dst), as_t(src), as_t(rep),
                         acc=as_t(acc), **kw)
    used = SK._cohort_footprint(as_t(acc), as_t(dst), as_t(src), as_t(rep),
                                B, N)
    old = SK.match_batch(as_t(score).masked_fill(as_t(acc)[:, None], np.inf),
                         as_t(dst), as_t(src), as_t(rep), init_used=used,
                         **kw)
    assert SK.match_batch.launches == before
    for u, ur in zip(used, used_r):
        assert np.array_equal(u.numpy(), np.asarray(ur))
    assert np.asarray(ref[0]).any() and used[0].any()
    for a, b, c in zip(got, old, ref):
        assert torch.equal(a, b)
        assert np.array_equal(a.numpy(), np.asarray(c))
    with pytest.raises(ValueError, match="init_used or acc"):
        SK.match_batch(as_t(score), as_t(dst), as_t(src), as_t(rep),
                       acc=as_t(acc), init_used=used, **kw)

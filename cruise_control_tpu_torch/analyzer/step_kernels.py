"""The search step's selection chains: their plain twins and the
hand-written CUDA kernels that replace them on the card.

* K3 :func:`per_src_top` (``csrc/per_src_top.cu``): the best leadership
  transfer per leader broker and the top-Q move rows per source broker,
  from the rows' slots and scores — plain twins
  :func:`per_src_top_inputs_plain`, then :func:`_reduce_leadership_per_src`
  and :func:`_topq_rows_per_src`.
* K4 :func:`budget_accept` (``csrc/budget_accept.cu``): the cohort's
  water-filling budgets and its two rounds of segmented-prefix acceptance
  — plain twins :func:`_cohort_budgets` (:func:`_step_budgets`) and
  :func:`_budget_accept`.
* K5 :func:`match_batch` (``csrc/match_batch.cu``): the disjoint auction,
  started from the budgeted cohort's footprint — plain twins
  :func:`_match_batch` and :func:`_cohort_footprint`.

The plain twins keep the reference's names (``tpu_optimizer.py``) and are
the specification the CPU tests hold against the JAX reference; the
search imports them from here (``analyzer/cuda_optimizer.py``).  Each
wrapper runs its plain twin for tensors that lie on the CPU, and for CUDA
tensors launches its kernel or raises; there is no fallback.  Each counts
its launches in ``<wrapper>.launches``.  The kernels are built with
``nvcc`` at first use (:mod:`ops.kernels`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.segment import (
    column_sum as _colsum,
    segment_excl_prefix_sorted,
    segment_sum,
)

#: brokers K3 takes (``csrc/per_src_top.cu: MAX_B``: its per-broker
#: counts stay in shared memory)
PER_SRC_TOP_MAX_B = 50_000
#: alternates K5 takes (``csrc/match_batch.cu``: a candidate's pointer
#: shares a word with its round flags)
MATCH_BATCH_MAX_A = 1 << 26
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_INF = float("inf")


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving map K3, K5, K7 and K8 key f32 scores with
    (``csrc/step_common.cuh: ord32``), in torch:
    int64 in [0, 2^32) with ``order_key(a) < order_key(b)`` iff ``a < b``
    (-0.0 and +0.0 map alike; +inf above every finite value)."""
    x = torch.where(x == 0, torch.zeros_like(x), x).to(torch.float32)
    u = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)


# ---------------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------------

def _scatter_min(n: int, idx, vals, fill):
    """``out[b] = min(fill, vals[i] for idx[i] == b)`` — exact, so
    deterministic in any order."""
    return torch.full((n,), fill, dtype=vals.dtype, device=vals.device) \
        .scatter_reduce(0, idx.long(), vals, "amin", include_self=True)


def _mark(n: int, idx, flags) -> torch.Tensor:
    """bool [n]: ``out[b]`` = any ``flags[i]`` with ``idx[i] == b``."""
    return torch.zeros(n, dtype=torch.int32, device=flags.device) \
        .index_add_(0, idx.long(), flags.to(torch.int32)) > 0


def _reduce_leadership_per_src(m, lp, lsl, l_scores):
    """Best leadership transfer per current-leader broker → (score [B],
    p [B], s [B], dst broker [B]); +inf score where a broker leads no pool
    entry.  Ties to the lowest pool row."""
    B = m.capacity.shape[0]
    L = lp.shape[0]
    lpl = lp.long()
    lb = torch.gather(m.assignment[lpl], 1,
                      m.leader_slot[lpl].long()[:, None])[:, 0]
    lb_c = lb.clamp_min(0).long()
    seg = _scatter_min(B, lb_c, l_scores, _INF)
    ar = torch.arange(L, device=lp.device)
    row = _scatter_min(B, lb_c,
                       torch.where(l_scores <= seg[lb_c], ar, L), L)
    ok = row < L
    row_c = row.clamp(0, L - 1)
    score = torch.where(ok, l_scores[row_c], _INF)
    p, s = lp[row_c], lsl[row_c]
    return score, p, s, m.assignment[p.long(), s.long()].clamp_min(0)


_SIGN = 1 << 31
_MASK = (1 << 32) - 1


def _total_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in the f32 total order, -0.0 below +0.0 (the order the
    reference's scatter-min gives tied zeros) and NaN below everything, so
    that a NaN in a minimum still poisons it as the float minimum does."""
    u = x.contiguous().view(torch.int32).long() & _MASK
    k = torch.where(u >= _SIGN, ~u & _MASK, u | _SIGN)
    return torch.where(torch.isnan(x), torch.zeros_like(k), k)


def _from_total_key(k: torch.Tensor) -> torch.Tensor:
    """The f32 a :func:`_total_key` stands for (key 0: a NaN)."""
    u = torch.where(k >= _SIGN, k & (_SIGN - 1), ~k & _MASK)
    return torch.where(u >= _SIGN, u - (1 << 32), u).to(torch.int32) \
        .view(torch.float32)


def _topq_rows_per_src(sb, row_best, B: int, Q: int):
    """Top-Q candidate rows per source broker by score → (rows int32
    [Q, B], scores f32 [Q, B]): the q-th best row index of each broker (K
    where a broker has fewer than q+1 rows) and the minimum of its rows
    still in play (inf where invalid).  Q sequential scatter-min passes,
    ties to the lowest row.  The minimum is taken on :func:`_total_key`:
    a zero is -0.0 when any tied zero row in play holds -0.0, as the
    reference's scatter-min writes it, on the CPU and on CUDA alike."""
    K = sb.shape[0]
    sbl = sb.long()
    cur = row_best
    idx = torch.arange(K, device=sb.device)
    inf_key = int(_total_key(torch.tensor([_INF]))[0])
    outs, out_scores = [], []
    for _ in range(Q):
        seg = _from_total_key(_scatter_min(B, sbl, _total_key(cur), inf_key))
        r = _scatter_min(
            B, sbl,
            torch.where(torch.isfinite(cur) & (cur <= seg[sbl]), idx, K), K,
        )
        outs.append(r)
        out_scores.append(torch.where(r < K, seg, _INF))
        # knock the chosen rows out for the next pass; r == K lands in a
        # dump slot past the end (the reference's mode="drop")
        ext = torch.cat([cur, cur.new_full((1,), _INF)])
        ext[r] = _INF
        cur = ext[:K]
    return torch.stack(outs).to(torch.int32), torch.stack(out_scores)


def _step_budgets(m, ca):
    """Per-broker move budgets for the water-filling cohort → (src_budget,
    dst_budget), both f32 [B, R+2] over (resources..., replica count,
    potential NW-out) — plus R capacity-headroom dims with percentile
    loads.  See the reference's ``_step_budgets`` for the derivation.

    The column sums are exact (:func:`_colsum`), so kernel K4 computes the
    same budgets to the bit."""
    B = m.capacity.shape[0]
    alive_cap = torch.where(m.alive[:, None], m.capacity, 0.0)
    cap_sum = _colsum(alive_cap)
    avg_u = _colsum(m.broker_load) / torch.clamp_min(cap_sum, 1e-9)
    target = avg_u[None, :] * m.capacity
    pivot = avg_u * cap_sum / torch.clamp_min(
        _colsum(alive_cap * alive_cap), 1e-9)
    quad_target = pivot[None, :] * m.capacity * m.capacity
    src_res = torch.clamp_min(
        m.broker_load - torch.maximum(target, quad_target), 0.0)
    dst_res = torch.where(
        m.dest_ok[:, None],
        torch.clamp_min(torch.minimum(target, quad_target) - m.broker_load,
                        0.0),
        0.0,
    )
    src_rc = torch.clamp_min(m.rcount - ca["avg_rcount"], 0.0)
    dst_rc = torch.clamp_min(ca["avg_rcount"] - m.rcount, 0.0)
    thr_pot = (ca["cap_threshold"][Resource.NW_OUT]
               * m.capacity[:, Resource.NW_OUT])
    above = m.pot_nwout >= thr_pot
    dst_pot = torch.where(above, _INF, thr_pot - m.pot_nwout)
    src_pot = torch.where(above, m.pot_nwout - thr_pot, _INF)
    src_budget = torch.cat([src_res, src_rc[:, None], src_pot[:, None]], 1)
    dst_budget = torch.cat([dst_res, dst_rc[:, None], dst_pot[:, None]], 1)
    if m.broker_cload is not None:
        cap_head = torch.clamp_min(
            ca["cap_threshold"][None, :] * m.capacity - m.broker_cload, 0.0)
        src_budget = torch.cat(
            [src_budget, torch.full((B, m.capacity.shape[1]), _INF,
                                    device=src_budget.device)], 1)
        dst_budget = torch.cat([dst_budget, cap_head], 1)
    return src_budget, dst_budget


def _cohort_budgets(m, ca, slack: float):
    """The budgets the cohort starts from: :func:`_step_budgets` with the
    soft dims (resources, replica count, potential NW-out) scaled by
    ``slack``; capacity-headroom dims stay exact."""
    src_budget, dst_budget = _step_budgets(m, ca)
    if slack != 1.0:
        soft = NUM_RESOURCES + 2
        src_budget = src_budget.clone()
        dst_budget = dst_budget.clone()
        src_budget[:, :soft] *= slack
        dst_budget[:, :soft] *= slack
    return src_budget, dst_budget


def _seg_excl_prefix(ids, vec, eligible):
    """Per-row EXCLUSIVE prefix sum of ``vec`` within each id segment, rows
    in caller (score) order.  ids [C], vec [C, NB], eligible [C] bool →
    [C, NB]; exact integer scan (ops.segment)."""
    C = ids.shape[0]
    rank = torch.arange(C, device=ids.device)
    order = torch.argsort(ids.long() * C + rank, stable=True)
    sv = torch.where(eligible[:, None], vec, 0.0)[order]
    sid = ids[order]
    first = torch.ones(C, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    out = torch.zeros_like(vec)
    out[order] = segment_excl_prefix_sorted(sv, first)
    return out


def _seg_prefix_fits(ids, vec, budget, eligible):
    """Budget acceptance by segmented prefix sums, in caller row order: a
    row fits iff every dim of its inclusive per-id prefix fits the id's
    budget (conservative: a rejected eligible row still counts in later
    rows' prefixes).  → fits [C] bool (False wherever not eligible)."""
    ev = torch.where(eligible[:, None], vec, 0.0)
    incl = _seg_excl_prefix(ids, vec, eligible) + ev
    ok = (incl <= budget[ids.long()] + 1e-9).all(dim=1)
    return ok & eligible


def _budget_accept(dst_ids, src_ids, vec, dst_budget, src_budget, eligible,
                   rounds: int = 2):
    """Budgeted cohort acceptance across both endpoints, in caller order
    (destination-prefix filter, then source-prefix filter over its
    survivors; accepted rows draw both budgets down and rows that no longer
    fit on their own drop out)."""
    acc = torch.zeros_like(eligible)
    elig = eligible
    dl, sl = dst_ids.long(), src_ids.long()
    for _ in range(rounds):
        dok = _seg_prefix_fits(dst_ids, vec, dst_budget, elig)
        a = _seg_prefix_fits(src_ids, vec, src_budget, dok)
        acc = acc | a
        dec = torch.where(a[:, None], vec, 0.0)
        dst_budget = dst_budget - segment_sum(dec, dl, dst_budget.shape[0])
        src_budget = src_budget - segment_sum(dec, sl, src_budget.shape[0])
        elig = (
            elig & ~a
            & (vec <= dst_budget[dl] + 1e-9).all(dim=1)
            & (vec <= src_budget[sl] + 1e-9).all(dim=1)
        )
    return acc


def _match_batch(cand_score, cand_dst, cand_src, cand_p, tol: float, B: int,
                 P: int, init_used=None, dest_cap: int = 1,
                 src_cap: int = 1, stack_ratio: float = 0.5,
                 rounds: int = 0):
    """Parallel auction matching candidates to disjoint broker/partition
    sets (see the reference's ``_match_batch``).  Per round every unmatched
    candidate proposes its current alternate; the lowest score per
    destination wins, ties to the lowest candidate index on all three
    conflict tables at once; a loser advances only once its destination is
    full.  All rounds run: a round that changes nothing is a fixed point
    the remaining rounds repeat exactly, so the result equals the
    reference's early exit without a host round-trip per round.

    cand_score/cand_dst [N, A]; cand_src/cand_p [N] (conflict ids < P).
    → (take [N] bool, win_score [N], win_dst [N])."""
    N, A = cand_score.shape
    dev = cand_score.device
    idx_n = torch.arange(N, device=dev)
    p_c = cand_p.clamp_min(0).long()
    if init_used is None:
        init_used = (
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros(P, dtype=torch.bool, device=dev),
        )
    used_src, used_dst, used_p = init_used
    # packed occupancy: [0, B) dst, [B, 2B) src, [2B, 2B+P) partitions
    occ = torch.cat([
        used_dst.long() * dest_cap, used_src.long() * src_cap, used_p.long(),
    ])
    ids_src = B + cand_src.long()
    ids_p = 2 * B + p_c
    track_bars = dest_cap > 1 or src_cap > 1
    take = torch.zeros(N, dtype=torch.bool, device=dev)
    ptr = torch.zeros(N, dtype=torch.long, device=dev)
    win_score = torch.full((N,), _INF, dtype=cand_score.dtype, device=dev)
    win_dst = torch.zeros(N, dtype=torch.long, device=dev)
    dbest = torch.zeros(B, dtype=cand_score.dtype, device=dev)
    sbest = torch.zeros(B, dtype=cand_score.dtype, device=dev)
    for _ in range(rounds or A):
        pa = ptr.clamp(0, A - 1)
        cur_s = cand_score[idx_n, pa]
        cur_d = cand_dst[idx_n, pa].clamp_min(0).long()
        ids3 = torch.cat([cur_d, ids_src, ids_p])
        occ_d, occ_s, occ_p = occ[ids3].split(N)
        active = (
            ~take & (ptr < A) & (cur_s < tol) & (occ_s < src_cap)
            & (occ_p < 1)
        )
        prop = active & (occ_d < dest_cap)
        if track_bars:
            active = active & ((occ_s == 0)
                               | (cur_s <= stack_ratio * sbest[ids_src - B]))
            prop = active & (occ_d < dest_cap) & (
                (occ_d == 0) | (cur_s <= stack_ratio * dbest[cur_d]))
        best = _scatter_min(B, cur_d, torch.where(prop, cur_s, _INF), _INF)
        win = prop & (cur_s <= best[cur_d])
        widx = torch.where(win, idx_n, N)
        fmin = _scatter_min(2 * B + P, ids3, torch.cat([widx, widx, widx]), N)
        f_d, f_s, f_p = fmin[ids3].split(N)
        win = win & (idx_n == f_d) & (idx_n == f_s) & (idx_n == f_p)
        take = take | win
        if track_bars:
            dbest = torch.where(
                occ[:B] == 0,
                _scatter_min(B, cur_d, torch.where(win, cur_s, 0.0), 0.0),
                dbest,
            )
            sbest = torch.where(
                occ[B:2 * B] == 0,
                _scatter_min(B, ids_src - B, torch.where(win, cur_s, 0.0),
                             0.0),
                sbest,
            )
        wi = win.long()
        occ = occ.index_add(0, ids3, torch.cat([wi, wi, wi]))
        win_score = torch.where(win, cur_s, win_score)
        win_dst = torch.where(win, cur_d, win_dst)
        blocked = occ[cur_d] >= dest_cap
        if track_bars:
            blocked = blocked | (
                (occ[cur_d] > 0) & (cur_s > stack_ratio * dbest[cur_d]))
        ptr = ptr + (active & ~win & blocked).long()
    return take, win_score, win_dst


# ---------------------------------------------------------------------------------
# K3: per-source-broker reductions
# ---------------------------------------------------------------------------------

def per_src_top_plain(m, lp, lsl, l_scores, sb, row_best, B: int, Q: int):
    """Plain twin of K3 on the rows' source brokers and best scores (see
    :func:`per_src_top_inputs_plain`)."""
    return (_reduce_leadership_per_src(m, lp, lsl, l_scores),
            _topq_rows_per_src(sb, row_best, B, Q))


def per_src_top_inputs_plain(m, slot, src_term, vals,
                             dest_terms: bool = False):
    """The inputs K3 reads for itself → (sb int32 [K], row_best f32 [K]):
    each move row's source broker, the broker in its flat slot ``slot``
    (0 for an empty one), and its best score — its top destination term
    re-added to its source term, ``src_term + (vals[:, 0] - src_term)``,
    as the reference does (bit-parity of the row scores); with
    ``dest_terms`` (``vals`` the incremental rescore's carried destination
    terms) ``src_term + vals[:, 0]``."""
    sb = m.assignment.view(-1)[slot].clamp_min(0)
    v0 = vals[:, 0]
    return sb, (src_term + v0 if dest_terms else src_term + (v0 - src_term))


#: K3's device phases by the phase stamps that close them
#: (``csrc/per_src_top.cu``, built with ``-DCC_PHASE_STAMPS`` by
#: ``tools/time_kernels.py``), as block 0 (the first rows block) sees
#: them: its share of the gathers, the grid barrier, then its range's
#: counts, scan, scatter and picks; then, from the first leadership
#: block's own stamp after the barrier, its reduction and write-out.
#: None names the span between the two blocks' stamps.
PER_SRC_TOP_PHASES = ("gather", "grid_sync", "rows_count", "rows_scan",
                      "rows_scatter", "rows_pick", None, "lead_reduce",
                      "lead_out")


def per_src_top_attrs(K: int, L: int, B: int) -> dict:
    """The built K3 at K rows, L candidates and B brokers, as the card
    reports it (:func:`ops.kernels.attrs`).  Needs the card."""
    lib = kernels.bind("per_src_top", "per_src_top_attrs",
                       [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    return kernels.attrs("per_src_top", lib.per_src_top_attrs, K, L, B)


def per_src_top_scratch_bytes(K: int, L: int, B: int) -> int:
    """Bytes of device scratch K3 takes at K rows, L candidates and B
    brokers: the gathered keys and brokers, and the keys that do not fit
    in the card's shared memory.  Needs the card."""
    lib = kernels.bind("per_src_top", "per_src_top_scratch_bytes",
                       [_I, _I, _I])
    lib.per_src_top_scratch_bytes.restype = ctypes.c_longlong
    nbytes = lib.per_src_top_scratch_bytes(K, L, B)
    if nbytes < 0:
        raise RuntimeError("per_src_top: the card's shared memory could "
                           "not be read")
    return nbytes


def per_src_top(m, lp, lsl, l_scores, slot, src_term, vals, B: int, Q: int,
                dest_terms: bool = False, row_best=None):
    """→ ((score f32, p, s, dst int32) [B] of the best leadership transfer
    per leader broker, (rows int32 [Q, B], scores f32 [Q, B]) of the top-Q
    move rows per source broker, sb int32 [K]) — the plain twins
    :func:`_reduce_leadership_per_src` and :func:`_topq_rows_per_src` on
    :func:`per_src_top_inputs_plain`'s (sb, row_best), and that ``sb``
    (K7 takes it).

    ``slot`` int64 [K] are the move rows' flat slots, ``src_term`` their
    source terms (may be a strided 1-D view: the source term column of
    K2's table) and ``vals`` f32 [K, R] their top-R destination scores, or
    with ``dest_terms`` the carried destination terms.  ``row_best``, if
    given, is an f32 [K] tensor the rows' best scores are written into
    (what the kernel ranks; for checks)."""
    if kernels.on_cpu(l_scores):
        sb, rb = per_src_top_inputs_plain(m, slot, src_term, vals,
                                          dest_terms)
        if row_best is not None:
            row_best.copy_(rb)
        return (*per_src_top_plain(m, lp, lsl, l_scores, sb, rb, B, Q), sb)
    dev = l_scores.device
    P, S = m.assignment.shape
    L, K = lp.shape[0], slot.shape[0]
    R = vals.shape[1] if vals.dim() == 2 else -1
    i32, f32 = torch.int32, torch.float32
    chk = functools.partial(kernels.check, "per_src_top", device=dev)
    chk("lp", lp, i32, (L,))
    chk("lsl", lsl, i32, (L,))
    chk("l_scores", l_scores, f32, (L,))
    chk("slot", slot, torch.int64, (K,))
    chk("vals", vals, f32, (K, R))
    chk("assignment", m.assignment, i32, (P, S))
    chk("leader_slot", m.leader_slot, i32, (P,))
    if row_best is not None:
        chk("row_best", row_best, f32, (K,))
    if src_term.dtype != f32 or tuple(src_term.shape) != (K,) \
            or src_term.device != dev or src_term.stride(0) < 1:
        raise ValueError("per_src_top: src_term must be a 1-D f32 tensor "
                         f"of {K} entries on {dev} with a positive stride")
    if L < 1 or R < 1 or B != m.capacity.shape[0] or Q < 0 \
            or K >= 1 << 30 or B > PER_SRC_TOP_MAX_B:
        raise ValueError(f"per_src_top: L={L}, K={K}, R={R}, B={B}, Q={Q} "
                         "out of range")
    out = (torch.empty(B, dtype=f32, device=dev),
           *(torch.empty(B, dtype=i32, device=dev) for _ in range(3)))
    rows = torch.empty((Q, B), dtype=i32, device=dev)
    scores = torch.empty((Q, B), dtype=f32, device=dev)
    sb = torch.empty(K, dtype=i32, device=dev)
    lib = kernels.bind("per_src_top", "per_src_top_launch",
                       [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P]
                       + [_I] * 5 + [_P] * 10)
    scratch = torch.empty(-(-per_src_top_scratch_bytes(K, L, B) // 8),
                          dtype=torch.int64, device=dev)
    err = lib.per_src_top_launch(
        lp.data_ptr(), lsl.data_ptr(), l_scores.data_ptr(), L,
        m.assignment.data_ptr(), m.leader_slot.data_ptr(), S,
        slot.data_ptr(), src_term.data_ptr(), src_term.stride(0),
        vals.data_ptr(), R, int(dest_terms), K, B, Q,
        *(t.data_ptr() for t in out), rows.data_ptr(), scores.data_ptr(),
        sb.data_ptr(), None if row_best is None else row_best.data_ptr(),
        scratch.data_ptr(), kernels.stream(dev),
    )
    kernels.launched("per_src_top", err)
    per_src_top.launches += 1
    return out, (rows, scores), sb


per_src_top.launches = 0


# ---------------------------------------------------------------------------------
# K4: budgeted cohort
# ---------------------------------------------------------------------------------

def budget_accept_plain(m, ca, dst_ids, src_ids, vec, eligible,
                        slack: float, rounds: int = 2):
    """Plain twin of K4."""
    src_b, dst_b = _cohort_budgets(m, ca, slack)
    return (_budget_accept(dst_ids, src_ids, vec, dst_b, src_b, eligible,
                             rounds), src_b, dst_b)


def budget_accept(m, ca, dst_ids, src_ids, vec, eligible, slack: float,
                  rounds: int = 2):
    """The budgeted cohort → (accepted bool [C], src_budget, dst_budget
    f32 [B, NB] the cohort started from) — the plain twins
    :func:`_cohort_budgets` (:func:`_step_budgets` with ``slack``) and
    :func:`_budget_accept`."""
    if kernels.on_cpu(vec):
        return budget_accept_plain(m, ca, dst_ids, src_ids, vec, eligible,
                                   slack, rounds)
    dev = vec.device
    B, R = m.capacity.shape
    Cn = vec.shape[0]
    has_cap = m.broker_cload is not None
    NB = (2 * R + 2) if has_cap else (R + 2)
    f32, b8 = torch.float32, torch.bool
    chk = functools.partial(kernels.check, "budget_accept", device=dev)
    if R != NUM_RESOURCES:
        raise ValueError(f"budget_accept: {R} resources, the kernel takes "
                         f"{NUM_RESOURCES}")
    for name, x, dt, shape in (
        ("capacity", m.capacity, f32, (B, R)),
        ("broker_load", m.broker_load, f32, (B, R)),
        ("rcount", m.rcount, f32, (B,)),
        ("pot_nwout", m.pot_nwout, f32, (B,)),
        ("alive", m.alive, b8, (B,)),
        ("dest_ok", m.dest_ok, b8, (B,)),
        ("cap_threshold", ca["cap_threshold"], f32, (R,)),
        ("avg_rcount", ca["avg_rcount"], f32, ()),
        ("dst_ids", dst_ids, torch.int32, (Cn,)),
        ("src_ids", src_ids, torch.int64, (Cn,)),
        ("vec", vec, f32, (Cn, NB)),
        ("eligible", eligible, b8, (Cn,)),
    ):
        chk(name, x, dt, shape)
    if has_cap:
        chk("broker_cload", m.broker_cload, f32, (B, R))
    acc = torch.empty(Cn, dtype=b8, device=dev)
    src_b = torch.empty((B, NB), dtype=f32, device=dev)
    dst_b = torch.empty((B, NB), dtype=f32, device=dev)
    work = torch.empty((2, B, NB), dtype=f32, device=dev)
    lib = kernels.bind("budget_accept", "budget_accept_launch",
                       [_P] * 9 + [_F, _I] + [_P] * 4 + [_I] * 3
                       + [_P] * 6)
    lib.budget_accept_scratch_bytes.restype = ctypes.c_longlong
    # the sort keys and the rows' flags: in shared memory where they fit
    # (0 bytes), else in a device scratch
    nbytes = lib.budget_accept_scratch_bytes(Cn, NB)
    scratch = None if nbytes == 0 else torch.empty(
        -(-nbytes // 8), dtype=torch.int64, device=dev)
    err = lib.budget_accept_launch(
        m.capacity.data_ptr(), m.broker_load.data_ptr(),
        m.broker_cload.data_ptr() if has_cap else None,
        m.rcount.data_ptr(), m.pot_nwout.data_ptr(), m.alive.data_ptr(),
        m.dest_ok.data_ptr(), ca["cap_threshold"].data_ptr(),
        ca["avg_rcount"].data_ptr(), float(slack), B, dst_ids.data_ptr(),
        src_ids.data_ptr(), vec.data_ptr(), eligible.data_ptr(), Cn, NB,
        rounds, acc.data_ptr(), src_b.data_ptr(), dst_b.data_ptr(),
        work.data_ptr(), None if scratch is None else scratch.data_ptr(),
        kernels.stream(dev),
    )
    kernels.launched("budget_accept", err)
    budget_accept.launches += 1
    return acc, src_b, dst_b


budget_accept.launches = 0


def budget_accept_phases(rounds: int = 2) -> tuple:
    """K4's device phases in the order its phase stamps close them
    (``csrc/budget_accept.cu``, built with ``-DCC_PHASE_STAMPS`` by
    ``tools/time_kernels.py``): the budgets' column maxima, their sums and
    the broker rows (with the rows' vectors staged), the two sorts (with
    the starting budgets copied out and the rows' flags), then per round
    the destination and source prefix filters, the draw-down and the
    eligibility update."""
    return ("budget_max", "budget_sums", "budget_rows", "sorts") + tuple(
        f"{p}{r}" for r in range(rounds)
        for p in ("dst_fits", "src_fits", "draw", "elig"))


def budget_accept_attrs(B: int, C: int, NB: int) -> dict:
    """The built K4 at B brokers, C rows and NB budget dims, as the card
    reports it (:func:`ops.kernels.attrs`).  Needs the card."""
    lib = kernels.bind("budget_accept", "budget_accept_attrs",
                       [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    return kernels.attrs("budget_accept", lib.budget_accept_attrs, B, C,
                         NB)


# ---------------------------------------------------------------------------------
# K5: disjoint auction
# ---------------------------------------------------------------------------------

def _cohort_footprint(acc, cand_dst, cand_src, cand_p, B: int, P: int):
    """The auction's starting occupancy (used_src, used_dst, used_p) from
    the cohort's accepted rows ``acc``: their source brokers, best
    destinations and partition ids (reference step ``:1322-1326``)."""
    return (_mark(B, cand_src.clamp_min(0), acc),
            _mark(B, cand_dst[:, 0].clamp_min(0), acc),
            _mark(P, cand_p, acc))


def match_batch_plain(cand_score, cand_dst, cand_src, cand_p, tol: float,
                      B: int, P: int, init_used=None, dest_cap: int = 1,
                      src_cap: int = 1, stack_ratio: float = 0.5,
                      rounds: int = 0, acc=None):
    """Plain twin of K5: ``_match_batch``; with ``acc`` (the cohort's
    accepted rows) the auction starts from their footprint and their
    scores count as +inf (reference step ``:1322-1334``)."""
    if acc is not None:
        if init_used is not None:
            raise ValueError("match_batch: pass init_used or acc, not both")
        init_used = _cohort_footprint(acc, cand_dst, cand_src, cand_p, B, P)
        cand_score = cand_score.masked_fill(acc[:, None], _INF)
    return _match_batch(cand_score, cand_dst, cand_src, cand_p, tol, B, P,
                        init_used=init_used, dest_cap=dest_cap,
                        src_cap=src_cap, stack_ratio=stack_ratio,
                        rounds=rounds)


def match_batch(cand_score, cand_dst, cand_src, cand_p, tol: float, B: int,
                P: int, init_used=None, dest_cap: int = 1, src_cap: int = 1,
                stack_ratio: float = 0.5, rounds: int = 0, acc=None):
    """The auction of the plain twin :func:`match_batch_plain` (same
    arguments) → (take bool [N], win_score f32 [N], win_dst int64 [N]).
    With ``acc`` (bool [N], the cohort's accepted rows) the kernel builds
    the starting occupancy and the score mask itself."""
    if kernels.on_cpu(cand_score):
        return match_batch_plain(
            cand_score, cand_dst, cand_src, cand_p, tol, B, P,
            init_used=init_used, dest_cap=dest_cap, src_cap=src_cap,
            stack_ratio=stack_ratio, rounds=rounds, acc=acc)
    dev = cand_score.device
    N, A = cand_score.shape
    b8 = torch.bool
    if acc is not None and init_used is not None:
        raise ValueError("match_batch: pass init_used or acc, not both")
    if acc is None and init_used is None:
        init_used = (torch.zeros(B, dtype=b8, device=dev),
                     torch.zeros(B, dtype=b8, device=dev),
                     torch.zeros(P, dtype=b8, device=dev))
    used_src, used_dst, used_p = init_used or (None, None, None)
    chk = functools.partial(kernels.check, "match_batch", device=dev)
    for name, x, dt, shape in (
        ("cand_score", cand_score, torch.float32, (N, A)),
        ("cand_dst", cand_dst, torch.int32, (N, A)),
        ("cand_src", cand_src, torch.int64, (N,)),
        ("cand_p", cand_p, torch.int64, (N,)),
        *((("acc", acc, b8, (N,)),) if acc is not None else (
            ("used_src", used_src, b8, (B,)),
            ("used_dst", used_dst, b8, (B,)),
            ("used_p", used_p, b8, (P,)))),
    ):
        chk(name, x, dt, shape)
    if not 1 <= A <= MATCH_BATCH_MAX_A or B < 1 or P < 1 or dest_cap < 1 \
            or src_cap < 1:
        raise ValueError(f"match_batch: A={A}, B={B}, P={P}, caps "
                         f"({dest_cap}, {src_cap}) out of range (A <= "
                         f"{MATCH_BATCH_MAX_A})")
    take = torch.empty(N, dtype=b8, device=dev)
    win_score = torch.empty(N, dtype=torch.float32, device=dev)
    win_dst = torch.empty(N, dtype=torch.int64, device=dev)
    lib = kernels.bind("match_batch", "match_batch_launch",
                       [_P] * 4 + [_I] * 4 + [_F, _I, _I, _F, _I]
                       + [_P] * 9)
    lib.match_batch_scratch_bytes.restype = ctypes.c_longlong
    # the tables and the candidates' state: in shared memory where they
    # fit (0 bytes), else in a device scratch
    nbytes = lib.match_batch_scratch_bytes(N, A, B, P,
                                           int(dest_cap > 1 or src_cap > 1))
    gws = None if nbytes == 0 else torch.empty(-(-nbytes // 4),
                                               dtype=torch.int32, device=dev)
    err = lib.match_batch_launch(
        cand_score.data_ptr(), cand_dst.data_ptr(), cand_src.data_ptr(),
        cand_p.data_ptr(), N, A, B, P, float(tol), dest_cap, src_cap,
        float(stack_ratio), rounds or A,
        *(None if u is None else u.data_ptr()
          for u in (used_src, used_dst, used_p, acc)),
        take.data_ptr(), win_score.data_ptr(), win_dst.data_ptr(),
        None if gws is None else gws.data_ptr(), kernels.stream(dev),
    )
    kernels.launched("match_batch", err)
    match_batch.launches += 1
    return take, win_score, win_dst


match_batch.launches = 0


def match_batch_phases(rounds: int) -> tuple:
    """K5's device phases in the order its phase stamps close them
    (``csrc/match_batch.cu``, built with ``-DCC_PHASE_STAMPS`` by
    ``tools/time_kernels.py``): the tables' set-up and the first bids,
    then per round the tied best's stakes, the winners, and the losers'
    advance with the next round's bids (none after the last round, and no
    stamps for a round after the auction's fixed point)."""
    return ("init", "propose") + tuple(
        f"{p}{r}" for r in range(rounds)
        for p in ("win", "winners", "advance"))

"""The score-only round: its plain twins and the hand-written CUDA kernels
that replace them on the card.

A round (the reference's ``_cached_round_fn``, ``tpu_optimizer.py:2892``,
its branch with ``mesh=None``) rebuilds the candidate pools from scratch,
scores every candidate against the device model and returns the
``topk_per_round`` best as one packed f32 [5, k] array (score, kind,
partition, slot, destination), which the host rechecks and applies.  Two
forms:

* **grid** (``scoring`` "auto" / "grid"): the [K, D] move grid reduced to
  each pool row's top-R raw scores (K2 + K1, :func:`ops.grid.grid_rescore`)
  and the L leadership entries (K6) — :func:`reduced_candidates_plain`,
  the reference's ``_reduced_candidates`` (``:2266``) — concatenated into
  K·R + L flat scores (``_merged_scores``, ``:2334``);
* **columnar** (``scoring`` "columnar"): the K×D grid flattened plus every
  P·S leadership transfer, each scored by ``_score_candidates``
  (``_build_round_candidates``, ``:720``).

Then ``lax.top_k(-scores, k)``, the decode (``_decode_flat_idx``,
``:2875``) and the pack (``_pack_round_result``, ``:2059``).

* K13 (``csrc/round_pack.cu``), two entry points around K11's top-k:
  :func:`round_keys` builds the grid form's literally negated flat key
  (plain twin :func:`round_keys_plain`), K11
  (:func:`analyzer.pool_kernels.top_select`, twin ``_top_desc``) keeps its
  k largest, and :func:`round_pack` gathers their scores back, decodes
  them in either layout and packs them (plain twin
  :func:`round_pack_plain` over :func:`decode_flat_idx` /
  :func:`decode_columnar` and :func:`pack_round_result`).
* K14 :func:`score_columnar` (``csrc/score_columnar.cu``): the columnar
  form's flat key, its K·D + P·S scores negated as they are stored, each
  candidate derived from its flat index — plain twins
  :func:`score_columnar_plain`, which materializes the columns and calls
  ``_score_candidates``, then :func:`round_keys_plain`.

:func:`round_plain` is the whole round of plain twins.  Each wrapper runs
its plain twin for tensors that lie on the CPU, and for CUDA tensors
launches its kernel or raises; there is no fallback.  Each counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.pool_kernels import _top_desc
from cruise_control_tpu_torch.analyzer.score_kernel import (
    KIND_LEADERSHIP,
    KIND_MOVE,
    _score_candidates,
)
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.cost import pack_pload
from cruise_control_tpu_torch.ops.grid import (
    _MAX_S,
    _NC,
    _NT,
    grid_consts,
    grid_top_r_plain,
    move_grid_terms,
    terms_consts,
)

#: alternate destinations kept per source row (fallbacks tried by the
#: batch matcher when a better-scored source takes the same destination;
#: the score-only round ranks all of them)
DESTS_PER_SOURCE = 8

#: K13's two decode layouts (``csrc/round_pack.cu``)
LAYOUT_GRID, LAYOUT_COLUMNAR = 0, 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------------

def reduced_candidates_plain(m, cfg, ca, pools):
    """The grid form's candidates → (kp, ks, row_scores f32 [K, R], best_d
    int32 [K, R] broker ids, lp, lsl, l_scores f32 [L]): each pool row's
    top-R raw grid scores (ascending, ties to the lowest pool index) and
    the leadership pool's scores — the reference's ``_reduced_candidates``
    on ``pools`` (:func:`analyzer.cuda_optimizer._build_pools`' output)."""
    kp, ks, dest_pool, lp, lsl = pools
    R = min(DESTS_PER_SOURCE, dest_pool.shape[0])
    terms = move_grid_terms(m, cfg, ca, kp, ks)
    row_scores, best_i = grid_top_r_plain(m, cfg, ca, kp, ks, dest_pool,
                                          terms, R)
    l_scores, _ = _score_candidates(
        m, cfg, ca, torch.full_like(lp, KIND_LEADERSHIP), lp, lsl,
        torch.zeros_like(lp))
    return kp, ks, row_scores, dest_pool[best_i.long()], lp, lsl, l_scores


def round_keys_plain(scores, l_scores=None):
    """Plain twin of K13 (a): the negated flat key ``-concat(scores
    .reshape(-1), l_scores)`` (the reference's ``top_k(-scores)`` input)."""
    flat = scores.reshape(-1)
    if l_scores is not None:
        flat = torch.cat([flat, l_scores])
    return -flat


def decode_flat_idx(idx, kp, ks, best_d, lp, lsl):
    """Inverse of the grid form's flat layout → (is_move, kind, p, s, d):
    index i < K·R is the move of pool row i // R to ``best_d[i // R,
    i % R]``; any other i the leadership entry i - K·R (the reference's
    ``_decode_flat_idx``, its clips included)."""
    K, R = best_d.shape
    L = lp.shape[0]
    idx = idx.long()
    is_move = idx < K * R
    row = (idx // R).clamp(0, K - 1)
    li = (idx - K * R).clamp(0, L - 1)
    p = torch.where(is_move, kp[row], lp[li])
    s = torch.where(is_move, ks[row], lsl[li])
    d = torch.where(is_move, best_d[row, (idx % R).clamp(0, R - 1)], 0)
    kind = torch.where(is_move, KIND_MOVE, KIND_LEADERSHIP).to(torch.int32)
    return is_move, kind, p.to(torch.int32), s.to(torch.int32), \
        d.to(torch.int32)


def decode_columnar(idx, kp, ks, dest_pool, S: int):
    """Inverse of the columnar layout → (is_move, kind, p, s, d): index
    i < K·D is the move of pool row i // D to ``dest_pool[i % D]``; any
    other i the leadership transfer of partition (i - K·D) // S to slot
    (i - K·D) % S (the reference gathers the materialized columns)."""
    K, D = kp.shape[0], dest_pool.shape[0]
    idx = idx.long()
    is_move = idx < K * D
    row = (idx // D).clamp(0, K - 1)
    j = (idx - K * D).clamp_min(0)
    p = torch.where(is_move, kp[row].long(), j // S)
    s = torch.where(is_move, ks[row].long(), j % S)
    d = torch.where(is_move, dest_pool[idx % D].long(), 0)
    kind = torch.where(is_move, KIND_MOVE, KIND_LEADERSHIP).to(torch.int32)
    return is_move, kind, p.to(torch.int32), s.to(torch.int32), \
        d.to(torch.int32)


def pack_round_result(scores, kind, p, s, d) -> torch.Tensor:
    """The round's top-k as ONE f32 [5, k] array (score, kind, partition,
    slot, destination): one read to the host a round.  Ids are exact in
    f32 (all below 2^24)."""
    f = torch.float32
    return torch.stack([scores.to(f), kind.to(f), p.to(f), s.to(f),
                        d.to(f)])


def unpack_round_result(packed: np.ndarray):
    """Host-side inverse of :func:`pack_round_result` (numpy in, numpy
    out); non-finite entries of the id rows read as -1."""
    scores = packed[0]
    kind, cp, cs, cd = (
        np.where(np.isfinite(packed[i]), packed[i], -1).astype(np.int32)
        for i in range(1, 5)
    )
    return scores, kind, cp, cs, cd


def round_pack_plain(key, sel, kp, ks, dest_pool, best_i=None, lp=None,
                     lsl=None, S: int = 1) -> torch.Tensor:
    """Plain twin of K13 (b): the packed f32 [5, k] of the flat indices
    ``sel`` into ``key`` — scores ``-key[sel]``, decoded in the grid
    layout when ``best_i`` (K1's [K, R] pool indices) is given, else in
    the columnar layout with ``S`` slots a partition."""
    idx = sel.long()
    scores = -key[idx]
    if best_i is not None:
        _, kind, p, s, d = decode_flat_idx(
            idx, kp, ks, dest_pool[best_i.long()], lp, lsl)
    else:
        _, kind, p, s, d = decode_columnar(idx, kp, ks, dest_pool, S)
    return pack_round_result(scores, kind, p, s, d)


def score_columnar_plain(m, cfg, ca, kp, ks, dest_pool) -> torch.Tensor:
    """Plain twin of K14: the columnar form's f32 [K·D + P·S] scores (+inf
    where infeasible) — the K×D grid flattened, then every P·S leadership
    transfer, materialized as columns (the reference's
    ``_build_round_candidates``) and scored by ``_score_candidates``."""
    P, S = m.assignment.shape
    K, D = kp.shape[0], dest_pool.shape[0]
    dev = kp.device
    i32 = torch.int32
    ps = torch.arange(P * S, dtype=i32, device=dev)
    kind = torch.cat([torch.full((K * D,), KIND_MOVE, dtype=i32, device=dev),
                      torch.full((P * S,), KIND_LEADERSHIP, dtype=i32,
                                 device=dev)])
    cp = torch.cat([kp.repeat_interleave(D), ps // S])
    cs = torch.cat([ks.repeat_interleave(D), ps % S])
    cd = torch.cat([dest_pool.repeat(K), torch.zeros_like(ps)])
    return _score_candidates(m, cfg, ca, kind, cp, cs, cd)[0]


def round_plain(m, cfg, ca, K: int, D: int, scoring: str, pools=None):
    """One score-only round of plain twins → the packed f32 [5, k], k =
    ``min(topk_per_round, N)`` — the reference's ``_cached_round_fn(cfg,
    K, D, None)(m, ca)``.  ``scoring`` is the resolved form ("grid" or
    "columnar"); ``pools`` as :func:`reduced_candidates_plain`'s (a full
    repool when not given, as the reference's round rebuilds them)."""
    if pools is None:
        # imported here: the search module imports this one
        from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
            _build_pools,
        )

        pools = _build_pools(m, cfg, ca, K, D)
    kp, ks, dest_pool, lp, lsl = pools
    if scoring == "columnar":
        key = round_keys_plain(score_columnar_plain(m, cfg, ca, kp, ks,
                                                    dest_pool))
        k = min(cfg.topk_per_round, key.shape[0])
        idx = _top_desc(key, k)
        _, kind, p, s, d = decode_columnar(idx, kp, ks, dest_pool,
                                           m.assignment.shape[1])
    else:
        kp, ks, row_scores, best_d, lp, lsl, l_scores = \
            reduced_candidates_plain(m, cfg, ca, pools)
        key = round_keys_plain(row_scores, l_scores)
        k = min(cfg.topk_per_round, key.shape[0])
        idx = _top_desc(key, k)
        _, kind, p, s, d = decode_flat_idx(idx, kp, ks, best_d, lp, lsl)
    return pack_round_result(-key[idx], kind, p, s, d)


# ---------------------------------------------------------------------------------
# K13: the flat key and the packed result
# ---------------------------------------------------------------------------------

def _contiguous_f32(name: str, x, dev) -> None:
    if x.dtype != torch.float32 or x.device != dev or not x.is_contiguous():
        raise ValueError(f"round_pack: {name} must be a contiguous f32 "
                         f"tensor on {dev}, got {x.dtype} on {x.device}")


def round_keys_work(N: int):
    """K13 (a)'s work → (bytes, operations): the N scores read, the key
    written; a negation each."""
    return N * 8, N


def round_pack_work(k: int):
    """K13 (b)'s work → (bytes, operations): the k selected indices and
    their keys, ~4 ids each (pool row, slot, destination, leadership
    entry) read once; the packed [5, k] out; ~10 operations each."""
    return k * (4 + 4 + 16) + 5 * k * 4, 10 * k


#: ~f32 operations of one fused broker cost (csrc/broker_cost.cuh: about
#: 13 a resource, then the count, leadership and network terms)
BROKER_COST_OPS = 85


def score_columnar_work(K: int, D: int, P: int, S: int, B: int, NR: int,
                        W: int, N: int, has_cap: bool, feas_mv=None,
                        feas_ld=None):
    """K14's work → (bytes, operations).  Bytes: each input once — the
    pools, every partition's row (slots, origins, must-move flags, leader
    slot, load row), the broker tables, the constants — and the N keys
    out.  Operations on this run's data: a move cell's source costs
    depend only on its pool row and its destination's old cost only on
    the broker, so each is counted once (a row's new source cost, every
    broker's old cost); every move cell needs its feasibility (the
    capacity test, 2·NR, the rack and duplicate scan, 3·S, ~8 flags), a
    feasible one (``feas_mv`` of them, every cell where not counted) also
    the destination's new cost and the delta's sums; a leadership
    transfer needs ~12 operations of feasibility, a feasible one
    (``feas_ld``) its two new costs and ~30 more; every candidate's score
    is negated into the key."""
    n_mv = K * D
    feas_mv = n_mv if feas_mv is None else feas_mv
    feas_ld = N - n_mv if feas_ld is None else feas_ld
    nbytes = (K * 8 + D * 4 + P * (9 * S + 4 + 4 * W)
              + B * (4 * (NR * (3 if has_cap else 2) + 4) + 6) + 4 * 28
              + N * 4)
    ops = (n_mv * (2 * NR + 3 * S + 8)
           + feas_mv * (BROKER_COST_OPS + (NR if has_cap else 0) + 2)
           + K * (BROKER_COST_OPS + 30) + B * BROKER_COST_OPS
           + (N - n_mv) * 12
           + feas_ld * (2 * BROKER_COST_OPS + 30)
           + N)
    return nbytes, ops


def round_keys(scores, l_scores=None) -> torch.Tensor:
    """K13 (a): the negated flat key of the plain twin
    :func:`round_keys_plain` → f32 [scores.numel() + L].  ``scores`` is
    K1's [K, R], ``l_scores`` K6's [L] (the grid form's round; K14 makes
    the columnar key itself)."""
    if kernels.on_cpu(scores):
        return round_keys_plain(scores, l_scores)
    dev = scores.device
    _contiguous_f32("scores", scores, dev)
    na = scores.numel()
    nb = 0
    if l_scores is not None:
        _contiguous_f32("l_scores", l_scores, dev)
        if l_scores.dim() != 1:
            raise ValueError("round_pack: l_scores must be 1-D")
        nb = l_scores.shape[0]
    if na + nb < 1:
        raise ValueError("round_pack: an empty flat key")
    key = torch.empty(na + nb, dtype=torch.float32, device=dev)
    lib = kernels.bind("round_pack", "round_keys_launch",
                       [_P, _L, _P, _L, _P, _P])
    err = lib.round_keys_launch(
        scores.data_ptr(), na, None if nb == 0 else l_scores.data_ptr(), nb,
        key.data_ptr(), kernels.stream(dev))
    kernels.launched("round_keys", err)
    round_keys.launches += 1
    kernels.note_work("round_pack", lambda: round_keys_work(na + nb))
    return key


round_keys.launches = 0


def round_pack(key, sel, kp, ks, dest_pool, best_i=None, lp=None, lsl=None,
               S: int = 1) -> torch.Tensor:
    """K13 (b): the packed f32 [5, k] of the plain twin
    :func:`round_pack_plain` (same arguments; ``sel`` int32 [k] are K11's
    selected flat indices)."""
    if kernels.on_cpu(key):
        return round_pack_plain(key, sel, kp, ks, dest_pool, best_i, lp, lsl,
                                S)
    dev = key.device
    N, k = key.shape[0], sel.shape[0]
    K, D = kp.shape[0], dest_pool.shape[0]
    i32 = torch.int32
    chk = functools.partial(kernels.check, "round_pack", device=dev)
    chk("key", key, torch.float32, (N,))
    chk("sel", sel, i32, (k,))
    chk("kp", kp, i32, (K,))
    chk("ks", ks, i32, (K,))
    chk("dest_pool", dest_pool, i32, (D,))
    grid = best_i is not None
    if grid:
        R = best_i.shape[1] if best_i.dim() == 2 else -1
        L = lp.shape[0]
        chk("best_i", best_i, i32, (K, R))
        chk("lp", lp, i32, (L,))
        chk("lsl", lsl, i32, (L,))
        W = R
        if N != K * R + L:
            raise ValueError(f"round_pack: key of {N} entries, grid layout "
                             f"K·R + L = {K * R + L}")
    else:
        W, L = D, 0
        if S < 1 or (N - K * D) % S or N < K * D:
            raise ValueError(f"round_pack: key of {N} entries, columnar "
                             f"layout K·D = {K * D} + P·{S}")
    if not 1 <= k <= N:
        raise ValueError(f"round_pack: k={k} of N={N} out of range")
    out = torch.empty((5, k), dtype=torch.float32, device=dev)
    lib = kernels.bind("round_pack", "round_pack_launch",
                       [_P, _L, _P] + [_I] * 6 + [_P] * 8)
    err = lib.round_pack_launch(
        key.data_ptr(), N, sel.data_ptr(), k,
        LAYOUT_GRID if grid else LAYOUT_COLUMNAR, K, W, L, S,
        kp.data_ptr(), ks.data_ptr(), dest_pool.data_ptr(),
        best_i.data_ptr() if grid else None, lp.data_ptr() if grid else None,
        lsl.data_ptr() if grid else None, out.data_ptr(),
        kernels.stream(dev))
    kernels.launched("round_pack", err)
    round_pack.launches += 1
    kernels.note_work("round_pack", lambda: round_pack_work(k))
    return out


round_pack.launches = 0


# ---------------------------------------------------------------------------------
# K14: the columnar round's scores
# ---------------------------------------------------------------------------------

def score_columnar(m, cfg, ca, kp, ks, dest_pool, consts=None,
                   tconsts=None) -> torch.Tensor:
    """K14: the columnar round's flat key, f32 [K·D + P·S] — the plain
    twins ``round_keys_plain(score_columnar_plain(...))``: each candidate's
    score negated as it is stored, the candidate columns never
    materialized.  ``consts`` / ``tconsts`` as K6's
    (:func:`analyzer.score_kernel.score_candidates`)."""
    if kernels.on_cpu(kp):
        return round_keys_plain(score_columnar_plain(m, cfg, ca, kp, ks,
                                                     dest_pool))
    dev = kp.device
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    K, D = kp.shape[0], dest_pool.shape[0]
    if consts is None:
        consts = grid_consts(cfg, ca, dev)
    if tconsts is None:
        tconsts = terms_consts(cfg, ca, dev)
    table = m.pload if m.pload is not None else pack_pload(
        m.leader_load, m.follower_load, m.excluded,
        m.leader_cload, m.follower_cload)
    W = table.shape[1]
    has_cap = m.leader_cload is not None
    R = NUM_RESOURCES
    N = K * D + P * S
    if W != (4 * R + 1 if has_cap else 2 * R + 1) or not 1 <= S <= _MAX_S \
            or K < 1 or D < 1 or N >= 1 << 31:
        raise ValueError(f"score_columnar: partition table width {W}, S={S}, "
                         f"K={K}, D={D} out of range")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    chk = functools.partial(kernels.check, "score_columnar", device=dev)
    for name, x, dt, shape in (
        ("assignment", m.assignment, i32, (P, S)),
        ("leader_slot", m.leader_slot, i32, (P,)),
        ("offline_origin", m.offline_origin, i32, (P, S)),
        ("must_move", m.must_move, b8, (P, S)),
        ("pload", table, f32, (P, W)),
        ("rack", m.rack, i32, (B,)),
        ("dest_ok", m.dest_ok, b8, (B,)),
        ("lead_ok", m.lead_ok, b8, (B,)),
        ("capacity", m.capacity, f32, (B, R)),
        ("broker_load", m.broker_load, f32, (B, R)),
        ("leader_nwin", m.leader_nwin, f32, (B,)),
        ("pot_nwout", m.pot_nwout, f32, (B,)),
        ("rcount", m.rcount, f32, (B,)),
        ("lcount", m.lcount, f32, (B,)),
        ("kp", kp, i32, (K,)),
        ("ks", ks, i32, (K,)),
        ("dest_pool", dest_pool, i32, (D,)),
        ("consts", consts, f32, (_NC,)),
        ("tconsts", tconsts, f32, (_NT,)),
        *((("broker_cload", m.broker_cload, f32, (B, R)),)
          if has_cap else ()),
    ):
        chk(name, x, dt, shape)
    key = torch.empty(N, dtype=f32, device=dev)
    lib = kernels.bind("score_columnar", "score_columnar_launch",
                       [_P] * 20 + [_I] * 5 + [_P] * 2)
    if not getattr(lib, "_cc_checked", False):
        lib.score_columnar_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.score_columnar_layout.restype = None
        layout = (ctypes.c_int * 3)()
        lib.score_columnar_layout(layout)
        if tuple(layout) != (_NC, _NT, _MAX_S):
            raise RuntimeError(f"score_columnar library layout "
                               f"{tuple(layout)} != {(_NC, _NT, _MAX_S)}")
        lib._cc_checked = True
    err = lib.score_columnar_launch(
        m.assignment.data_ptr(), m.leader_slot.data_ptr(),
        m.offline_origin.data_ptr(), m.must_move.data_ptr(),
        table.data_ptr(), m.rack.data_ptr(), m.dest_ok.data_ptr(),
        m.lead_ok.data_ptr(), m.capacity.data_ptr(),
        m.broker_load.data_ptr(),
        m.broker_cload.data_ptr() if has_cap else None,
        m.leader_nwin.data_ptr(), m.pot_nwout.data_ptr(),
        m.rcount.data_ptr(), m.lcount.data_ptr(), kp.data_ptr(),
        ks.data_ptr(), dest_pool.data_ptr(), consts.data_ptr(),
        tconsts.data_ptr(), K, D, P, S, W, key.data_ptr(),
        kernels.stream(dev),
    )
    kernels.launched("score_columnar", err)
    score_columnar.launches += 1
    kernels.note_work("score_columnar", lambda: score_columnar_work(
        K, D, P, S, B, R, W, N, has_cap))
    return key


score_columnar.launches = 0

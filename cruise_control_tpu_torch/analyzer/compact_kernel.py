"""Step compaction: the search step's best C candidate rows and the
cohort's inputs, and the hand-written CUDA kernel that builds them on the
card.

* K7 :func:`compact_rows` (``csrc/compact_rows.cu``) — plain twin
  :func:`_compact_rows`, a transcript of the reference step body
  (``tpu_optimizer.py:1202-1309``: the compaction sort ``sort_key_val``
  :1206, the candidate gathers, ``leader_now_q`` :1238, ``move_vec``,
  the partition representatives ``order_pc`` :1293 / ``rep`` and the
  one-row-per-partition filter ``fminp`` :1305).  The reference has no
  function of its own there; the CPU tests hold the twin against a jnp
  transcript of those lines.

The wrapper runs the plain twin for tensors that lie on the CPU, and for
CUDA tensors launches the kernel or raises; there is no fallback.  It
counts its launches in ``compact_rows.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cruise_control_tpu_torch.analyzer.step_kernels import _scatter_min
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.grid import gather_pload as _gather_pload

_INF = float("inf")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Compacted(NamedTuple):
    """The step's C best candidate rows, in score order, and the cohort's
    inputs (names as in the reference's step body)."""

    is_move_row: torch.Tensor   # bool [C]
    cand_score: torch.Tensor    # f32 [C, R] alternates' scores
    cand_dst: torch.Tensor      # int32 [C, R] alternates' destinations
    cand_src: torch.Tensor      # int64 [C] source broker (>= 0)
    cand_p: torch.Tensor        # int32 [C] partition
    cand_s: torch.Tensor        # int32 [C] slot
    move_vec: torch.Tensor      # f32 [C, NB] budget vector
    qual: torch.Tensor          # bool [C] cohort-eligible, one per partition
    rep: torch.Tensor           # int64 [C] partition representative row
    improving: torch.Tensor     # bool [C] best score below the tolerance
    d0: torch.Tensor            # int32 [C] best destination, clamped at 0


def _compact_rows(m, q_scores, q_rows, bl, src_term, vals, best_d,
                  dest_pool, kp, ks, sb, C: int, tol: float,
                  dest_terms: bool = False) -> Compacted:
    """The step's compaction to the best C of the NROW = (Q+1)·B rows
    (Q move rows per source broker from ``q_rows`` / ``q_scores`` [Q, B],
    then each broker's best leadership transfer ``bl`` = (score, p, s,
    dst) [B]) and the cohort's inputs for them.  ``src_term`` [K] and
    ``vals`` / ``best_d`` [K, R] are the rescore's source terms and per-row
    top-R; the row scores are ``src_term + (vals - src_term)``, the
    reference's carried destination terms re-added to the source term.
    With ``dest_terms`` ``vals`` *is* the incremental rescore's carry of
    destination terms (tpu_optimizer.py:1162), so the row scores are
    ``src_term + vals`` (subtracting again would not round-trip in f32),
    and ``best_d`` may hold -1 (no destination: -1)."""
    bl_score, bl_p, bl_s, bl_dst = bl
    K, R = vals.shape
    Q, B = q_rows.shape
    dev = vals.device
    row_scores = src_term[:, None] + (
        vals if dest_terms else vals - src_term[:, None])
    rows_q = q_rows.reshape(-1).long()
    valid_q = rows_q < K
    mrow = rows_q.clamp(0, K - 1)

    key_all = torch.cat([q_scores.reshape(-1), bl_score])
    crow = torch.sort(key_all, stable=True).indices[:C]
    is_move_row = crow < Q * B
    qrow = crow.clamp(0, Q * B - 1)
    mr_c = mrow[qrow]
    valid_c = valid_q[qrow]
    lrow_c = (crow - Q * B).clamp(0, B - 1)
    imr = is_move_row[:, None]
    inf_tail = torch.full((C, R - 1), _INF, device=dev)
    cand_score = torch.where(
        imr,
        torch.where(valid_c[:, None], row_scores[mr_c], _INF),
        torch.cat([bl_score[lrow_c][:, None], inf_tail], dim=1),
    )                                                   # [C, R]
    bd_c = best_d[mr_c].long()
    move_dst = torch.where(bd_c >= 0, dest_pool[bd_c.clamp_min(0)], -1)
    cand_dst = torch.where(imr, move_dst, bl_dst[lrow_c][:, None])
    cand_src = torch.where(is_move_row, sb[mr_c].long(), lrow_c)
    cand_p = torch.where(is_move_row, kp[mr_c], bl_p[lrow_c])
    cand_s = torch.where(is_move_row, ks[mr_c], bl_s[lrow_c])

    # the cohort's budget vectors
    leader_now_q = m.leader_slot[cand_p.long()] == cand_s
    lead_c, fol_c, _excl_c, leadc_c, folc_c = _gather_pload(m, cand_p)
    lead_move = leader_now_q[:, None] & imr
    ml = torch.where(imr, torch.where(lead_move, lead_c, fol_c), 0.0)
    move_vec = torch.cat([
        ml,
        is_move_row.to(torch.float32)[:, None],
        torch.where(is_move_row, lead_c[:, Resource.NW_OUT], 0.0)[:, None],
    ], dim=1)
    if m.leader_cload is not None:
        mlc = torch.where(lead_move, leadc_c, folc_c)
        move_vec = torch.cat([move_vec, torch.where(imr, mlc, 0.0)], 1)
    qualified = is_move_row & ~leader_now_q & valid_c
    # compact partition-conflict ids: rows sharing a partition map to
    # one representative row
    ci = torch.arange(C, device=dev)
    order_pc = torch.argsort(cand_p, stable=True)
    sorted_p = cand_p[order_pc]
    firstp = torch.ones(C, dtype=torch.bool, device=dev)
    firstp[1:] = sorted_p[1:] != sorted_p[:-1]
    start_pos = torch.cummax(torch.where(firstp, ci, -1), dim=0).values
    rep = torch.empty_like(ci)
    rep[order_pc] = order_pc[start_pos]
    improving = cand_score[:, 0] < tol
    qual = qualified & improving
    # one row per partition (best first — rows are in score order)
    fminp = _scatter_min(C, rep, torch.where(qual, ci, C), C)
    qual = qual & (ci == fminp[rep])
    return Compacted(is_move_row, cand_score, cand_dst, cand_src, cand_p,
                     cand_s, move_vec, qual, rep, improving,
                     cand_dst[:, 0].clamp_min(0))


# ---------------------------------------------------------------------------------
# K7: compaction and the cohort's inputs
# ---------------------------------------------------------------------------------

def compact_rows_work(nrow: int, C: int, R: int, NB: int, W: int,
                      n_part=None):
    """K7's work → (bytes, operations): the NROW scores; a kept row's q
    row index, R scores and pool indices, source term, kp / ks / sb and
    its leadership entry; R pool entries a kept move row at most; each of
    ``n_part`` distinct partitions' leader slot and load row (C where not
    counted); the outputs.  Four histogram passes and the gather over
    NROW keys, two bitonic sorts of C keys, ~(8R + 2NB + 30) operations a
    kept row."""
    n_part = C if n_part is None else n_part
    log_c = max(C - 1, 1).bit_length()
    return (nrow * 4 + C * (4 + 8 * R + 4 + 12 + 16 + 4 * R)
            + n_part * (4 + 4 * W)
            + C * (1 + 8 * R + 8 + 8 + 4 * NB + 1 + 8 + 1 + 4),
            5 * nrow * 3 + 2 * C * log_c * (log_c + 1) // 2
            + C * (8 * R + 2 * NB + 30))


def compact_rows(m, q_scores, q_rows, bl, src_term, vals, best_d,
                 dest_pool, kp, ks, sb, C: int, tol: float,
                 checked: bool = False,
                 dest_terms: bool = False) -> Compacted:
    """The :class:`Compacted` rows of the plain twin :func:`_compact_rows`
    (same arguments).  ``src_term`` may be a strided 1-D view (the source
    term column of K2's table).  ``checked=True`` skips the input checks
    (the step loop checks once per call)."""
    if kernels.on_cpu(vals):
        return _compact_rows(m, q_scores, q_rows, bl, src_term, vals, best_d,
                             dest_pool, kp, ks, sb, C, tol, dest_terms)
    dev = vals.device
    bl_score, bl_p, bl_s, bl_dst = bl
    K, R = vals.shape
    Q, B = q_rows.shape
    P = m.leader_slot.shape[0]
    D = dest_pool.shape[0]
    W = m.pload.shape[1]
    NR = NUM_RESOURCES
    NB = 2 * NR + 2 if m.leader_cload is not None else NR + 2
    nrow = (Q + 1) * B
    if not checked:
        i32, f32 = torch.int32, torch.float32
        chk = functools.partial(kernels.check, "compact_rows", device=dev)
        for name, x, dt, shape in (
            ("q_scores", q_scores, f32, (Q, B)),
            ("q_rows", q_rows, i32, (Q, B)),
            ("bl_score", bl_score, f32, (B,)),
            ("bl_p", bl_p, i32, (B,)),
            ("bl_s", bl_s, i32, (B,)),
            ("bl_dst", bl_dst, i32, (B,)),
            ("vals", vals, f32, (K, R)),
            ("best_d", best_d, i32, (K, R)),
            ("dest_pool", dest_pool, i32, (D,)),
            ("kp", kp, i32, (K,)),
            ("ks", ks, i32, (K,)),
            ("sb", sb, i32, (K,)),
            ("leader_slot", m.leader_slot, i32, (P,)),
            ("pload", m.pload, f32, (P, W)),
        ):
            chk(name, x, dt, shape)
        if src_term.dtype != f32 or tuple(src_term.shape) != (K,) \
                or src_term.device != dev or src_term.stride(0) < 1:
            raise ValueError("compact_rows: src_term must be a 1-D f32 "
                             f"tensor of {K} entries on {dev} with a "
                             "positive stride")
        if not 1 <= C <= nrow or K < 1 or R < 1 or nrow >= 1 << 31 \
                or W != (4 * NR + 1 if NB > NR + 2 else 2 * NR + 1):
            raise ValueError(f"compact_rows: C={C}, NROW={nrow}, K={K}, "
                             f"R={R}, table width {W} out of range")
    lib = kernels.bind("compact_rows", "compact_rows_launch",
                       [_P] * 6 + [_P, _I] + [_P] * 8 + [_I] * 7 + [_F, _I]
                       + [_P] * 13)
    lib.compact_rows_scratch_bytes.restype = ctypes.c_longlong
    # the kept keys and the partitions' hash table: in shared memory where
    # they fit (0 bytes), else in a device scratch
    nbytes = lib.compact_rows_scratch_bytes(C)
    scratch = None if nbytes == 0 else torch.empty(
        -(-nbytes // 8), dtype=torch.int64, device=dev)
    out = Compacted(
        torch.empty(C, dtype=torch.bool, device=dev),
        torch.empty((C, R), dtype=torch.float32, device=dev),
        torch.empty((C, R), dtype=torch.int32, device=dev),
        torch.empty(C, dtype=torch.int64, device=dev),
        torch.empty(C, dtype=torch.int32, device=dev),
        torch.empty(C, dtype=torch.int32, device=dev),
        torch.empty((C, NB), dtype=torch.float32, device=dev),
        torch.empty(C, dtype=torch.bool, device=dev),
        torch.empty(C, dtype=torch.int64, device=dev),
        torch.empty(C, dtype=torch.bool, device=dev),
        torch.empty(C, dtype=torch.int32, device=dev),
    )
    err = lib.compact_rows_launch(
        q_scores.data_ptr(), q_rows.data_ptr(), bl_score.data_ptr(),
        bl_p.data_ptr(), bl_s.data_ptr(), bl_dst.data_ptr(),
        src_term.data_ptr(), src_term.stride(0), vals.data_ptr(),
        best_d.data_ptr(), dest_pool.data_ptr(), kp.data_ptr(),
        ks.data_ptr(), sb.data_ptr(), m.leader_slot.data_ptr(),
        m.pload.data_ptr(), W, NB, Q, B, K, R, C, float(tol),
        int(dest_terms), *(t.data_ptr() for t in out),
        None if scratch is None else scratch.data_ptr(), kernels.stream(dev),
    )
    kernels.launched("compact_rows", err)
    compact_rows.launches += 1
    kernels.note_work("compact_rows", lambda: compact_rows_work(
        nrow, C, R, NB, W))
    return out


compact_rows.launches = 0

#: K7's device phases in the order its phase stamps close them
#: (``csrc/compact_rows.cu``, built with ``-DCC_PHASE_STAMPS`` by
#: ``tools/time_kernels.py``): three selection passes, the gather, the
#: sort, the rows' resolution with the partitions' hash table, ``rep`` and
#: the partition filter
COMPACT_ROWS_PHASES = ("select0", "select1", "select2", "gather", "sort",
                       "resolve", "rep")


def compact_rows_attrs(C: int, nrow: int) -> dict:
    """The built K7 at C kept rows of ``nrow`` keys, as the card reports
    it (:func:`ops.kernels.attrs`).  Needs the card."""
    lib = kernels.bind("compact_rows", "compact_rows_attrs",
                       [_I, _I, ctypes.POINTER(ctypes.c_int)])
    return kernels.attrs("compact_rows", lib.compact_rows_attrs, C, nrow)

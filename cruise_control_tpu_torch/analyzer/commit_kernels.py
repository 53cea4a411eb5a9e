"""The search step's commit and the aggregate rebuild: their plain twins
and the hand-written CUDA kernels that replace them on the card.

* K8 :func:`commit_batch` (``csrc/commit_batch.cu``): the merge of the
  cohort with the auction, the commit-order sort that keeps the step's M
  best, their output rows, the touched-partition mark, the batch applied
  to the device model and the step loop's carry advanced
  (:mod:`analyzer.step_state`), and on the incremental path the step's
  touched-broker and -partition marks — plain twin :func:`commit_batch_plain`
  (reference step ``tpu_optimizer.py:1335-1395``) around
  :func:`_apply_batch_on_device` (``:751``).
* K9 :func:`recompute_aggregates` (``csrc/recompute_aggregates.cu``): the
  full per-broker aggregate rebuild — plain twin
  :func:`_recompute_aggregates` (``:444``).

The plain twins keep the reference's names and are what the CPU tests
hold against JAX.  Each wrapper runs its plain twin for tensors that lie
on the CPU, and for CUDA tensors launches its kernel or raises; there is
no fallback.  Each counts its launches in ``<wrapper>.launches``.  K8
updates the model's tensors in place (the plain twin returns new ones):
the step loop works on its own static copy of the mutable tensors
(:data:`MUTABLE`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cruise_control_tpu_torch.analyzer.score_kernel import (
    KIND_LEADERSHIP,
    KIND_MOVE,
)
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.analyzer.step_kernels import _mark
from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.grid import gather_pload as _gather_pload
from cruise_control_tpu_torch.ops.segment import segment_sum

#: the DeviceModel fields a commit writes
MUTABLE = ("assignment", "leader_slot", "must_move", "broker_load",
           "leader_nwin", "pot_nwout", "rcount", "lcount", "broker_cload")

_INF = float("inf")
_P, _I = ctypes.c_void_p, ctypes.c_int


def _recompute_aggregates(m):
    """Rebuild all per-broker aggregates with deterministic segment sums
    (the device twin of AnalyzerContext._init_aggregates)."""
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    slot_exists = m.assignment != EMPTY_SLOT
    ar = torch.arange(S, device=m.assignment.device)
    is_leader = ar[None, :] == m.leader_slot[:, None]
    rload = torch.where(
        is_leader[:, :, None], m.leader_load[:, None, :],
        m.follower_load[:, None, :],
    )
    rload = torch.where(slot_exists[:, :, None], rload, 0.0)
    ids = torch.where(slot_exists, m.assignment,
                      torch.full_like(m.assignment, B)).reshape(-1)
    broker_load = segment_sum(rload.reshape(-1, NUM_RESOURCES), ids, B + 1)[:B]
    rcount = segment_sum(slot_exists.to(torch.int32).reshape(-1), ids,
                         B + 1)[:B].to(torch.float32)
    lb = torch.gather(m.assignment, 1, m.leader_slot.long()[:, None])[:, 0]
    lids = torch.where(lb >= 0, lb, torch.full_like(lb, B))
    lcount = segment_sum(torch.ones_like(lids), lids,
                         B + 1)[:B].to(torch.float32)
    leader_nwin = segment_sum(m.leader_load[:, Resource.NW_IN], lids,
                              B + 1)[:B]
    pot = torch.where(slot_exists, m.leader_load[:, Resource.NW_OUT][:, None],
                      0.0)
    pot_nwout = segment_sum(pot.reshape(-1), ids, B + 1)[:B]
    broker_cload = None
    if m.leader_cload is not None:
        crload = torch.where(
            is_leader[:, :, None], m.leader_cload[:, None, :],
            m.follower_cload[:, None, :],
        )
        crload = torch.where(slot_exists[:, :, None], crload, 0.0)
        broker_cload = segment_sum(crload.reshape(-1, NUM_RESOURCES), ids,
                                   B + 1)[:B]
    return dataclasses.replace(
        m,
        broker_load=broker_load,
        leader_nwin=leader_nwin,
        pot_nwout=pot_nwout,
        rcount=rcount,
        lcount=lcount,
        broker_cload=broker_cload,
    )


def _set_dropped(arr: torch.Tensor, rows, cols, vals) -> torch.Tensor:
    """Copy of ``arr`` with ``arr[rows, cols] = vals`` where ``rows`` equal
    to ``arr.shape[0]`` are dropped (the reference's ``mode="drop"``
    scatter): they land in a dump row that is sliced off."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    if cols is None:
        ext[rows.long()] = vals.to(arr.dtype)
    else:
        ext[rows.long(), cols.long()] = vals.to(arr.dtype) \
            if isinstance(vals, torch.Tensor) else vals
    return ext[:n]


def _apply_batch_on_device(m, take, is_move, p, s, d, src, dst):
    """Commit a disjoint batch to the device model: the aggregate updates
    are deterministic segment sums; placement updates drop unselected
    rows."""
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    lslot = m.leader_slot[p.long()]
    leader_now = lslot == s
    lead_p, fol_p, _excl_p, leadc_p, folc_p = _gather_pload(m, p)
    lnwin_p = lead_p[:, Resource.NW_IN]
    nwout_p = lead_p[:, Resource.NW_OUT]
    move_load = torch.where(leader_now[:, None], lead_p, fol_p)
    lead_delta = lead_p - fol_p

    gate = take.to(torch.float32)
    mv_follower = is_move & ~leader_now
    dload = torch.where(is_move[:, None], move_load, lead_delta) * gate[:, None]
    dlnwin = torch.where(mv_follower, 0.0, lnwin_p) * gate
    dpot = torch.where(is_move, nwout_p, 0.0) * gate
    drc = torch.where(is_move, 1.0, 0.0) * gate
    dlc = torch.where(mv_follower, 0.0, 1.0) * gate

    ids = torch.cat([src.clamp_min(0), dst.clamp_min(0)])

    def seg(contrib):
        return segment_sum(torch.cat([-contrib, contrib]), ids, B)

    broker_cload = m.broker_cload
    if m.leader_cload is not None:
        cmove = torch.where(leader_now[:, None], leadc_p, folc_p)
        clead = leadc_p - folc_p
        dcload = torch.where(is_move[:, None], cmove, clead) * gate[:, None]
        broker_cload = m.broker_cload + seg(dcload)
    full_p = torch.full_like(p, P)
    pm = torch.where(take & is_move, p, full_p)
    pl = torch.where(take & ~is_move, p, full_p)
    return dataclasses.replace(
        m,
        assignment=_set_dropped(m.assignment, pm, s, d),
        leader_slot=_set_dropped(m.leader_slot, pl, None, s),
        must_move=_set_dropped(m.must_move, pm, s, False),
        broker_load=m.broker_load + seg(dload),
        leader_nwin=m.leader_nwin + seg(dlnwin),
        pot_nwout=m.pot_nwout + seg(dpot),
        rcount=m.rcount + seg(drc),
        lcount=m.lcount + seg(dlc),
        broker_cload=broker_cload,
    )


# ---------------------------------------------------------------------------------
# K8: the step's commit
# ---------------------------------------------------------------------------------

def commit_batch_plain(m, acc, take_d, win_score_d, win_dst_d, cand_score,
                       d0, is_move_row, cand_p, cand_s, cand_src,
                       M_step: int, out, tpp, improving, st, tb=None,
                       tpm=None):
    """Plain twin of K8 (reference step ``:1335-1395``): unless the carry
    ``st`` (:class:`analyzer.step_state.StepState`) says the step is
    inactive, the cohort rows ``acc`` merged with the auction's winners,
    the M_step best by score (ties to the lowest row) committed — their
    (kind, p, s, destination) rows written into ``out [4, slots]`` at the
    carry's count, their partitions marked in ``tpp [P]``, the batch
    applied to the model (:func:`_apply_batch_on_device`) and the carry
    advanced (:func:`analyzer.step_state.advance`; ``improving`` [C] feeds
    the diagnostics) → (model, tpp, commits int32 [1]).  Given the
    incremental rescore's ``tb`` [B] and ``tpm`` [P], they are set in place
    to this step's marks (:1380-1388): its commits' source and destination
    brokers, and their partitions."""
    C = acc.shape[0]
    P = m.assignment.shape[0]
    if not int(st.state[SS.ACTIVE]):
        return m, tpp, torch.zeros(1, dtype=torch.int32, device=acc.device)
    count = int(st.state[SS.COUNT])
    take = acc | take_d
    win_score = torch.where(acc, cand_score[:, 0], win_score_d)
    win_dst = torch.where(acc, d0.long(), win_dst_d)
    vals_all, order_all = torch.sort(
        torch.where(take, win_score, _INF), stable=True)
    order = order_all[:M_step]
    sel_ok = torch.isfinite(vals_all[:M_step])
    take_f = torch.zeros(C, dtype=torch.bool, device=acc.device)
    take_f[order] = sel_ok
    m = _apply_batch_on_device(m, take_f, is_move_row, cand_p, cand_s,
                               win_dst, cand_src, win_dst)
    out[:, count:count + M_step] = torch.stack([
        torch.where(is_move_row[order], KIND_MOVE, KIND_LEADERSHIP)
        .to(torch.float32),
        cand_p[order].to(torch.float32),
        cand_s[order].to(torch.float32),
        win_dst[order].to(torch.float32),
    ])
    tpp = tpp | _mark(P, cand_p.clamp_min(0), take_f)
    if tb is not None:
        B = m.capacity.shape[0]
        tb.copy_(_mark(B, cand_src.clamp_min(0), take_f)
                 | _mark(B, win_dst.clamp_min(0), take_f))
        tpm.copy_(_mark(P, cand_p.clamp_min(0), take_f))
    c_step = sel_ok.sum(dtype=torch.int32).reshape(1)
    SS.advance(st, int(c_step), int(improving.sum()), int(acc.sum()),
               int((take_d & ~acc).sum()))
    return m, tpp, c_step


def commit_batch(m, acc, take_d, win_score_d, win_dst_d, cand_score, d0,
                 is_move_row, cand_p, cand_s, cand_src, M_step: int, out,
                 tpp, improving, st, checked: bool = False, tb=None,
                 tpm=None, marks=None):
    """The step's commit of the plain twin :func:`commit_batch_plain`
    (same arguments and results).  On the card the model's :data:`MUTABLE`
    tensors, ``out``, ``tpp``, the carry ``st`` and, when given, the marks
    ``tb`` / ``tpm`` are updated in place, with no host read, and returned;
    the kernel clears the step before's marks from its lists ``marks``
    (int32 [3, M_step], -1 = none; the step loop resets the three once a
    call).  ``checked=True`` skips the input checks (the step loop checks
    once per call)."""
    if kernels.on_cpu(acc):
        return commit_batch_plain(m, acc, take_d, win_score_d, win_dst_d,
                                  cand_score, d0, is_move_row, cand_p,
                                  cand_s, cand_src, M_step, out, tpp,
                                  improving, st, tb, tpm)
    if (tb is None) != (tpm is None) or (tb is None) != (marks is None):
        raise ValueError("commit_batch: tb, tpm and marks go together")
    dev = acc.device
    C, R = cand_score.shape
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    NR = NUM_RESOURCES
    has_cap = m.leader_cload is not None
    W = m.pload.shape[1]
    slots = out.shape[1]
    if not checked:
        i32, i64, f32, b8 = torch.int32, torch.int64, torch.float32, torch.bool
        chk = functools.partial(kernels.check, "commit_batch", device=dev)
        for name, x, dt, shape in (
            ("acc", acc, b8, (C,)),
            ("take_d", take_d, b8, (C,)),
            ("win_score_d", win_score_d, f32, (C,)),
            ("win_dst_d", win_dst_d, i64, (C,)),
            ("cand_score", cand_score, f32, (C, R)),
            ("d0", d0, i32, (C,)),
            ("is_move_row", is_move_row, b8, (C,)),
            ("cand_p", cand_p, i32, (C,)),
            ("cand_s", cand_s, i32, (C,)),
            ("cand_src", cand_src, i64, (C,)),
            ("assignment", m.assignment, i32, (P, S)),
            ("leader_slot", m.leader_slot, i32, (P,)),
            ("must_move", m.must_move, b8, (P, S)),
            ("pload", m.pload, f32, (P, W)),
            ("broker_load", m.broker_load, f32, (B, NR)),
            ("leader_nwin", m.leader_nwin, f32, (B,)),
            ("pot_nwout", m.pot_nwout, f32, (B,)),
            ("rcount", m.rcount, f32, (B,)),
            ("lcount", m.lcount, f32, (B,)),
            ("out", out, f32, (4, slots)),
            ("tpp", tpp, b8, (P,)),
            ("improving", improving, b8, (C,)),
            ("state", st.state, i32, (SS.NSTATE,)),
            ("counts", st.counts, i32, (4, st.steps)),
            *((("broker_cload", m.broker_cload, f32, (B, NR)),)
              if has_cap else ()),
            *((("tb", tb, b8, (B,)), ("tpm", tpm, b8, (P,)),
               ("marks", marks, i32, (3, M_step))) if tb is not None
              else ()),
        ):
            chk(name, x, dt, shape)
        if not 0 <= M_step <= C \
                or not 0 <= st.slot_limit <= slots - M_step \
                or W != (4 * NR + 1 if has_cap else 2 * NR + 1):
            raise ValueError(f"commit_batch: M_step={M_step}, slot limit "
                             f"{st.slot_limit}, slots={slots}, table width "
                             f"{W} out of range")
    lib = kernels.bind("commit_batch", "commit_batch_launch",
                       [_P] * 5 + [_I] + [_P] * 5 + [_I] * 2 + [_P] * 10
                       + [_I] * 3 + [_P, _I] + [_P] * 3 + [_I] * 3
                       + [_P] * 8)
    lib.commit_batch_scratch_bytes.restype = ctypes.c_longlong
    ncol = 2 * NR + 4 if has_cap else NR + 4
    sums = torch.empty((B, ncol), dtype=torch.int64, device=dev)
    c_step = torch.empty(1, dtype=torch.int32, device=dev)
    # the keys, row lists and flags: in shared memory where they fit (0
    # bytes), else in a device scratch
    nbytes = lib.commit_batch_scratch_bytes(C, B)
    gws = None if nbytes == 0 else torch.empty(nbytes, dtype=torch.uint8,
                                               device=dev)
    err = lib.commit_batch_launch(
        acc.data_ptr(), take_d.data_ptr(), win_score_d.data_ptr(),
        win_dst_d.data_ptr(), cand_score.data_ptr(), R, d0.data_ptr(),
        is_move_row.data_ptr(), cand_p.data_ptr(), cand_s.data_ptr(),
        cand_src.data_ptr(), C, M_step, m.assignment.data_ptr(),
        m.leader_slot.data_ptr(), m.must_move.data_ptr(), m.pload.data_ptr(),
        m.broker_load.data_ptr(), m.leader_nwin.data_ptr(),
        m.pot_nwout.data_ptr(), m.rcount.data_ptr(), m.lcount.data_ptr(),
        m.broker_cload.data_ptr() if has_cap else None, B, S, W,
        out.data_ptr(), slots, st.state.data_ptr(), st.counts.data_ptr(),
        improving.data_ptr(), st.steps, st.repool, st.slot_limit,
        tpp.data_ptr(), *(None if x is None else x.data_ptr()
                          for x in (tb, tpm, marks)), sums.data_ptr(),
        c_step.data_ptr(), None if gws is None else gws.data_ptr(),
        kernels.stream(dev),
    )
    kernels.launched("commit_batch", err)
    commit_batch.launches += 1
    return m, tpp, c_step


commit_batch.launches = 0

#: K8's device phases in the order its phase stamps close them
#: (``csrc/commit_batch.cu``, built with ``-DCC_PHASE_STAMPS`` by
#: ``tools/time_kernels.py``)
COMMIT_BATCH_PHASES = ("merge", "sort", "commit_rows", "colmax", "sums",
                       "apply")


# ---------------------------------------------------------------------------------
# K9: the aggregate rebuild
# ---------------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _agg_layout(P: int, S: int, B: int, has_cap: bool, sms: int):
    """(the sizes of K9's outputs in f32 — load, capacity load when
    ``has_cap``, leader NW-in, potential NW-out, replica and leader count
    — packed from the start of one call's buffer, the buffer's bytes),
    from its own ``recompute_aggregates_layout``; raises unless it packs
    them so."""
    fn = kernels.load("recompute_aggregates").recompute_aggregates_layout
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] * 5 + [_P]
    off = (ctypes.c_longlong * 7)()
    kernels.launched("recompute_aggregates",
                     fn(P, S, B, int(has_cap), sms, off))
    sizes = [B * NUM_RESOURCES] * (2 if has_cap else 1) + [B] * 4
    starts = [off[0]] + ([off[1]] if has_cap else []) + list(off[2:6])
    at = 0
    for start, n in zip(starts, sizes):
        if start != at:
            raise RuntimeError("recompute_aggregates: the kernel's layout "
                               "does not pack its outputs")
        at += 4 * n
    return tuple(sizes), off[6]


def recompute_aggregates(m):
    """The model with every per-broker aggregate rebuilt from its placement
    — the plain twin :func:`_recompute_aggregates`.  On the card one call
    is one buffer (the aggregates are views of it, the workspace follows
    them) and six launches: the column maxima, the sort of the slots by
    broker (count, scan, scatter), a warp an item of a broker's slots, a
    warp a broker."""
    if kernels.on_cpu(m.assignment):
        return _recompute_aggregates(m)
    dev = m.assignment.device
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    NR = NUM_RESOURCES
    has_cap = m.leader_cload is not None
    i32, f32 = torch.int32, torch.float32
    chk = functools.partial(kernels.check, "recompute_aggregates", device=dev)
    if not 1 <= S <= 8 or not 1 <= P < 1 << 28 or B < 1:
        raise ValueError(f"recompute_aggregates: P={P}, S={S}, B={B} out of "
                         "range (1 <= S <= 8, P < 2^28)")
    for name, x, dt, shape in (
        ("assignment", m.assignment, i32, (P, S)),
        ("leader_slot", m.leader_slot, i32, (P,)),
        ("leader_load", m.leader_load, f32, (P, NR)),
        ("follower_load", m.follower_load, f32, (P, NR)),
        *((("leader_cload", m.leader_cload, f32, (P, NR)),
           ("follower_cload", m.follower_cload, f32, (P, NR)))
          if has_cap else ()),
    ):
        chk(name, x, dt, shape)
    lib = kernels.bind("recompute_aggregates", "recompute_aggregates_launch",
                       [_P] * 6 + [_I] * 4 + [_P] * 2)
    sms = kernels.sm_count(dev)
    sizes, nbytes = _agg_layout(P, S, B, has_cap, sms)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    outs = buf[:4 * sum(sizes)].view(f32).split(sizes)
    err = lib.recompute_aggregates_launch(
        m.assignment.data_ptr(), m.leader_slot.data_ptr(),
        m.leader_load.data_ptr(), m.follower_load.data_ptr(),
        *((m.leader_cload.data_ptr(), m.follower_cload.data_ptr())
          if has_cap else (None, None)),
        P, S, B, sms, buf.data_ptr(), kernels.stream(dev),
    )
    kernels.launched("recompute_aggregates", err)
    recompute_aggregates.launches += 1
    load, *rest = outs
    cload = rest.pop(0).view(B, NR) if has_cap else None
    lnwin, pot, rcount, lcount = rest
    return dataclasses.replace(
        m, broker_load=load.view(B, NR), leader_nwin=lnwin, pot_nwout=pot,
        rcount=rcount, lcount=lcount, broker_cload=cload)


recompute_aggregates.launches = 0

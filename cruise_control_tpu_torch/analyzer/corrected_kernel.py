"""The corrected cohort (``cohort_mode="corrected"``): its plain twin and
the hand-written CUDA kernel that replaces it on the card.

* K15 :func:`corrected_accept` (``csrc/corrected_accept.cu``) — plain twin
  :func:`_corrected_accept`, the reference's function of that name
  (``tpu_optimizer.py:2522``), over the port's exact segmented prefix
  (:func:`analyzer.step_kernels._seg_excl_prefix`) and
  :func:`ops.cost.broker_cost`.  The step calls it in place of the
  budgeted cohort (K4) when the config asks for it.

The reference's prefix is an f32 ``cumsum`` in XLA's order and the port's
is exact fixed point, so the corrected deltas can differ by ulps; a row
that sits on one of the comparisons' boundaries could be decided apart
(ROADMAP.md §C, "noted, not a fault").  The wrapper runs the plain twin
for tensors that lie on the CPU, and for CUDA tensors launches the kernel
or raises; there is no fallback.  It counts its launches in
``corrected_accept.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cruise_control_tpu_torch.analyzer.score_kernel import _broker_cost
from cruise_control_tpu_torch.analyzer.step_kernels import _seg_excl_prefix
from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.cost import EVAC_BONUS, RACK_FIX_BONUS
from cruise_control_tpu_torch.ops.grid import (
    _NC,
    _NT,
    grid_consts,
    terms_consts,
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: widest move vector K15 takes (2R + 2, csrc/seg_prefix.cuh: MAX_NB)
_MAX_NB = 2 * NUM_RESOURCES + 2


def _corrected_accept(m, cfg, ca, cand_p, cand_s, cand_src, d0, move_vec,
                      qual, tol: float, snap_score=None):
    """Exact-conservative stacked cohort: accept a qualified follower move
    iff its delta, re-evaluated at its destination's and source's
    segment-prefix state (every earlier qualified row of the same broker
    assumed committed), still clears ``tol`` — four [C]-sized broker
    costs — and the stacked state keeps under the capacity and
    replica-count ceilings; with ``cohort_stack_tol`` < 1 a row with a
    non-empty prefix must also keep ``corrected <= snap_score · (1 -
    tol)`` (see the reference's docstring for the convexity argument).

    Rows in score order (best first); move_vec [C, NB] = (move load [R],
    1, potential NW-out[, capacity load [R]]) → accept bool [C]."""
    S = m.assignment.shape[1]
    R = m.capacity.shape[1]
    has_cap = m.broker_cload is not None
    src_c = cand_src.clamp_min(0)
    L = move_vec[:, :R]
    n1 = move_vec[:, R]
    pot1 = move_vec[:, R + 1]
    Lc = move_vec[:, R + 2:] if has_cap else L

    Xd = _seg_excl_prefix(d0, move_vec, qual)
    Ys = _seg_excl_prefix(src_c, move_vec, qual)
    XdL, Xdn, Xdp = Xd[:, :R], Xd[:, R], Xd[:, R + 1]
    XdC = Xd[:, R + 2:] if has_cap else XdL
    YsL, Ysn, Ysp = Ys[:, :R], Ys[:, R], Ys[:, R + 1]
    YsC = Ys[:, R + 2:] if has_cap else YsL

    cost = functools.partial(_broker_cost, m, cfg, ca)
    dl, sl = d0.long(), src_c.long()
    bl, rc, po, lnw, lc = (m.broker_load, m.rcount, m.pot_nwout,
                           m.leader_nwin, m.lcount)
    bcl = m.broker_cload

    # destination: prefix state, then prefix + this row; source likewise
    d_lo = cost(bl[dl] + XdL, lnw[dl], po[dl] + Xdp, rc[dl] + Xdn, lc[dl], dl,
                cload=(bcl[dl] + XdC) if has_cap else None)
    d_hi = cost(bl[dl] + XdL + L, lnw[dl], po[dl] + Xdp + pot1,
                rc[dl] + Xdn + n1, lc[dl], dl,
                cload=(bcl[dl] + XdC + Lc) if has_cap else None)
    s_lo = cost(bl[sl] - YsL, lnw[sl], po[sl] - Ysp, rc[sl] - Ysn, lc[sl], sl,
                cload=(bcl[sl] - YsC) if has_cap else None)
    s_hi = cost(bl[sl] - YsL - L, lnw[sl], po[sl] - Ysp - pot1,
                rc[sl] - Ysn - n1, lc[sl], sl,
                cload=(bcl[sl] - YsC - Lc) if has_cap else None)
    # row terms (friction / hard-goal repair pressure), as _score_candidates
    cs_c = cand_s.clamp(0, S - 1).long()
    pl = cand_p.long()
    row = m.assignment[pl]
    occupied = row != EMPTY_SLOT
    slot_racks = torch.where(occupied, m.rack[row.clamp_min(0).long()],
                             torch.full_like(row, -1))
    my_rack = torch.gather(slot_racks, 1, cs_c[:, None])[:, 0]
    lower = torch.arange(S, device=row.device)[None, :] < cs_c[:, None]
    rack_viol_here = (
        lower & (slot_racks == my_rack[:, None]) & occupied).any(dim=1)
    must_move_here = m.must_move[pl, cs_c]
    extra = (
        L[:, Resource.DISK] / ca["avg_disk_cap"] * cfg.w_move_size
        + torch.where(must_move_here, EVAC_BONUS, 0.0)
        + torch.where(rack_viol_here, RACK_FIX_BONUS, 0.0)
    )
    corrected = (d_hi - d_lo) + (s_hi - s_lo) + extra
    # hard ceilings on the STACKED state: capacity load and replica count
    dst_cload_stack = (bcl[dl] + XdC + Lc) if has_cap else (bl[dl] + XdL + L)
    cap_ok = (
        dst_cload_stack
        <= m.capacity[dl] * ca["cap_threshold"][None, :] + 1e-6
    ).all(dim=1)
    rcount_ok = rc[dl] + Xdn + 1.0 <= ca["max_replicas"]
    acc = qual & (corrected < tol) & cap_ok & rcount_ok
    if snap_score is not None and cfg.cohort_stack_tol < 1.0:
        # commit-ordering guard, gated to rows with a non-empty prefix
        stacked = (Xdn + Ysn) > 0
        acc = acc & (
            ~stacked
            | (corrected <= snap_score * (1.0 - cfg.cohort_stack_tol)))
    return acc


#: K15's device phases in the order its phase stamps close them
#: (``csrc/corrected_accept.cu``, built with ``-DCC_PHASE_STAMPS`` by
#: ``tools/time_kernels.py``): the keys, the rows' column maxima and both
#: sorts; both prefixes in one register scan; the acceptance
CORRECTED_ACCEPT_PHASES = ("sorts", "prefixes", "accept")


def _library():
    lib = kernels.bind("corrected_accept", "corrected_accept_launch",
                       [_P] * 10 + [_I] + [_P] * 9 + [_L] + [_I] * 3
                       + [_F, _I, _F] + [_P] * 3)
    if not getattr(lib, "_cc_checked", False):
        lib.corrected_accept_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.corrected_accept_layout.restype = None
        lib.corrected_accept_scratch_bytes.argtypes = [_I, _I, _I]
        lib.corrected_accept_scratch_bytes.restype = ctypes.c_longlong
        layout = (ctypes.c_int * 3)()
        lib.corrected_accept_layout(layout)
        if tuple(layout) != (_NC, _NT, _MAX_NB):
            raise RuntimeError(f"corrected_accept library layout "
                               f"{tuple(layout)} != {(_NC, _NT, _MAX_NB)}")
        lib._cc_checked = True
    return lib


def corrected_accept_work(C: int, NB: int, S: int, NR: int,
                          has_cap: bool):
    """K15's work → (bytes, operations): a row's ids, move vector, flags
    and snapshot score, its partition's slots and must-move flags and
    their racks, its two brokers' tables; the accept flags out.  Two sorts
    of C keys, two scans of C·NB, four broker costs (~85 operations each)
    and ~60 more a row."""
    log_c = max(C - 1, 1).bit_length()
    return (C * (4 * NB + 25 + S * 9 + 2 * (4 * (NR * (3 if has_cap else 2)
                                                 + 4) + 4)) + C,
            2 * C * log_c * (log_c + 1) // 2 + 2 * 4 * C * NB + C * 400)


def corrected_accept(m, cfg, ca, cand_p, cand_s, cand_src, d0, move_vec,
                     qual, tol: float, snap_score=None, consts=None,
                     tconsts=None, checked: bool = False):
    """K15: the accepted rows (bool [C]) of the plain twin
    :func:`_corrected_accept` (same arguments).  ``snap_score`` may be a
    strided 1-D view (column 0 of the compacted rows' scores).
    ``consts`` / ``tconsts`` are the constant blocks of
    :func:`ops.grid.grid_consts` / :func:`ops.grid.terms_consts` (built
    here when not given); ``checked=True`` skips the input checks (the
    step checks once per call)."""
    if kernels.on_cpu(move_vec):
        return _corrected_accept(m, cfg, ca, cand_p, cand_s, cand_src, d0,
                                 move_vec, qual, tol, snap_score)
    dev = move_vec.device
    P, S = m.assignment.shape
    B, R = m.capacity.shape
    Cn, NB = move_vec.shape
    has_cap = m.broker_cload is not None
    guard = snap_score is not None and cfg.cohort_stack_tol < 1.0
    if consts is None:
        consts = grid_consts(cfg, ca, dev)
    if tconsts is None:
        tconsts = terms_consts(cfg, ca, dev)
    if not checked:
        i32, f32, b8 = torch.int32, torch.float32, torch.bool
        chk = functools.partial(kernels.check, "corrected_accept",
                                device=dev)
        if R != NUM_RESOURCES or NB != (2 * R + 2 if has_cap else R + 2) \
                or Cn < 1:
            raise ValueError(f"corrected_accept: {R} resources, move vector "
                             f"width {NB}, C={Cn} out of range")
        for name, x, dt, shape in (
            ("capacity", m.capacity, f32, (B, R)),
            ("broker_load", m.broker_load, f32, (B, R)),
            ("leader_nwin", m.leader_nwin, f32, (B,)),
            ("pot_nwout", m.pot_nwout, f32, (B,)),
            ("rcount", m.rcount, f32, (B,)),
            ("lcount", m.lcount, f32, (B,)),
            ("rack", m.rack, i32, (B,)),
            ("assignment", m.assignment, i32, (P, S)),
            ("must_move", m.must_move, b8, (P, S)),
            ("consts", consts, f32, (_NC,)),
            ("tconsts", tconsts, f32, (_NT,)),
            ("cand_p", cand_p, i32, (Cn,)),
            ("cand_s", cand_s, i32, (Cn,)),
            ("cand_src", cand_src, torch.int64, (Cn,)),
            ("d0", d0, i32, (Cn,)),
            ("move_vec", move_vec, f32, (Cn, NB)),
            ("qual", qual, b8, (Cn,)),
            *((("broker_cload", m.broker_cload, f32, (B, R)),)
              if has_cap else ()),
        ):
            chk(name, x, dt, shape)
        if guard and (snap_score.dtype != f32 or snap_score.dim() != 1
                      or snap_score.shape[0] != Cn
                      or snap_score.device != dev
                      or snap_score.stride(0) < 1):
            raise ValueError("corrected_accept: snap_score must be a 1-D "
                             f"f32 tensor of {Cn} entries on {dev} with a "
                             "positive stride")
    lib = _library()
    acc = torch.empty(Cn, dtype=torch.bool, device=dev)
    # the sort keys and the two prefixes: in shared memory where they fit
    # (0 bytes), else in a device scratch
    nbytes = lib.corrected_accept_scratch_bytes(Cn, NB, B)
    scratch = None if nbytes == 0 else torch.empty(
        -(-nbytes // 8), dtype=torch.int64, device=dev)
    err = lib.corrected_accept_launch(
        m.capacity.data_ptr(), m.broker_load.data_ptr(),
        m.broker_cload.data_ptr() if has_cap else None,
        m.leader_nwin.data_ptr(), m.pot_nwout.data_ptr(),
        m.rcount.data_ptr(), m.lcount.data_ptr(), m.rack.data_ptr(),
        m.assignment.data_ptr(), m.must_move.data_ptr(), S,
        consts.data_ptr(), tconsts.data_ptr(), cand_p.data_ptr(),
        cand_s.data_ptr(), cand_src.data_ptr(), d0.data_ptr(),
        move_vec.data_ptr(), qual.data_ptr(),
        snap_score.data_ptr() if guard else None,
        snap_score.stride(0) if guard else 0, Cn, NB, B, float(tol),
        int(guard), float(1.0 - cfg.cohort_stack_tol), acc.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream(dev),
    )
    kernels.launched("corrected_accept", err)
    corrected_accept.launches += 1
    kernels.note_work("corrected_accept", lambda: corrected_accept_work(
        Cn, NB, S, R, has_cap))
    return acc


corrected_accept.launches = 0


def corrected_accept_attrs(C: int, NB: int, B: int) -> dict:
    """The built K15 at C rows of NB dims over B brokers, as the card
    reports it (:func:`ops.kernels.attrs`).  Needs the card."""
    lib = kernels.bind("corrected_accept", "corrected_accept_attrs",
                       [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    return kernels.attrs("corrected_accept", lib.corrected_accept_attrs, C,
                         NB, B)

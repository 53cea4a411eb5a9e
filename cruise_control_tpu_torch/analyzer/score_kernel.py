"""Candidate scoring: the exact cost delta and feasibility of columnar
candidate actions, and the hand-written CUDA kernel that computes it on
the card.

* K6 :func:`score_candidates` (``csrc/score_candidates.cu``) — plain twin
  :func:`_score_candidates`, the reference's function of that name
  (``tpu_optimizer.py:513``), held against it by the CPU tests.

The wrapper runs the plain twin for tensors that lie on the CPU, and for
CUDA tensors launches the kernel or raises; there is no fallback.  It
counts its launches in ``score_candidates.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.cost import (
    EVAC_BONUS,
    RACK_FIX_BONUS,
    broker_cost,
    pack_pload,
)
from cruise_control_tpu_torch.ops.grid import (
    _MAX_S,
    _NC,
    _NT,
    gather_pload as _gather_pload,
    grid_consts,
    slot_instance,
    terms_consts,
)

KIND_MOVE = 0
KIND_LEADERSHIP = 1

_INF = float("inf")
_P, _I = ctypes.c_void_p, ctypes.c_int


def _broker_cost(m, cfg, ca, load, leader_nwin, pot_nwout, rcount, lcount, b,
                 cload=None) -> torch.Tensor:
    """Per-broker soft-goal cost at broker index ``b`` (ops.cost.broker_cost)."""
    return broker_cost(
        cfg, ca, m.capacity[b.long()], load, leader_nwin, pot_nwout, rcount,
        lcount, cload=cload,
    )


def _score_candidates(m, cfg, ca, kind, cp, cs, cd):
    """Returns (delta_cost[N], feasible[N]) for columnar candidates (moves
    and leadership transfers).  Lower delta = better; infeasible
    candidates score +inf."""
    S = m.assignment.shape[1]
    is_lead = kind == KIND_LEADERSHIP
    cpl, csl = cp.long(), cs.long()
    row = m.assignment[cpl]                                   # [N, S]
    lead_cp, fol_cp, excl_cp, leadc_cp, folc_cp = _gather_pload(m, cp)
    slot_broker = torch.gather(row, 1, csl[:, None])[:, 0]
    leader_broker = torch.gather(
        row, 1, m.leader_slot[cpl].long()[:, None])[:, 0]
    src = torch.where(is_lead, leader_broker, slot_broker)
    dst = torch.where(is_lead, slot_broker, cd.to(slot_broker.dtype))
    dst_c = dst.clamp_min(0).long()

    leader_now = m.leader_slot[cpl] == cs
    occupied = row != EMPTY_SLOT
    slot_racks = torch.where(occupied, m.rack[row.clamp_min(0).long()],
                             torch.full_like(row, -1))
    my_rack = torch.gather(slot_racks, 1, csl[:, None])[:, 0]
    ar = torch.arange(S, device=row.device)
    lower = ar[None, :] < cs[:, None]
    rack_viol_here = (
        lower & (slot_racks == my_rack[:, None]) & occupied
    ).any(dim=1)
    move_load = torch.where(leader_now[:, None], lead_cp, fol_cp)
    lead_delta = lead_cp - fol_cp
    delta_load = torch.where(is_lead[:, None], lead_delta, move_load)
    has_cap = m.leader_cload is not None
    if has_cap:
        cmove_load = torch.where(leader_now[:, None], leadc_cp, folc_cp)
        clead_delta = leadc_cp - folc_cp
        cdelta_load = torch.where(is_lead[:, None], clead_delta, cmove_load)
        b_cload = m.broker_cload
    else:
        cdelta_load = delta_load
        b_cload = m.broker_load

    # ---- feasibility (fused hard-goal mask) -----------------------------------
    slot_exists = slot_broker != EMPTY_SLOT
    dup = (row == dst[:, None]).any(dim=1)
    dup = dup | (m.offline_origin[cpl] == dst[:, None]).any(dim=1)
    cand_rack = m.rack[dst_c]
    other_racks = torch.where(
        occupied & (ar[None, :] != cs[:, None]), slot_racks,
        torch.full_like(slot_racks, -1),
    )
    rack_clash = (other_racks == cand_rack[:, None]).any(dim=1)
    dst_cload_after = b_cload[dst_c] + cdelta_load
    cap_ok = (
        dst_cload_after
        <= m.capacity[dst_c] * ca["cap_threshold"][None, :] + 1e-6
    ).all(dim=1)
    rcount_ok = m.rcount[dst_c] + 1.0 <= ca["max_replicas"]
    cs_c = cs.clamp(0, S - 1).long()
    excluded = excl_cp & ~m.must_move[cp.clamp_min(0).long(), cs_c]
    must_move_here = m.must_move[cpl, cs_c]

    move_ok = (
        (dst >= 0)
        & (src != dst)
        & slot_exists
        & m.dest_ok[dst_c]
        & ~dup
        & ~rack_clash
        & cap_ok
        & rcount_ok
        & ~excluded
        & (~leader_now | m.lead_ok[dst_c])
    )
    lead_feasible = (
        slot_exists
        & ~leader_now
        & m.lead_ok[dst_c]
        & ~must_move_here
        & ~excl_cp
        & cap_ok
    )
    feasible = torch.where(is_lead, lead_feasible, move_ok)

    # ---- cost delta -----------------------------------------------------------
    lead_or_now = is_lead | leader_now
    l_delta = torch.where(lead_or_now, 1.0, 0.0)
    r_delta = torch.where(is_lead, 0.0, 1.0)
    lnwin_delta = torch.where(lead_or_now, lead_cp[:, Resource.NW_IN], 0.0)
    pot_delta = torch.where(is_lead, 0.0, lead_cp[:, Resource.NW_OUT])

    src_c = src.clamp_min(0).long()
    f_src_old = _broker_cost(
        m, cfg, ca, m.broker_load[src_c], m.leader_nwin[src_c],
        m.pot_nwout[src_c], m.rcount[src_c], m.lcount[src_c], src_c,
        cload=b_cload[src_c] if has_cap else None,
    )
    f_src_new = _broker_cost(
        m, cfg, ca,
        m.broker_load[src_c] - delta_load,
        m.leader_nwin[src_c] - lnwin_delta,
        m.pot_nwout[src_c] - pot_delta,
        m.rcount[src_c] - r_delta,
        m.lcount[src_c] - l_delta,
        src_c,
        cload=(b_cload[src_c] - cdelta_load) if has_cap else None,
    )
    f_dst_old = _broker_cost(
        m, cfg, ca, m.broker_load[dst_c], m.leader_nwin[dst_c],
        m.pot_nwout[dst_c], m.rcount[dst_c], m.lcount[dst_c], dst_c,
        cload=b_cload[dst_c] if has_cap else None,
    )
    f_dst_new = _broker_cost(
        m, cfg, ca,
        m.broker_load[dst_c] + delta_load,
        m.leader_nwin[dst_c] + lnwin_delta,
        m.pot_nwout[dst_c] + pot_delta,
        m.rcount[dst_c] + r_delta,
        m.lcount[dst_c] + l_delta,
        dst_c,
        cload=dst_cload_after if has_cap else None,
    )
    delta = (f_src_new - f_src_old) + (f_dst_new - f_dst_old)
    friction = (
        torch.where(is_lead, 0.0,
                    move_load[:, Resource.DISK] / ca["avg_disk_cap"])
        * cfg.w_move_size
    )
    evac = torch.where(must_move_here & ~is_lead, EVAC_BONUS, 0.0)
    rack_fix = torch.where(rack_viol_here & ~is_lead, RACK_FIX_BONUS, 0.0)
    delta = delta + friction + evac + rack_fix
    return delta.masked_fill(~feasible, _INF), feasible


# ---------------------------------------------------------------------------------
# K6: candidate scoring
# ---------------------------------------------------------------------------------

def _library():
    lib = kernels.bind("score_candidates", "score_candidates_launch",
                       [_P] * 21 + [_I] * 3 + [_P] * 5 + [_I, _P, _P])
    if not getattr(lib, "_cc_checked", False):
        lib.score_candidates_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.score_candidates_layout.restype = None
        layout = (ctypes.c_int * 3)()
        lib.score_candidates_layout(layout)
        if tuple(layout) != (_NC, _NT, _MAX_S):
            raise RuntimeError(f"score_candidates library layout "
                               f"{tuple(layout)} != {(_NC, _NT, _MAX_S)}")
        lib._cc_checked = True
        lib._cc_attrs = {}
    return lib


def score_candidates_attrs(S: int, has_cap: bool) -> dict:
    """The built K6 instance for S slots, capacity loads on or off, as the
    card reports it (:func:`ops.kernels.attrs`); cached, needs the card."""
    lib = _library()
    key = (slot_instance(S), bool(has_cap))
    if key not in lib._cc_attrs:
        lib.score_candidates_attrs.argtypes = [
            _I, _I, ctypes.POINTER(ctypes.c_int)]
        lib.score_candidates_attrs.restype = _I
        R = NUM_RESOURCES
        lib._cc_attrs[key] = kernels.attrs(
            "score_candidates", lib.score_candidates_attrs, S,
            4 * R + 1 if has_cap else 2 * R + 1)
    return lib._cc_attrs[key]


def _score_candidates_into(m, cfg, ca, kind, cp, cs, cd, out, feasible,
                           rows=None, n_rows=None, gate=None, want=1):
    """Plain twin of K6's incremental-rescore forms: unless the carry
    ``gate`` says the step is inactive or its FRESH flag is not ``want``,
    :func:`_score_candidates` of every candidate, or of the first
    ``n_rows[0]`` entries of the index list ``rows``, written into ``out``
    and (unless None) ``feasible`` at each candidate's own index."""
    if gate is not None and not (int(gate[SS.ACTIVE])
                                 and int(gate[SS.FRESH]) == want):
        return out, feasible
    if rows is None:
        delta, ok = _score_candidates(m, cfg, ca, kind, cp, cs, cd)
        out.copy_(delta)
        if feasible is not None:
            feasible.copy_(ok)
        return out, feasible
    i = rows[:min(rows.shape[0], int(n_rows[0]))].long()
    delta, ok = _score_candidates(m, cfg, ca, kind[i], cp[i], cs[i], cd[i])
    out[i] = delta
    if feasible is not None:
        feasible[i] = ok
    return out, feasible


def score_candidates_work(N: int, B: int, S: int, W: int, NR: int,
                          has_cap: bool, n_part=None, n_brokers=None,
                          carry: bool = False):
    """K6's work → (bytes, operations) for N candidates: the four ids a
    candidate; each of ``n_part`` distinct partitions' row (slots,
    origins, must-move, leader slot, load row; N where not counted); each
    of ``n_brokers`` brokers read (tables as K2's, and its cost from K2's
    table; B where not counted); the constants; delta and the feasible
    flag out (the carry forms: the score alone).  Two broker costs after
    the move (~85 operations each; K2's table gives the two before it)
    and ~60 more a candidate."""
    n_part = N if n_part is None else n_part
    n_brokers = B if n_brokers is None else n_brokers
    nbytes = (N * 16 + n_part * (9 * S + 4 + 4 * W)
              + n_brokers * (4 * (NR * (3 if has_cap else 2) + 4) + 6 + 4)
              + 4 * (3 * NR + 16) + N * (4 if carry else 5))
    return nbytes, N * 230


def score_candidates(m, cfg, ca, kind, cp, cs, cd, consts=None,
                     tconsts=None, checked: bool = False, out=None,
                     rows=None, n_rows=None, gate=None, want: int = 1,
                     bcost=None):
    """→ (delta f32 [N], +inf where infeasible; feasible bool [N]) of the
    candidates (kind, cp, cs, cd) — the plain twin
    :func:`_score_candidates`.  ``consts`` / ``tconsts`` are the constant
    blocks of :func:`ops.grid.grid_consts` and :func:`ops.grid.terms_consts`
    (built here when not given).  ``checked=True`` skips the input checks:
    the step loop checks once per call, since its tensors keep their
    types and shapes from step to step.

    The incremental rescore's forms (plain twin
    :func:`_score_candidates_into`): ``out`` = (delta, feasible) to write
    into (the carry's leadership scores; ``feasible`` may be None, and is
    then not written) instead of new tensors; ``rows``
    (int32 [n]) with ``n_rows`` (int32 [1]) scores only the first
    ``min(n, n_rows)`` candidates of that index list, each written at its
    own index; ``gate`` (the step loop's carry) runs it only on an active
    step whose FRESH flag is ``want``.

    ``bcost`` (f32 [B]) is every broker's cost as it stands on this model
    — K2's table (``ops.grid.grid_terms``, the dict's ``"bcost"``),
    written with no commit since — which the kernel reads in place of the
    two costs before the move; CUDA tensors need it.  The plain twin
    computes those costs itself and takes no table."""
    if (rows is None) != (n_rows is None):
        raise ValueError("score_candidates: rows and n_rows go together")
    if out is None and (rows is not None or gate is not None):
        raise ValueError("score_candidates: a row list or a gate writes "
                         "into out")
    if kernels.on_cpu(cp):
        if out is None:
            return _score_candidates(m, cfg, ca, kind, cp, cs, cd)
        return _score_candidates_into(m, cfg, ca, kind, cp, cs, cd, *out,
                                      rows, n_rows, gate, want)
    dev = cp.device
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    N = cp.shape[0]
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
    if W != (4 * R + 1 if has_cap else 2 * R + 1) or not 1 <= S <= _MAX_S \
            or N < 1:
        raise ValueError(f"score_candidates: partition table width {W}, "
                         f"S={S}, N={N} out of range")
    if bcost is None:
        raise ValueError("score_candidates: the kernel reads K2's broker "
                         "cost table; pass bcost")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    chk = functools.partial(kernels.check, "score_candidates", device=dev)
    for name, x, dt, shape in () if checked else (
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
        ("kind", kind, i32, (N,)),
        ("cp", cp, i32, (N,)),
        ("cs", cs, i32, (N,)),
        ("cd", cd, i32, (N,)),
        ("consts", consts, f32, (_NC,)),
        ("tconsts", tconsts, f32, (_NT,)),
        ("bcost", bcost, f32, (B,)),
    ):
        chk(name, x, dt, shape)
    if has_cap and not checked:
        chk("broker_cload", m.broker_cload, f32, (B, R))
    if out is None:
        delta = torch.empty(N, dtype=f32, device=dev)
        feasible = torch.empty(N, dtype=b8, device=dev)
    else:
        delta, feasible = out
    n = N
    if rows is not None:
        n = rows.shape[0]
    for name, x, dt, shape in () if checked else (
        *((("out", delta, f32, (N,)),) if out is not None else ()),
        *((("feasible", feasible, b8, (N,)),)
          if out is not None and feasible is not None else ()),
        *((("rows", rows, i32, (n,)), ("n_rows", n_rows, i32, (1,)))
          if rows is not None else ()),
        *((("gate", gate, i32, (SS.NSTATE,)),) if gate is not None else ()),
    ):
        chk(name, x, dt, shape)
    if n < 1:
        return delta, feasible
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = _library().score_candidates_launch(
        m.assignment.data_ptr(), m.leader_slot.data_ptr(),
        m.offline_origin.data_ptr(), m.must_move.data_ptr(),
        table.data_ptr(), m.rack.data_ptr(), m.dest_ok.data_ptr(),
        m.lead_ok.data_ptr(), m.capacity.data_ptr(),
        m.broker_load.data_ptr(),
        m.broker_cload.data_ptr() if has_cap else None,
        m.leader_nwin.data_ptr(), m.pot_nwout.data_ptr(),
        m.rcount.data_ptr(), m.lcount.data_ptr(), kind.data_ptr(),
        cp.data_ptr(), cs.data_ptr(), cd.data_ptr(), consts.data_ptr(),
        tconsts.data_ptr(), n, S, W, delta.data_ptr(), ptr(feasible),
        ptr(rows), ptr(n_rows), ptr(gate), int(want), bcost.data_ptr(),
        kernels.stream(dev),
    )
    kernels.launched("score_candidates", err)
    score_candidates.launches += 1
    kernels.note_work("score_candidates", lambda: score_candidates_work(
        n, B, S, W, R, has_cap, carry=out is not None))
    return delta, feasible


score_candidates.launches = 0

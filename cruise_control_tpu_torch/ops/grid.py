"""Grid-form candidate scoring: K source replicas × D destination brokers,
and its per-row top-R.

Per-source terms are computed once on [K] columns (:func:`move_grid_terms`,
plain torch — O(K)), per-destination terms once on [D] columns, and each
(k, d) score is broadcast arithmetic.  The reference lets XLA fuse that
broadcast into the consuming top-k so [K, D] is never materialized; eager
PyTorch cannot, so the fused chain is a hand-written CUDA kernel here
(``csrc/grid_top_r.cu``, kernel K1), reached through :func:`grid_top_r`.

:func:`move_grid_scores` + a stable sort (:func:`grid_top_r_plain`) is the
kernel's plain twin: the specification the CPU tests hold against the JAX
reference, and what the wrapper runs for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.ops.cost import (
    EVAC_BONUS,
    RACK_FIX_BONUS,
    broker_cost,
    pack_pload,
    pload_rows,
    rcount_terms,
)


def gather_pload(m, idx):
    """ONE row-gather of the packed immutable partition table for indices
    ``idx`` → ``(leader_load, follower_load, excluded, leader_cload,
    follower_cload)`` rows (cloads ``None`` when percentile is off)."""
    table = getattr(m, "pload", None)
    if table is None:
        table = pack_pload(
            m.leader_load, m.follower_load, m.excluded,
            m.leader_cload, m.follower_cload,
        )
    return pload_rows(table[idx.long()])


def move_grid_terms(
    m,
    cfg,
    ca: Dict[str, torch.Tensor],
    kp: torch.Tensor,         # int32 [K] source partition
    ks: torch.Tensor,         # int32 [K] source slot
) -> Dict[str, torch.Tensor]:
    """Per-source ([K]-shaped) terms feeding the grid scorer."""
    S = m.assignment.shape[1]
    kpl, ksl = kp.long(), ks.long()
    row = m.assignment[kpl]                                  # [K, S]
    lead_kp, fol_kp, excl_kp, leadc_kp, folc_kp = gather_pload(m, kp)
    slot_broker = torch.gather(row, 1, ksl[:, None])[:, 0]
    src = slot_broker
    src_c = src.clamp_min(0).long()
    leader_now = m.leader_slot[kpl] == ks
    slot_exists = slot_broker != EMPTY_SLOT

    occupied = row != EMPTY_SLOT
    slot_racks = torch.where(occupied, m.rack[row.clamp_min(0).long()],
                             torch.full_like(row, -1))
    my_rack = torch.gather(slot_racks, 1, ksl[:, None])[:, 0]
    ar = torch.arange(S, device=row.device)
    lower = ar[None, :] < ks[:, None]
    rack_viol_here = (
        lower & (slot_racks == my_rack[:, None]) & occupied
    ).any(dim=1)
    # racks of the *other* replicas of p (self slot masked to -1: broker
    # racks are non-negative so -1 never matches a destination rack)
    other_racks = torch.where(occupied & (ar[None, :] != ks[:, None]),
                              slot_racks, torch.full_like(slot_racks, -1))

    move_load = torch.where(leader_now[:, None], lead_kp, fol_kp)  # [K, R]
    cmove_load = (
        move_load if leadc_kp is None
        else torch.where(leader_now[:, None], leadc_kp, folc_kp)
    )
    must_move = m.must_move[kpl, ks.clamp(0, S - 1).long()]
    excluded = excl_kp & ~must_move
    l_delta = leader_now.to(move_load.dtype)
    lnwin_delta = torch.where(leader_now, lead_kp[:, Resource.NW_IN], 0.0)
    pot_delta = lead_kp[:, Resource.NW_OUT]

    has_cap = m.broker_cload is not None
    f_src_old = broker_cost(
        cfg, ca, m.capacity[src_c], m.broker_load[src_c],
        m.leader_nwin[src_c], m.pot_nwout[src_c], m.rcount[src_c],
        m.lcount[src_c],
        cload=m.broker_cload[src_c] if has_cap else None,
    )
    f_src_new = broker_cost(
        cfg, ca, m.capacity[src_c], m.broker_load[src_c] - move_load,
        m.leader_nwin[src_c] - lnwin_delta, m.pot_nwout[src_c] - pot_delta,
        m.rcount[src_c] - 1.0, m.lcount[src_c] - l_delta,
        cload=(m.broker_cload[src_c] - cmove_load) if has_cap else None,
    )
    friction = (move_load[:, Resource.DISK] / ca["avg_disk_cap"]
                * cfg.w_move_size)
    evac = torch.where(must_move, EVAC_BONUS, 0.0)
    rack_fix = torch.where(rack_viol_here, RACK_FIX_BONUS, 0.0)
    src_term = (f_src_new - f_src_old) + friction + evac + rack_fix

    return {
        "row": row,
        "origin_row": m.offline_origin[kpl],
        "other_racks": other_racks,
        "src": src,
        "leader_now": leader_now,
        "slot_exists": slot_exists,
        "excluded": excluded,
        "must_move": must_move,
        "move_load": move_load,
        "cmove_load": cmove_load,
        "l_delta": l_delta,
        "lnwin_delta": lnwin_delta,
        "pot_delta": pot_delta,
        "src_term": src_term,
    }


def _dest_columns(m, ca, dest_pool):
    """Per-destination gathers shared by the plain grid and the kernel's
    destination table."""
    d_c = dest_pool.clamp_min(0).long()
    d_cap = m.capacity[d_c]                                   # [D, R]
    d_load = m.broker_load[d_c]                               # [D, R]
    d_cload = m.broker_cload[d_c] if m.broker_cload is not None else d_load
    # hard-capacity limit per (d, r), computed once for both paths
    lim = d_cap * ca["cap_threshold"] + 1e-6
    return d_c, d_cap, d_load, d_cload, lim


def move_grid_scores(
    m,
    cfg,
    ca: Dict[str, torch.Tensor],
    kp: torch.Tensor,
    ks: torch.Tensor,
    dest_pool: torch.Tensor,  # int32 [D] (may contain -1 padding)
    terms: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Scores [K, D] for every (source replica, destination) move; +inf where
    infeasible.  Materializes [K, D] (and [K, D, R]) — the plain path."""
    t = terms if terms is not None else move_grid_terms(m, cfg, ca, kp, ks)
    has_cap = m.broker_cload is not None
    d_c, d_cap, d_load, d_cload, lim = _dest_columns(m, ca, dest_pool)
    d_rack = m.rack[d_c]                                      # [D]

    # ---- feasibility [K, D] --------------------------------------------------
    dup = (t["row"][:, :, None] == d_c[None, None, :]).any(dim=1)
    dup = dup | (t["origin_row"][:, :, None] == d_c[None, None, :]).any(dim=1)
    rack_clash = (
        t["other_racks"][:, :, None] == d_rack[None, None, :]
    ).any(dim=1)
    load_after = d_load[None, :, :] + t["move_load"][:, None, :]  # [K, D, R]
    cload_after = (
        load_after if not has_cap
        else d_cload[None, :, :] + t["cmove_load"][:, None, :]
    )
    cap_ok = (cload_after <= lim[None]).all(dim=2)
    feasible = (
        (dest_pool[None, :] >= 0)
        & (t["src"][:, None] != dest_pool[None, :])
        & t["slot_exists"][:, None]
        & m.dest_ok[d_c][None, :]
        & ~dup
        & ~rack_clash
        & cap_ok
        & (m.rcount[d_c][None, :] + 1.0 <= ca["max_replicas"])
        & ~t["excluded"][:, None]
        & (~t["leader_now"][:, None] | m.lead_ok[d_c][None, :])
    )

    # ---- destination cost delta [K, D] ---------------------------------------
    f_dst_old = broker_cost(
        cfg, ca, d_cap, d_load, m.leader_nwin[d_c], m.pot_nwout[d_c],
        m.rcount[d_c], m.lcount[d_c],
        cload=d_cload if has_cap else None,
    )                                                         # [D]
    f_dst_new = broker_cost(
        cfg, ca,
        d_cap[None],
        load_after,
        m.leader_nwin[d_c][None, :] + t["lnwin_delta"][:, None],
        m.pot_nwout[d_c][None, :] + t["pot_delta"][:, None],
        m.rcount[d_c][None, :] + 1.0,
        m.lcount[d_c][None, :] + t["l_delta"][:, None],
        cload=cload_after if has_cap else None,
    )                                                         # [K, D]
    delta = t["src_term"][:, None] + (f_dst_new - f_dst_old[None, :])
    return delta.masked_fill(~feasible, float("inf"))


# ---------------------------------------------------------------------------------
# K1: fused grid score + per-row top-R
# ---------------------------------------------------------------------------------

#: packed-column widths; csrc/grid_top_r.cu declares the same layout and
#: the wrapper checks it against the built library
_NR = NUM_RESOURCES
_SF = 2 * _NR + 4
_DF = 4 * _NR + 6
_DI = 3
_NC = 3 * _NR + 9
_TOPR = 8
_MAX_S = 8
_WARPS = 8
#: H100 shared memory a block may use (bytes): bounds the staged D
_SMEM_LIMIT = 232_448

#: operations per (k, d) cell, counted from the kernel source: the
#: feasibility test (dest flags, src != dest, lead_ok; three compares per
#: replica slot; an add and a compare per resource of the capacity test)
#: and the running top-8 compare are charged to every cell; the inlined
#: broker_cost and the score (83 operations, a division counted as one)
#: to feasible cells only
GRID_CELL_OPS_PER_SLOT = 3
GRID_CELL_OPS = 4 + 2 * _NR
GRID_FEASIBLE_OPS = 83


def grid_top_r_ops(n_cells: int, n_feasible: int, slots: int) -> int:
    """Arithmetic operations K1 does for a grid of ``n_cells`` cells of
    which ``n_feasible`` are feasible (the data decide how many pay for
    the cost arithmetic)."""
    return (n_cells * (GRID_CELL_OPS + GRID_CELL_OPS_PER_SLOT * slots)
            + n_feasible * GRID_FEASIBLE_OPS)


def grid_top_r_plain(m, cfg, ca, kp, ks, dest_pool, terms, R: int):
    """Plain twin of K1: the materialized grid, then a stable ascending
    sort per row (ties to the lowest pool index, +inf entries included) →
    (score f32 [K, R], pool index int32 [K, R])."""
    g = move_grid_scores(m, cfg, ca, kp, ks, dest_pool, terms=terms)
    vals, idx = torch.sort(g, dim=1, stable=True)
    return vals[:, :R].contiguous(), idx[:, :R].to(torch.int32).contiguous()


def grid_consts(cfg, ca, device) -> torch.Tensor:
    """f32 [NC] constant block of K1 (layout: csrc/grid_top_r.cu).  Built
    once per search: it holds only constraints and weights."""
    f = torch.float32
    scal = torch.stack([
        ca["avg_lcount"].to(f), ca["lcount_upper"].to(f),
        ca["lcount_lower"].to(f), ca["leader_nwin_upper"].to(f),
    ]).to(device)
    w = torch.tensor([cfg.w_util_var, cfg.w_bound, cfg.w_leader_count,
                      cfg.w_leader_nwin, cfg.w_pot_nwout], dtype=f,
                     device=device)
    return torch.cat([
        ca["util_lower"].to(device, f), ca["util_upper"].to(device, f),
        ca["cap_threshold"].to(device, f), scal, w,
    ]).contiguous()


def _pack_sources(t) -> Tuple[torch.Tensor, torch.Tensor]:
    f = torch.float32
    src_f = torch.cat([
        t["move_load"], t["cmove_load"], t["l_delta"][:, None],
        t["lnwin_delta"][:, None], t["pot_delta"][:, None],
        t["src_term"][:, None],
    ], dim=1).to(f).contiguous()
    flags = t["leader_now"].to(torch.int32) | (
        (t["slot_exists"] & ~t["excluded"]).to(torch.int32) << 1
    )
    src_i = torch.cat([
        t["row"], t["origin_row"], t["other_racks"], t["src"][:, None],
        flags[:, None],
    ], dim=1).to(torch.int32).contiguous()
    return src_f, src_i


def _pack_dests(m, cfg, ca, dest_pool) -> Tuple[torch.Tensor, torch.Tensor]:
    d_c, d_cap, d_load, d_cload, lim = _dest_columns(m, ca, dest_pool)
    has_cap = m.broker_cload is not None
    f_old = broker_cost(
        cfg, ca, d_cap, d_load, m.leader_nwin[d_c], m.pot_nwout[d_c],
        m.rcount[d_c], m.lcount[d_c],
        cload=d_cload if has_cap else None,
    )
    rc1 = m.rcount[d_c] + 1.0
    c_rc, c_rc_b = rcount_terms(cfg, ca, rc1)
    dst_f = torch.cat([
        torch.clamp_min(d_cap, 1e-9), lim, d_load, d_cload,
        torch.stack([m.leader_nwin[d_c], m.pot_nwout[d_c], m.lcount[d_c],
                     c_rc, c_rc_b, f_old], dim=1),
    ], dim=1).to(torch.float32).contiguous()
    static_ok = ((dest_pool >= 0) & m.dest_ok[d_c]
                 & (rc1 <= ca["max_replicas"]))
    flags = static_ok.to(torch.int32) | (m.lead_ok[d_c].to(torch.int32) << 1)
    dst_i = torch.stack([d_c.to(torch.int32), m.rack[d_c].to(torch.int32),
                         flags], dim=1).contiguous()
    return dst_f, dst_i


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"grid_top_r: {name} must be a contiguous {dtype} {tuple(shape)} "
            f"tensor on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}"
        )


def _library():
    from cruise_control_tpu_torch.ops import kernels

    lib = kernels.load("grid_top_r")
    if not getattr(lib, "_cc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grid_top_r_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                          p, p, p]
        lib.grid_top_r_launch.restype = ctypes.c_int
        lib.grid_top_r_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.grid_top_r_layout.restype = None
        layout = (ctypes.c_int * 7)()
        lib.grid_top_r_layout(layout)
        want = (_SF, _DF, _DI, _NC, _TOPR, _MAX_S, _WARPS)
        if tuple(layout) != want:
            raise RuntimeError(
                f"grid_top_r library layout {tuple(layout)} != {want}")
        lib._cc_typed = True
    return lib


def pack_grid_inputs(m, cfg, ca, dest_pool, terms, consts=None) -> dict:
    """K1's packed, validated inputs (layout: csrc/grid_top_r.cu)."""
    dev = dest_pool.device
    K, D = terms["src"].shape[0], dest_pool.shape[0]
    S = m.assignment.shape[1]
    if not 1 <= S <= _MAX_S:
        raise ValueError(f"grid_top_r: replica slots S={S} outside [1, {_MAX_S}]")
    if (_DF + _DI) * D * 4 > _SMEM_LIMIT:
        raise ValueError(
            f"grid_top_r: D={D} destinations need {(_DF + _DI) * D * 4} B "
            f"of shared memory (limit {_SMEM_LIMIT})")
    if consts is None:
        consts = grid_consts(cfg, ca, dev)
    src_f, src_i = _pack_sources(terms)
    dst_f, dst_i = _pack_dests(m, cfg, ca, dest_pool)
    _check("src_f", src_f, torch.float32, (K, _SF), dev)
    _check("src_i", src_i, torch.int32, (K, 3 * S + 2), dev)
    _check("dst_f", dst_f, torch.float32, (D, _DF), dev)
    _check("dst_i", dst_i, torch.int32, (D, _DI), dev)
    _check("consts", consts, torch.float32, (_NC,), dev)
    return dict(src_f=src_f, src_i=src_i, dst_f=dst_f, dst_i=dst_i,
                consts=consts, K=K, D=D, S=S,
                has_cap=int(m.broker_cload is not None))


def launch_grid_top_r(packed: dict, R: int):
    """Launch K1 on packed inputs → (score, pool index) [K, R].  Not
    counted: :func:`grid_top_r` is the counted entry point."""
    K, D, S = packed["K"], packed["D"], packed["S"]
    if not 1 <= R <= min(_TOPR, D):
        raise ValueError(f"grid_top_r: R={R} outside [1, min({_TOPR}, D={D})]")
    dev = packed["dst_f"].device
    out_s = torch.empty((K, R), dtype=torch.float32, device=dev)
    out_i = torch.empty((K, R), dtype=torch.int32, device=dev)
    if K == 0:
        return out_s, out_i
    lib = _library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, _SMEM_LIMIT // ((_DF + _DI) * D * 4 + 1024))
    grid = max(1, min(-(-K // _WARPS), sms * per_sm))
    err = lib.grid_top_r_launch(
        packed["src_f"].data_ptr(), packed["src_i"].data_ptr(),
        packed["dst_f"].data_ptr(), packed["dst_i"].data_ptr(),
        packed["consts"].data_ptr(), K, D, S, R, packed["has_cap"], grid,
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grid_top_r: kernel launch failed (CUDA error {err})")
    return out_s, out_i


def grid_top_r(m, cfg, ca, kp, ks, dest_pool, terms, R: int,
               consts: Optional[torch.Tensor] = None):
    """Per-row top-R of the move grid → (score f32 [K, R] ascending, pool
    index int32 [K, R]), ties to the lowest pool index.

    CPU tensors run the plain twin (:func:`grid_top_r_plain`).  CUDA
    tensors launch K1 (``csrc/grid_top_r.cu``) or raise — there is no
    fallback.  ``consts`` (:func:`grid_consts`) may be passed in so a
    search builds it once.  Counts its launches in ``grid_top_r.launches``.
    """
    if dest_pool.device.type == "cpu":
        return grid_top_r_plain(m, cfg, ca, kp, ks, dest_pool, terms, R)
    packed = pack_grid_inputs(m, cfg, ca, dest_pool, terms, consts)
    out = launch_grid_top_r(packed, R)
    if packed["K"]:
        grid_top_r.launches += 1
    return out


grid_top_r.launches = 0

"""Grid-form candidate scoring: K source replicas × D destination brokers,
and its per-row top-R.

Per-source terms are computed once on [K] columns (:func:`move_grid_terms`,
plain torch — O(K)), per-destination terms once on [D] columns, and each
(k, d) score is broadcast arithmetic.  The reference lets XLA fuse that
broadcast into the consuming top-k so [K, D] is never materialized; eager
PyTorch cannot, so the fused chain is a hand-written CUDA kernel here
(``csrc/grid_top_r.cu``, kernel K1), launched by :func:`launch_grid_top_r`.

:func:`move_grid_scores` + a stable sort (:func:`grid_top_r_plain`) is the
kernel's plain twin: the specification the CPU tests hold against the JAX
reference, and what the wrapper runs for tensors that lie on the CPU.

K1's inputs are packed per-source and per-destination tables.  On the card
a second kernel, K2 (``csrc/grid_terms.cu``, :func:`grid_terms`), computes
:func:`move_grid_terms` and the destination columns and writes them in that
packed layout directly; its plain twin is :func:`grid_terms_plain`
(``move_grid_terms`` → ``_pack_sources`` / ``_pack_dests``).
:func:`grid_rescore` is the step's entry: K2 then K1 on the card, the plain
twins on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from cruise_control_tpu_torch.analyzer import step_state as SS
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
from cruise_control_tpu_torch.ops import kernels


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
#: K1's warps a block (csrc/grid_top_r.cu) and the words of a staged
#: destination row (csrc/grid_cell.cuh: CST)
_WARPS = 32
_CST = _DF + 7
#: K1's static shared memory: each warp's top-R candidates (f32, int32)
_K1_STATIC_SMEM = _WARPS * _TOPR * 8
#: K2's extra constant block (:func:`terms_consts`)
_NT = 7
#: src_f column of the source term (K1 layout)
SRC_TERM_COL = _SF - 1

#: the least operations K1's function needs, counted on csrc/grid_cell.cuh:
#: every cell pays the feasibility test (dest flags, src != dest, lead_ok;
#: three compares per replica slot; an add and a compare per resource of
#: the capacity test) and the running top-8 compare; a feasible cell pays
#: the inlined broker_cost and the score (71 operations, a division
#: counted as one); and a destination column pays its two leader-count
#: cost terms (12 operations) for each leader delta a source row can bring,
#: 0 and 1, once a launch and not once a cell
GRID_CELL_OPS_PER_SLOT = 3
GRID_CELL_OPS = 4 + 2 * _NR
GRID_FEASIBLE_OPS = 71
GRID_COLUMN_OPS = 2 * 12


def grid_top_r_ops(n_cells: int, n_feasible: int, slots: int,
                   n_cols: int) -> int:
    """Arithmetic operations of a grid of ``n_cells`` cells, ``n_feasible``
    of them feasible (the data decide how many pay for the cost
    arithmetic), over ``n_cols`` destination columns."""
    return (n_cells * (GRID_CELL_OPS + GRID_CELL_OPS_PER_SLOT * slots)
            + n_feasible * GRID_FEASIBLE_OPS + n_cols * GRID_COLUMN_OPS)


def slot_instance(S: int) -> int:
    """The replica slots of the K1 / K17 instance that runs a cluster of S
    slots: 1, 2, 3 and 4 exactly, 5-8 on the instance of 8 (padded slots
    never match; csrc/grid_cell.cuh: slot_instance).  Each is built with
    and without capacity loads."""
    if not 1 <= S <= _MAX_S:
        raise ValueError(f"grid_top_r: replica slots S={S} outside "
                         f"[1, {_MAX_S}]")
    return S if S <= 4 else _MAX_S


def grid_top_r_smem(D: int) -> int:
    """Dynamic shared memory (bytes) of a K1 block over D destinations:
    one staged row of ``_CST`` words a destination."""
    return _CST * D * 4


def grid_top_r_geometry(n: int, D: int, sms: int,
                        per_sm: int) -> Tuple[int, int]:
    """K1's launch over a list of ``n`` rows (the full grid's K, or a row
    list's capacity) and D destinations, on ``sms`` SMs that each hold
    ``per_sm`` blocks → (W, grid): W warps a row, a power of two, as many
    as the card's warps allow for ``n`` rows, at most one a 32
    destinations and at most a block's warps; and one persistent wave of
    at most ``sms · per_sm`` blocks of ``_WARPS / W`` rows."""
    card = sms * max(per_sm, 1) * _WARPS
    W = 1
    while 2 * W <= _WARPS and 2 * W * n <= card and 2 * W * 32 <= D:
        W *= 2
    groups = _WARPS // W
    return W, max(1, min(-(-n // groups), sms * max(per_sm, 1)))


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
    kernels.check("grid_top_r", name, x, dtype, shape, device)


def _library():
    lib = kernels.load("grid_top_r")
    if not getattr(lib, "_cc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grid_top_r_launch.argtypes = [p] * 5 + [i] * 7 + [p] * 5 + \
            [i, i, p]
        lib.grid_top_r_launch.restype = ctypes.c_int
        lib.grid_top_r_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.grid_top_r_layout.restype = None
        lib.grid_top_r_attrs.argtypes = [i, i, i,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.grid_top_r_attrs.restype = ctypes.c_int
        layout = (ctypes.c_int * 8)()
        lib.grid_top_r_layout(layout)
        want = (_SF, _DF, _DI, _NC, _TOPR, _MAX_S, _WARPS, _CST)
        if tuple(layout) != want:
            raise RuntimeError(
                f"grid_top_r library layout {tuple(layout)} != {want}")
        lib._cc_attrs = {}
        lib._cc_typed = True
    return lib


def grid_top_r_attrs(S: int, has_cap: int, D: int) -> dict:
    """The built K1 instance for S slots, capacity loads on or off, at D
    destinations, as the card reports it: registers and spilled (local)
    bytes a thread, static and dynamic shared bytes, and the blocks an SM
    holds at once.  Cached by (instance, has_cap, D); needs the card."""
    lib = _library()
    key = (slot_instance(S), int(has_cap), D)
    if key not in lib._cc_attrs:
        lib._cc_attrs[key] = kernels.attrs("grid_top_r", lib.grid_top_r_attrs,
                                           S, int(has_cap), D)
    return lib._cc_attrs[key]


def _check_widths(S: int, D: int) -> None:
    slot_instance(S)
    if grid_top_r_smem(D) + _K1_STATIC_SMEM > kernels.SMEM_LIMIT:
        raise ValueError(
            f"grid_top_r: D={D} destinations need {grid_top_r_smem(D)} B "
            f"of shared memory (limit {kernels.SMEM_LIMIT})")


def pack_grid_inputs(m, cfg, ca, dest_pool, terms, consts=None) -> dict:
    """K1's packed, validated inputs (layout: csrc/grid_top_r.cu) from
    :func:`move_grid_terms`' output — plain torch, the packing half of
    K2's plain twin."""
    dev = dest_pool.device
    K, D = terms["src"].shape[0], dest_pool.shape[0]
    S = m.assignment.shape[1]
    _check_widths(S, D)
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


def launch_grid_top_r(packed: dict, R: int, out=None, rows=None,
                      n_rows=None, gate=None, want: int = 1,
                      dest_terms: bool = False):
    """K1's wrapper: launch ``csrc/grid_top_r.cu`` on K2's packed tables
    (:func:`grid_terms`) → (score f32 [K, R] ascending, pool index int32
    [K, R]), ties to the lowest pool index: the instance of the cluster's
    slot count (:func:`slot_instance`), in the geometry of
    :func:`grid_top_r_geometry`.  CUDA tensors only: the step
    reaches K1 through :func:`grid_rescore` (or :func:`grid_rescore_carry`),
    which runs the plain twin for CPU tensors.  Counts its launches in
    ``launch_grid_top_r.launches``.

    The incremental rescore's forms: ``out`` = (score, index) [K, R] to
    write into (the carry) instead of new tensors; ``rows`` (int32 [n]) with
    ``n_rows`` (int32 [1] on the card) restricts it to the first
    ``min(n, n_rows)`` rows of that list, each written at its own row;
    ``gate`` (the step loop's carry) runs it only on an active step whose
    FRESH flag is ``want``; ``dest_terms`` writes score − src_term."""
    K, D, S = packed["K"], packed["D"], packed["S"]
    if not 1 <= R <= min(_TOPR, D):
        raise ValueError(f"grid_top_r: R={R} outside [1, min({_TOPR}, D={D})]")
    dev = packed["dst_f"].device
    if kernels.on_cpu(packed["dst_f"]):
        raise ValueError("grid_top_r: K1 takes CUDA tensors; grid_rescore "
                         "runs the plain twin for CPU tensors")
    if (rows is None) != (n_rows is None):
        raise ValueError("grid_top_r: rows and n_rows go together")
    _check_widths(S, D)
    _check("src_f", packed["src_f"], torch.float32, (K, _SF), dev)
    _check("src_i", packed["src_i"], torch.int32, (K, 3 * S + 2), dev)
    _check("dst_f", packed["dst_f"], torch.float32, (D, _DF), dev)
    _check("dst_i", packed["dst_i"], torch.int32, (D, _DI), dev)
    _check("consts", packed["consts"], torch.float32, (_NC,), dev)
    if out is None:
        out_s = torch.empty((K, R), dtype=torch.float32, device=dev)
        out_i = torch.empty((K, R), dtype=torch.int32, device=dev)
    else:
        out_s, out_i = out
        _check("out_s", out_s, torch.float32, (K, R), dev)
        _check("out_i", out_i, torch.int32, (K, R), dev)
    n = K
    if rows is not None:
        n = rows.shape[0]
        _check("rows", rows, torch.int32, (n,), dev)
        _check("n_rows", n_rows, torch.int32, (1,), dev)
    if gate is not None:
        _check("gate", gate, torch.int32, (SS.NSTATE,), dev)
    if n == 0:
        return out_s, out_i
    lib = _library()
    per_sm = grid_top_r_attrs(S, packed["has_cap"], D)["blocks_per_sm"]
    W, grid = grid_top_r_geometry(n, D, kernels.sm_count(dev), per_sm)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = lib.grid_top_r_launch(
        packed["src_f"].data_ptr(), packed["src_i"].data_ptr(),
        packed["dst_f"].data_ptr(), packed["dst_i"].data_ptr(),
        packed["consts"].data_ptr(), n, D, S, R, packed["has_cap"], W, grid,
        out_s.data_ptr(), out_i.data_ptr(), ptr(rows), ptr(n_rows),
        ptr(gate), int(want), int(dest_terms), kernels.stream(dev),
    )
    kernels.launched("grid_top_r", err)
    launch_grid_top_r.launches += 1
    return out_s, out_i


launch_grid_top_r.launches = 0


# ---------------------------------------------------------------------------------
# K2: the grid's source and destination terms, packed for K1
# ---------------------------------------------------------------------------------

def terms_consts(cfg, ca, device) -> torch.Tensor:
    """f32 [_NT] constants K2 needs beyond :func:`grid_consts` (layout:
    csrc/grid_terms.cu): avg_rcount, rcount_upper, rcount_lower, w_count,
    max_replicas, avg_disk_cap, w_move_size."""
    f = torch.float32
    return torch.stack([
        ca["avg_rcount"].to(device, f), ca["rcount_upper"].to(device, f),
        ca["rcount_lower"].to(device, f),
        torch.tensor(cfg.w_count, dtype=f, device=device),
        ca["max_replicas"].to(device, f), ca["avg_disk_cap"].to(device, f),
        torch.tensor(cfg.w_move_size, dtype=f, device=device),
    ]).contiguous()


def broker_costs_plain(m, cfg, ca) -> torch.Tensor:
    """f32 [B]: every broker's soft-goal cost as it stands
    (:func:`ops.cost.broker_cost` on its aggregates) — the table K2 writes
    for K6 (``bcost``), which reads it as the cost before a move."""
    return broker_cost(cfg, ca, m.capacity, m.broker_load, m.leader_nwin,
                       m.pot_nwout, m.rcount, m.lcount,
                       cload=m.broker_cload)


def grid_terms_plain(m, cfg, ca, kp, ks, dest_pool, consts=None,
                     bcost=None) -> dict:
    """Plain twin of K2: :func:`move_grid_terms`, then K1's packing, and
    :func:`broker_costs_plain` (the dict's ``"bcost"``, written into
    ``bcost`` (f32 [B]) where given); the dict also keeps the terms
    (``"terms"``) for the plain twins that take K2's output on the CPU."""
    terms = move_grid_terms(m, cfg, ca, kp, ks)
    table = broker_costs_plain(m, cfg, ca)
    return dict(pack_grid_inputs(m, cfg, ca, dest_pool, terms, consts),
                terms=terms,
                bcost=table if bcost is None else bcost.copy_(table))


def _terms_library():
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = kernels.bind("grid_terms", "grid_terms_launch",
                       [p] * 20 + [i] * 5 + [p] * 6)
    if not getattr(lib, "_cc_checked", False):
        lib.grid_terms_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.grid_terms_layout.restype = None
        layout = (ctypes.c_int * 6)()
        lib.grid_terms_layout(layout)
        want = (_SF, _DF, _DI, _NC, _NT, _MAX_S)
        if tuple(layout) != want:
            raise RuntimeError(
                f"grid_terms library layout {tuple(layout)} != {want}")
        lib._cc_checked = True
        lib._cc_attrs = {}
    return lib


def grid_terms_attrs(S: int, has_cap: bool) -> dict:
    """The built K2 instance for S slots, capacity loads on or off, as the
    card reports it (:func:`ops.kernels.attrs`); cached, needs the card."""
    lib = _terms_library()
    key = (slot_instance(S), bool(has_cap))
    if key not in lib._cc_attrs:
        lib.grid_terms_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.grid_terms_attrs.restype = ctypes.c_int
        lib._cc_attrs[key] = kernels.attrs(
            "grid_terms", lib.grid_terms_attrs, S,
            4 * _NR + 1 if has_cap else 2 * _NR + 1)
    return lib._cc_attrs[key]


def grid_terms(m, cfg, ca, kp, ks, dest_pool, consts=None,
               tconsts=None, bcost=None) -> dict:
    """K1's packed inputs for source rows (kp, ks) and the destination
    pool — the dict of :func:`pack_grid_inputs` — and every broker's cost
    as it stands (:func:`broker_costs_plain`; the dict's ``"bcost"``,
    written into ``bcost`` (f32 [B]) where given, else into a new
    tensor), which K6 reads on the same model.

    CPU tensors run the plain twin (:func:`grid_terms_plain`).  CUDA
    tensors launch K2 (``csrc/grid_terms.cu``) or raise.  Counts its
    launches in ``grid_terms.launches``."""
    if kernels.on_cpu(dest_pool):
        return grid_terms_plain(m, cfg, ca, kp, ks, dest_pool, consts,
                                bcost)
    dev = dest_pool.device
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    K, D = kp.shape[0], dest_pool.shape[0]
    _check_widths(S, D)
    if consts is None:
        consts = grid_consts(cfg, ca, dev)
    if tconsts is None:
        tconsts = terms_consts(cfg, ca, dev)
    table = m.pload if m.pload is not None else pack_pload(
        m.leader_load, m.follower_load, m.excluded,
        m.leader_cload, m.follower_cload)
    W = table.shape[1]
    has_cap = m.broker_cload is not None
    if W != (4 * _NR + 1 if has_cap else 2 * _NR + 1):
        raise ValueError(f"grid_terms: partition table width {W} with "
                         f"broker capacity loads {'on' if has_cap else 'off'}"
                         f" (takes {2 * _NR + 1} without, {4 * _NR + 1} "
                         "with)")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    chk = functools.partial(kernels.check, "grid_terms", device=dev)
    for name, x, dt, shape in (
        ("assignment", m.assignment, i32, (P, S)),
        ("leader_slot", m.leader_slot, i32, (P,)),
        ("offline_origin", m.offline_origin, i32, (P, S)),
        ("must_move", m.must_move, b8, (P, S)),
        ("pload", table, f32, (P, W)),
        ("rack", m.rack, i32, (B,)),
        ("dest_ok", m.dest_ok, b8, (B,)),
        ("lead_ok", m.lead_ok, b8, (B,)),
        ("capacity", m.capacity, f32, (B, _NR)),
        ("broker_load", m.broker_load, f32, (B, _NR)),
        ("leader_nwin", m.leader_nwin, f32, (B,)),
        ("pot_nwout", m.pot_nwout, f32, (B,)),
        ("rcount", m.rcount, f32, (B,)),
        ("lcount", m.lcount, f32, (B,)),
        ("kp", kp, i32, (K,)),
        ("ks", ks, i32, (K,)),
        ("dest_pool", dest_pool, i32, (D,)),
        ("consts", consts, f32, (_NC,)),
        ("tconsts", tconsts, f32, (_NT,)),
    ):
        chk(name, x, dt, shape)
    if has_cap:
        chk("broker_cload", m.broker_cload, f32, (B, _NR))
    if bcost is None:
        bcost = torch.empty(B, dtype=f32, device=dev)
    chk("bcost", bcost, f32, (B,))
    src_f = torch.empty((K, _SF), dtype=f32, device=dev)
    src_i = torch.empty((K, 3 * S + 2), dtype=i32, device=dev)
    dst_f = torch.empty((D, _DF), dtype=f32, device=dev)
    dst_i = torch.empty((D, _DI), dtype=i32, device=dev)
    packed = dict(src_f=src_f, src_i=src_i, dst_f=dst_f, dst_i=dst_i,
                  bcost=bcost, consts=consts, K=K, D=D, S=S,
                  has_cap=int(has_cap))
    lib = _terms_library()
    err = lib.grid_terms_launch(
        m.assignment.data_ptr(), m.leader_slot.data_ptr(),
        m.offline_origin.data_ptr(), m.must_move.data_ptr(),
        table.data_ptr(), m.rack.data_ptr(), m.dest_ok.data_ptr(),
        m.lead_ok.data_ptr(), m.capacity.data_ptr(),
        m.broker_load.data_ptr(),
        m.broker_cload.data_ptr() if has_cap else None,
        m.leader_nwin.data_ptr(), m.pot_nwout.data_ptr(),
        m.rcount.data_ptr(), m.lcount.data_ptr(), kp.data_ptr(),
        ks.data_ptr(), dest_pool.data_ptr(), consts.data_ptr(),
        tconsts.data_ptr(), K, D, B, S, W, src_f.data_ptr(),
        src_i.data_ptr(), dst_f.data_ptr(), dst_i.data_ptr(),
        bcost.data_ptr(), kernels.stream(dev),
    )
    kernels.launched("grid_terms", err)
    grid_terms.launches += 1
    return packed


grid_terms.launches = 0


def grid_rescore(m, cfg, ca, kp, ks, dest_pool, R: int, consts=None,
                 tconsts=None, bcost=None):
    """The step's move rescore → (src_term f32 [K], score f32 [K, R]
    ascending, pool index int32 [K, R]); every broker's cost as it stands
    is written into ``bcost`` (f32 [B]) where given, for K6.

    CPU tensors: :func:`move_grid_terms` and K1's plain twin.  CUDA
    tensors: K2 writes K1's packed tables, K1 ranks them, and the source
    term is read back from K2's table."""
    if kernels.on_cpu(dest_pool):
        terms = move_grid_terms(m, cfg, ca, kp, ks)
        vals, idx = grid_top_r_plain(m, cfg, ca, kp, ks, dest_pool, terms, R)
        if bcost is not None:
            bcost.copy_(broker_costs_plain(m, cfg, ca))
        return terms["src_term"], vals, idx
    packed = grid_terms(m, cfg, ca, kp, ks, dest_pool, consts, tconsts,
                        bcost)
    vals, idx = launch_grid_top_r(packed, R)
    return packed["src_f"][:, SRC_TERM_COL], vals, idx


def grid_rescore_carry_plain(m, cfg, ca, kp, ks, dest_pool, packed, R: int,
                             dt, bd, gate, want: int, rows=None,
                             n_rows=None) -> None:
    """Plain twin of K1's incremental-rescore forms (tpu_optimizer.py
    :1056-1073 ``full_rescore``, :1134-1144 the patch's part (b)): unless
    the carry ``gate`` says the step is inactive or its FRESH flag is not
    ``want``, every row's top-R — or that of the first ``n_rows[0]`` rows
    of the list ``rows``, their terms recomputed for those rows as the
    reference does — as destination terms ``dt`` = score − src_term and
    pool indices ``bd`` [K, R], written in place at each row.  ``packed``
    is K2's output for (kp, ks, dest_pool) (:func:`grid_terms`)."""
    if not (int(gate[SS.ACTIVE]) and int(gate[SS.FRESH]) == want):
        return
    src_term = packed["src_f"][:, SRC_TERM_COL]
    if rows is None:
        vals, idx = grid_top_r_plain(m, cfg, ca, kp, ks, dest_pool,
                                     packed.get("terms"), R)
        dt.copy_(vals - src_term[:, None])
        bd.copy_(idx)
        return
    k = rows[:min(rows.shape[0], int(n_rows[0]))].long()
    vals, idx = grid_top_r_plain(m, cfg, ca, kp[k], ks[k], dest_pool, None, R)
    dt[k] = vals - src_term[k][:, None]
    bd[k] = idx


def grid_rescore_carry(m, cfg, ca, kp, ks, dest_pool, packed, R: int, dt,
                       bd, gate, want: int, rows=None, n_rows=None) -> None:
    """K1 into the incremental rescore's carry: the plain twin
    :func:`grid_rescore_carry_plain` (same arguments) for CPU tensors, one
    gated K1 launch (no host read) for CUDA tensors."""
    if kernels.on_cpu(dest_pool):
        return grid_rescore_carry_plain(m, cfg, ca, kp, ks, dest_pool, packed,
                                        R, dt, bd, gate, want, rows, n_rows)
    launch_grid_top_r(packed, R, out=(dt, bd), rows=rows, n_rows=n_rows,
                      gate=gate, want=want, dest_terms=True)

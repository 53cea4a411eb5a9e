"""The incremental rescore: its plain twins and the hand-written CUDA
kernels that replace them on the card.

With ``incremental_rescore=True`` the reference's step
(``cruise_control_tpu/analyzer/tpu_optimizer.py:1075-1160``) keeps each
pool row's top-R as destination terms ``dt = score − src_term`` with their
pool indices ``bd`` and the leadership scores ``ls`` in its carry, and
rescores only what the step before's commits made stale — unless a stale
set overflows its budget, the step repools, or ``rescore_refresh_steps``
steps passed since the last full rescore:

* K16 :func:`stale_sets` (``csrc/stale_sets.cu``): the stale rows
  (``tpm[kp]``), destination columns (``tb[dest_pool]``) and leadership
  entries, their counts, the overflow test and the step's full-or-patch
  decision into the device carry (:mod:`analyzer.step_state`), and the
  three index lists in ``argsort(~stale)``'s stable order — plain twin
  :func:`stale_sets_plain`.
* K17 :func:`grid_patch` (``csrc/grid_patch.cu``): the patch's part (a),
  the [K, CB] grid over the stale columns and the exact top-R merge of
  each row's stored entries (stale destinations invalidated) with them —
  plain twin :func:`grid_patch_plain`.

Parts (b) and (c) of the patch, and the full rescore, are K1 and K6 on a
row list or the whole pool, gated on the same carry
(:func:`ops.grid.grid_rescore_carry`, :func:`analyzer.score_kernel
.score_candidates`).  Each wrapper runs its plain twin for CPU tensors and
for CUDA tensors launches its kernel or raises; there is no fallback.
Each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.grid import (
    _DF,
    _DI,
    _NC,
    _SF,
    _TOPR,
    SRC_TERM_COL,
    _check_widths,
    move_grid_scores,
    slot_instance,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_INF = float("inf")
#: K17's warps (rows in flight) a block (csrc/grid_patch.cu: WARPS, which
#: says why 8)
_K17_WARPS = 8


# ---------------------------------------------------------------------------------
# K16: the stale sets
# ---------------------------------------------------------------------------------

def _stale_masks(m, kp, dest_pool, lp, lsl, tb, tpm):
    """(row_stale [K], col_stale [D], l_stale [L]) from the step before's
    marks (:1079-1086)."""
    row_stale = tpm[kp.long()]
    col_stale = (dest_pool >= 0) & tb[dest_pool.clamp_min(0).long()]
    row = m.assignment[lp.long()]
    lb = torch.gather(row, 1, m.leader_slot[lp.long()].long()[:, None])
    slb = torch.gather(row, 1, lsl.long()[:, None])
    l_stale = (tpm[lp.long()] | tb[lb[:, 0].clamp_min(0).long()]
               | tb[slb[:, 0].clamp_min(0).long()])
    return row_stale, col_stale, l_stale


def _stale_order(stale: torch.Tensor, n: int) -> torch.Tensor:
    """The first n of ``argsort(~stale)`` (stable): stale indices
    ascending, then the others ascending."""
    return torch.sort((~stale).to(torch.uint8), stable=True).indices[:n]


def stale_sets_plain(m, kp, dest_pool, lp, lsl, tb, tpm, state, ridx, cidx,
                     lidx, nstale, refresh_steps: int) -> None:
    """Plain twin of K16: unless the carry ``state`` says the step is
    inactive, the stale sets of :func:`_stale_masks`, their counts into
    ``nstale`` [3], the overflow test against the budgets (the lengths of
    ``ridx`` / ``cidx`` / ``lidx``), the step's decision — ``fresh`` =
    this step repools (REPOOL) or a set overflows or ``refresh_steps`` > 0
    steps passed since the last full rescore — into FRESH, and SINCE_FULL,
    N_OVF (overflows on a step that does not repool) and N_PATCH updated
    (:1087-1095, :1157); and the lists in ``argsort(~stale)``'s order:
    ``ridx`` and ``lidx`` as indices, ``cidx`` as pool indices with -1
    where the column is not stale."""
    if not int(state[SS.ACTIVE]):
        return
    stale = _stale_masks(m, kp, dest_pool, lp, lsl, tb, tpm)
    counts = [int(x.sum()) for x in stale]
    budgets = (ridx.shape[0], cidx.shape[0], lidx.shape[0])
    overflow = any(c > b for c, b in zip(counts, budgets))
    repool = bool(int(state[SS.REPOOL]))
    since = int(state[SS.SINCE_FULL])
    fresh = repool or overflow or (refresh_steps > 0
                                   and since >= refresh_steps)
    for i, v in ((SS.N_OVF, int(state[SS.N_OVF]) + int(overflow
                                                      and not repool)),
                 (SS.SINCE_FULL, 0 if fresh else since + 1),
                 (SS.FRESH, int(fresh)),
                 (SS.N_PATCH, int(state[SS.N_PATCH]) + int(not fresh))):
        state[i] = v
    nstale.copy_(torch.tensor(counts, dtype=torch.int32))
    row_stale, col_stale, l_stale = stale
    ridx.copy_(_stale_order(row_stale, budgets[0]))
    order = _stale_order(col_stale, budgets[1])
    cidx.copy_(torch.where(col_stale[order], order, -1))
    lidx.copy_(_stale_order(l_stale, budgets[2]))


def stale_sets(m, kp, dest_pool, lp, lsl, tb, tpm, state, ridx, cidx, lidx,
               nstale, refresh_steps: int, checked: bool = False) -> None:
    """K16: the step's stale sets, decision and index lists of the plain
    twin :func:`stale_sets_plain` (same arguments), written in place on the
    card with no host read; one launch of one block.  ``checked=True``
    skips the input checks (the step loop checks once per call)."""
    if kernels.on_cpu(kp):
        return stale_sets_plain(m, kp, dest_pool, lp, lsl, tb, tpm, state,
                                ridx, cidx, lidx, nstale, refresh_steps)
    dev = kp.device
    P, S = m.assignment.shape
    B = tb.shape[0]
    K, D, L = kp.shape[0], dest_pool.shape[0], lp.shape[0]
    RB, CB, LB = ridx.shape[0], cidx.shape[0], lidx.shape[0]
    if not (1 <= RB <= K and 1 <= CB <= D and 1 <= LB <= L):
        raise ValueError(f"stale_sets: budgets ({RB}, {CB}, {LB}) outside "
                         f"[1, ({K}, {D}, {L})]")
    if not checked:
        i32, b8 = torch.int32, torch.bool
        chk = functools.partial(kernels.check, "stale_sets", device=dev)
        for name, x, dt, shape in (
            ("assignment", m.assignment, i32, (P, S)),
            ("leader_slot", m.leader_slot, i32, (P,)),
            ("kp", kp, i32, (K,)), ("dest_pool", dest_pool, i32, (D,)),
            ("lp", lp, i32, (L,)), ("lsl", lsl, i32, (L,)),
            ("tb", tb, b8, (B,)), ("tpm", tpm, b8, (P,)),
            ("state", state, i32, (SS.NSTATE,)),
            ("ridx", ridx, i32, (RB,)), ("cidx", cidx, i32, (CB,)),
            ("lidx", lidx, i32, (LB,)), ("nstale", nstale, i32, (3,)),
        ):
            chk(name, x, dt, shape)
    lib = kernels.bind("stale_sets", "stale_sets_launch",
                       [_P] * 9 + [_I] * 8 + [_P] * 5)
    err = lib.stale_sets_launch(
        m.assignment.data_ptr(), m.leader_slot.data_ptr(), kp.data_ptr(),
        dest_pool.data_ptr(), lp.data_ptr(), lsl.data_ptr(), tb.data_ptr(),
        tpm.data_ptr(), state.data_ptr(), K, D, L, S, RB, CB, LB,
        int(refresh_steps), ridx.data_ptr(), cidx.data_ptr(),
        lidx.data_ptr(), nstale.data_ptr(), kernels.stream(dev))
    kernels.launched("stale_sets", err)
    stale_sets.launches += 1


stale_sets.launches = 0


# ---------------------------------------------------------------------------------
# K17: the patch's stale columns and the exact top-R merge
# ---------------------------------------------------------------------------------

def _total_order(x: torch.Tensor) -> torch.Tensor:
    """int32 keys in the floats' total order (-0.0 below +0.0): the order
    ``lax.top_k`` of the negated scores ranks them in."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def grid_patch_plain(m, cfg, ca, kp, ks, dest_pool, packed, cidx, tb, dt,
                     bd, state) -> None:
    """Plain twin of K17, the patch's part (a) (:1096-1127): unless the
    carry ``state`` says the step is inactive or rescores in full, each
    row's grid over the stale columns ``cidx`` (pool indices, -1 = none:
    +inf) as destination terms, merged with the row's stored top-R ``dt``
    / ``bd`` — an entry whose destination broker is marked in ``tb``
    becomes +inf, keeping its index — by an exact top-R of the R + CB
    concatenation in ``lax.top_k(-merged)``'s order: the floats' total
    order (-0.0 before +0.0), ties to the lower position, stored entries
    first; written back into ``dt`` / ``bd``.  ``packed`` is K2's output
    (:func:`ops.grid.grid_terms`; on the CPU it holds the terms)."""
    if not (int(state[SS.ACTIVE]) and int(state[SS.FRESH]) == 0):
        return
    R = dt.shape[1]
    K = dt.shape[0]
    src_term = packed["src_f"][:, SRC_TERM_COL]
    col = cidx >= 0
    dp_c = torch.where(col, dest_pool[cidx.clamp_min(0).long()], -1)
    g_c = move_grid_scores(m, cfg, ca, kp, ks, dp_c.to(torch.int32),
                           terms=packed.get("terms"))
    dt_c = g_c - src_term[:, None]
    stored_bid = dest_pool[bd.clamp_min(0).long()]
    stored = torch.where(tb[stored_bid.clamp_min(0).long()], _INF, dt)
    merged_s = torch.cat([stored, dt_c], dim=1)
    merged_d = torch.cat([bd, cidx[None, :].expand(K, -1)], dim=1)
    order = torch.sort(_total_order(merged_s), dim=1, stable=True).indices
    pick = order[:, :R]
    dt.copy_(torch.gather(merged_s, 1, pick))
    bd.copy_(torch.gather(merged_d, 1, pick))


def _k17_library():
    lib = kernels.bind("grid_patch", "grid_patch_launch",
                       [_P] * 8 + [_I] * 8 + [_P] * 4)
    if not getattr(lib, "_cc_checked", False):
        lib.grid_patch_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.grid_patch_layout.restype = None
        lib.grid_patch_attrs.argtypes = [_I, _I, _I,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.grid_patch_attrs.restype = ctypes.c_int
        layout = (ctypes.c_int * 6)()
        lib.grid_patch_layout(layout)
        want = (_SF, _DF, _DI, _NC, _TOPR, _K17_WARPS)
        if tuple(layout) != want:
            raise RuntimeError(
                f"grid_patch library layout {tuple(layout)} != {want}")
        lib._cc_attrs = {}
        lib._cc_checked = True
    return lib


def grid_patch_attrs(S: int, has_cap: int, CB: int) -> dict:
    """The built K17 instance for S slots, capacity loads on or off, over
    CB columns, as the card reports it (:func:`ops.kernels.attrs`: its
    registers, spills, shared memory and resident blocks an SM).  Cached by
    (instance, has_cap, CB); needs the card."""
    lib = _k17_library()
    key = (slot_instance(S), int(has_cap), CB)
    if key not in lib._cc_attrs:
        lib._cc_attrs[key] = kernels.attrs("grid_patch", lib.grid_patch_attrs,
                                           S, int(has_cap), CB)
    return lib._cc_attrs[key]


def grid_patch(m, cfg, ca, kp, ks, dest_pool, packed, cidx, tb, dt, bd,
               state, checked: bool = False) -> None:
    """K17: the patch's part (a) of the plain twin :func:`grid_patch_plain`
    (same arguments), written into ``dt`` / ``bd`` in place on the card:
    one launch, gated on the carry (it returns at once on a step that
    rescores in full), reading K2's packed tables (``packed``) for the
    sources and its destination rows gathered by ``cidx``.
    ``checked=True`` skips the input checks."""
    if kernels.on_cpu(dest_pool):
        return grid_patch_plain(m, cfg, ca, kp, ks, dest_pool, packed, cidx,
                                tb, dt, bd, state)
    dev = dest_pool.device
    K, D, S = packed["K"], packed["D"], packed["S"]
    CB = cidx.shape[0]
    R = dt.shape[1]
    B = tb.shape[0]
    _check_widths(S, CB)
    if not 1 <= R <= min(_TOPR, D) or not 1 <= CB <= D:
        raise ValueError(f"grid_patch: R={R}, CB={CB} out of range for "
                         f"D={D}")
    if not checked:
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        chk = functools.partial(kernels.check, "grid_patch", device=dev)
        for name, x, dt_, shape in (
            ("src_f", packed["src_f"], f32, (K, _SF)),
            ("src_i", packed["src_i"], i32, (K, 3 * S + 2)),
            ("dst_f", packed["dst_f"], f32, (D, _DF)),
            ("dst_i", packed["dst_i"], i32, (D, _DI)),
            ("consts", packed["consts"], f32, (_NC,)),
            ("cidx", cidx, i32, (CB,)), ("dest_pool", dest_pool, i32, (D,)),
            ("tb", tb, b8, (B,)), ("dt", dt, f32, (K, R)),
            ("bd", bd, i32, (K, R)), ("state", state, i32, (SS.NSTATE,)),
        ):
            chk(name, x, dt_, shape)
    lib = _k17_library()
    # a block per _K17_WARPS rows, in as many waves as the card needs
    # (csrc/grid_patch.cu says why)
    grid = -(-K // _K17_WARPS)
    err = lib.grid_patch_launch(
        packed["src_f"].data_ptr(), packed["src_i"].data_ptr(),
        packed["dst_f"].data_ptr(), packed["dst_i"].data_ptr(),
        packed["consts"].data_ptr(), cidx.data_ptr(), dest_pool.data_ptr(),
        tb.data_ptr(), K, D, CB, S, R, packed["has_cap"], B, grid,
        dt.data_ptr(), bd.data_ptr(), state.data_ptr(), kernels.stream(dev))
    kernels.launched("grid_patch", err)
    grid_patch.launches += 1


grid_patch.launches = 0

"""CudaGoalOptimizer — the rebalance-plan engine on an NVIDIA card.

PyTorch port of the reference's device-resident search
(``cruise_control_tpu.analyzer.tpu_optimizer``), default single-device
path.  The search keeps the model on the card and runs, per step,
**repool → rescore → reduce → compact → cohort → auction → apply**:

* **Candidates**: the top-K priority source replicas × the top-D
  least-loaded destination brokers (the move grid, scored and ranked per
  row by the hand-written kernel K1, :func:`ops.grid.grid_top_r`), plus a
  pruned pool of leadership transfers.
* **Feasibility** (hard goals) and **cost** (soft goals) are the same
  fused mask and exact O(1) cost deltas as the reference.
* **Selection**: per-source-broker reduction, compaction to the best C
  rows, a budgeted cohort (water-filling sufficient conditions) and a
  disjoint auction commit a batch per step.
* **Host recheck**: every committed action is replayed on the host in f64
  (:class:`_HostEvaluator`, a verbatim copy of the reference's numpy
  evaluator); a rejection resyncs the device model from the host context.

The reference's ``lax.while_loop`` becomes a Python loop over steps: each
step reads its commit count back to the host (one small sync per step) to
drive the loop; the committed actions stay on the card until the call's
packed prefix is fetched.  Every selection that feeds a discrete choice
uses stable sorts or (score, index) scatter-mins, so ties go to the lowest
index as in XLA; every float segment sum is exact and deterministic
(:mod:`ops.segment`), so plans repeat run to run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.analyzer.actions import ActionType, BalancingAction
from cruise_control_tpu_torch.analyzer.context import (
    AnalyzerContext,
    OptimizationOptions,
)
from cruise_control_tpu_torch.analyzer.goal_optimizer import (
    OptimizerResult,
    diff_proposals,
)
from cruise_control_tpu_torch.analyzer.goals.base import BalancingConstraint
from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.models.stats import cluster_stats, stats_summary
from cruise_control_tpu_torch.ops.cost import (
    EVAC_BONUS,
    RACK_FIX_BONUS,
    broker_cost,
    pack_pload,
)
from cruise_control_tpu_torch.ops.grid import (
    gather_pload as _gather_pload,
    grid_consts,
    grid_top_r,
    move_grid_terms,
)
from cruise_control_tpu_torch.ops.pools import (
    pool_prio,
    pool_row_tables,
    pool_row_tables_update,
)
from cruise_control_tpu_torch.ops.segment import (
    segment_excl_prefix_sorted,
    segment_sum,
)
from cruise_control_tpu_torch.utils.device import resolve_device
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("engine")

KIND_MOVE = 0
KIND_LEADERSHIP = 1

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class CudaSearchConfig:
    """Search hyper-parameters: the same fields and defaults as the
    reference's ``TpuSearchConfig`` (whose field comments give each knob's
    measured rationale).  Knobs whose paths this port does not run yet
    raise ``NotImplementedError`` at non-default values
    (:func:`_check_config`)."""

    max_rounds: int = 150
    candidate_budget: int = 1 << 23
    max_source_replicas: int = 8192
    max_dest_brokers: int = 1024
    topk_per_round: int = 2048
    max_moves_per_round: int = 4096
    improvement_tol: float = -1e-4
    w_util_var: float = 1.0
    w_bound: float = 8.0
    w_count: float = 0.25
    w_leader_count: float = 0.25
    w_leader_nwin: float = 0.5
    w_pot_nwout: float = 1.0
    w_move_size: float = 1e-3
    #: "auto" = "grid" (the move grid through kernel K1); "columnar" is the
    #: score-only round path, not ported yet
    scoring: str = "auto"
    steps_per_call: int = 512
    repool_steps: int = 128
    repool_incremental: bool = True
    repool_rows_budget: int = 8192
    #: accepted; the drive loop runs serially at every depth (the reference
    #: pins pipelined plans as identical to serial ones)
    pipeline_depth: int = 1
    device_batch_per_step: int = 0
    moves_per_src: int = 4
    incremental_rescore: bool = False
    rescore_rows_budget: int = 512
    rescore_cols_budget: int = 128
    rescore_lead_budget: int = 2048
    rescore_refresh_steps: int = 8
    cohort_budget_slack: float = 1.0
    cohort_mode: str = "budget"
    cohort_stack_tol: float = 1.0
    selection_rows: int = 1024
    auction_dest_cap: int = 1
    auction_src_cap: int = 1
    auction_stack_ratio: float = 0.5
    auction_rounds: int = 0
    step_diagnostics: bool = False
    time_budget_s: float = 0.0
    profiler_trace_dir: str = ""
    polish_rounds: int = 0
    #: "approx" and "exact" both rank exactly here (the reference is exact
    #: off-TPU too)
    topk_mode: str = "approx"
    #: mesh-only and buffer-donation knobs: no effect on one device
    shard_tables: bool = True
    donate_carry: bool = True


def _check_config(cfg: CudaSearchConfig) -> None:
    """Reject knobs whose code paths this port does not run yet, naming
    the ROADMAP.md item that brings each."""
    if cfg.scoring not in ("auto", "grid", "columnar"):
        raise ValueError(f"unknown scoring {cfg.scoring!r} (auto/grid/columnar)")
    if cfg.cohort_mode not in ("budget", "corrected"):
        raise ValueError(f"unknown cohort_mode {cfg.cohort_mode!r}")
    if cfg.topk_mode not in ("approx", "exact"):
        raise ValueError(f"unknown topk_mode {cfg.topk_mode!r}")
    todo = [
        (cfg.incremental_rescore, "incremental_rescore=True",
         "A4 (incremental rescore)"),
        (cfg.cohort_mode == "corrected", "cohort_mode='corrected'",
         "A4 (corrected cohort)"),
        (cfg.polish_rounds > 0, "polish_rounds>0",
         "A4 (score-only rounds / polish)"),
        (cfg.steps_per_call == 0, "steps_per_call=0",
         "A4 (score-only rounds / polish)"),
        (cfg.scoring == "columnar", "scoring='columnar'",
         "A4 (score-only rounds / polish)"),
        (cfg.time_budget_s > 0, "time_budget_s>0", "A4 (time budget)"),
        (bool(cfg.profiler_trace_dir), "profiler_trace_dir",
         "A10 (device telemetry)"),
    ]
    for bad, knob, item in todo:
        if bad:
            raise NotImplementedError(
                f"{knob} is not ported yet (ROADMAP.md {item})")


# ---------------------------------------------------------------------------------
# Device-side model tensors
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceModel:
    """Placement + immutable data + derived aggregates, all on the device
    (field meanings as in the reference's ``DeviceModel``)."""

    assignment: torch.Tensor      # int32 [P, S]
    leader_slot: torch.Tensor     # int32 [P]
    leader_load: torch.Tensor     # f32 [P, R]
    follower_load: torch.Tensor   # f32 [P, R]
    partition_topic: torch.Tensor # int32 [P]
    capacity: torch.Tensor        # f32 [B, R]
    rack: torch.Tensor            # int32 [B]
    dest_ok: torch.Tensor         # bool [B] replica-move destinations
    lead_ok: torch.Tensor         # bool [B] leadership destinations
    alive: torch.Tensor           # bool [B]
    excluded: torch.Tensor        # bool [P] topic-excluded partitions
    must_move: torch.Tensor       # bool [P, S] offline/evacuating replicas
    offline_origin: torch.Tensor  # int32 [P, S]
    broker_load: torch.Tensor     # f32 [B, R]
    leader_nwin: torch.Tensor     # f32 [B]
    pot_nwout: torch.Tensor       # f32 [B]
    rcount: torch.Tensor          # f32 [B]
    lcount: torch.Tensor          # f32 [B]
    leader_cload: Optional[torch.Tensor] = None    # f32 [P, R]
    follower_cload: Optional[torch.Tensor] = None  # f32 [P, R]
    broker_cload: Optional[torch.Tensor] = None    # f32 [B, R]
    pload: Optional[torch.Tensor] = None           # f32 [P, 2R+1 | 4R+1]


def _recompute_aggregates(m: DeviceModel) -> DeviceModel:
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


def _broker_cost(m: DeviceModel, cfg, ca, load, leader_nwin, pot_nwout,
                 rcount, lcount, b, cload=None) -> torch.Tensor:
    """Per-broker soft-goal cost at broker index ``b`` (ops.cost.broker_cost)."""
    return broker_cost(
        cfg, ca, m.capacity[b.long()], load, leader_nwin, pot_nwout, rcount,
        lcount, cload=cload,
    )


def _score_candidates(m: DeviceModel, cfg, ca, kind, cp, cs, cd):
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
# Candidate pools
# ---------------------------------------------------------------------------------

def _top_desc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lowest index (XLA
    ``top_k`` order): a stable descending sort."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _build_round_pools(m: DeviceModel, ca, K: int, D: int, tables=None):
    """Device-side candidate pruning for one round → (kp[K], ks[K],
    dest[D]): top-K replicas by priority, top-D least-loaded eligible
    brokers.  ``tables`` = stored move-pool row tables (ops.pools);
    ``None`` recomputes them."""
    size, base = tables if tables is not None else pool_row_tables(m)
    prio = pool_prio(m, ca, size, base)
    return _select_round_pools(m, K, D, prio)


def _select_round_pools(m: DeviceModel, K: int, D: int, prio):
    """Pool selection over a full [P, S] priority.  Exact top-k always (the
    reference switches to approx_max_k off forced candidates on TPU only)."""
    S = m.assignment.shape[1]
    flat_idx = _top_desc(prio.reshape(-1), K)
    kp = (flat_idx // S).to(torch.int32)
    ks = (flat_idx % S).to(torch.int32)
    util = m.broker_load / torch.clamp_min(m.capacity, 1e-9)
    dest_score = util.max(dim=1).values + torch.where(m.dest_ok, 0.0, _INF)
    dest_pool = _top_desc(-dest_score, D).to(torch.int32)
    return kp, ks, dest_pool


def _leadership_pool_size(P: int, S: int, K: int) -> int:
    """Static leadership-pool size: full grid for small models, pruned to
    the move-pool scale for large ones."""
    return min(P * S, max(K, 4096))


def _leadership_prio_terms(m: DeviceModel, ca):
    """[B]-scale terms of the leadership-pool priority → (stress [B],
    ltab [B, 2])."""
    cap = torch.clamp_min(m.capacity, 1e-9)
    util = m.broker_load / cap
    lc_over = torch.clamp_min(m.lcount - ca["lcount_upper"], 0.0) / \
        torch.clamp_min(ca["lcount_upper"], 1.0)
    lc_need = torch.clamp_min(ca["lcount_lower"] - m.lcount, 0.0) / \
        torch.clamp_min(ca["lcount_lower"], 1.0)
    stress = (
        util.max(dim=1).values + m.leader_nwin / cap[:, Resource.NW_IN]
        + lc_over
    )
    ltab = torch.stack([lc_need, m.lead_ok.to(torch.float32)], dim=1)
    return stress, ltab


def _leadership_prio_rows(stress, ltab, row, lslot, must, excl):
    """[N, S] leadership-pool priority (-inf = invalid) for the given
    partition rows."""
    S = row.shape[1]
    lb = torch.gather(row, 1, lslot.long()[:, None])[:, 0]
    lb_c = lb.clamp_min(0).long()
    g2 = ltab[row.clamp_min(0).long()]                       # [N, S, 2]
    prio = stress[lb_c][:, None] + g2[..., 0]
    ar = torch.arange(S, device=row.device)
    valid = (
        (row != EMPTY_SLOT)
        & (ar[None, :] != lslot[:, None])
        & ~excl[:, None]
        & ~must
        & (g2[..., 1] > 0.0)
    )
    return prio.masked_fill(~valid, -_INF)


def _leadership_pool(m: DeviceModel, ca, L: int):
    """Top-L leadership candidates (p, s) by the current leader broker's
    stress."""
    S = m.assignment.shape[1]
    stress, ltab = _leadership_prio_terms(m, ca)
    flat = _leadership_prio_rows(
        stress, ltab, m.assignment, m.leader_slot, m.must_move, m.excluded
    ).reshape(-1)
    idx = _top_desc(flat, L)
    return (idx // S).to(torch.int32), (idx % S).to(torch.int32)


#: alternate destinations kept per source row (fallbacks tried by the
#: batch matcher when a better-scored source takes the same destination)
DESTS_PER_SOURCE = 8


def _grid_top_r(m, cfg, ca, kp, ks, dest_pool, terms, R: int, consts=None):
    """Per-row top-R destination selection over the move grid → (score
    [K, R] ascending, pool index [K, R]).  The grid is never materialized
    on the card: this is kernel K1 (ops.grid.grid_top_r).  ``topk_mode``
    has no approximate variant here."""
    return grid_top_r(m, cfg, ca, kp, ks, dest_pool, terms, R, consts=consts)


def _build_pools(m: DeviceModel, cfg, ca, K: int, D: int, tables=None):
    """All P·S-scale candidate-pool selection → (kp, ks, dest_pool, lp,
    lsl)."""
    P, S = m.assignment.shape
    kp, ks, dest_pool = _build_round_pools(m, ca, K, D, tables=tables)
    lp, lsl = _leadership_pool(m, ca, _leadership_pool_size(P, S, K))
    return kp, ks, dest_pool, lp, lsl


# ---------------------------------------------------------------------------------
# Per-step reductions and selection
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


def _reduce_leadership_per_src(m: DeviceModel, lp, lsl, l_scores):
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


def _topq_rows_per_src(sb, row_best, B: int, Q: int):
    """Top-Q candidate rows per source broker by score → (rows int32
    [Q, B], scores f32 [Q, B]): the q-th best row index of each broker (K
    where a broker has fewer than q+1 rows) and that row's score (inf where
    invalid).  Q sequential scatter-min passes, ties to the lowest row."""
    K = sb.shape[0]
    sbl = sb.long()
    cur = row_best
    idx = torch.arange(K, device=sb.device)
    outs, out_scores = [], []
    for _ in range(Q):
        seg = _scatter_min(B, sbl, cur, _INF)
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


def _step_budgets(m: DeviceModel, ca):
    """Per-broker move budgets for the water-filling cohort → (src_budget,
    dst_budget), both f32 [B, R+2] over (resources..., replica count,
    potential NW-out) — plus R capacity-headroom dims with percentile
    loads.  See the reference's ``_step_budgets`` for the derivation."""
    B = m.capacity.shape[0]
    alive_cap = torch.where(m.alive[:, None], m.capacity, 0.0)
    avg_u = m.broker_load.sum(dim=0) / torch.clamp_min(
        alive_cap.sum(dim=0), 1e-9)
    target = avg_u[None, :] * m.capacity
    pivot = avg_u * alive_cap.sum(dim=0) / torch.clamp_min(
        (alive_cap * alive_cap).sum(dim=0), 1e-9)
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


def _apply_batch_on_device(m: DeviceModel, take, is_move, p, s, d, src,
                           dst) -> DeviceModel:
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
# The device-resident step loop (one "scan call")
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class ScanResult:
    """What one scan call hands the host: the committed actions of every
    step in commit order, the per-step commit counts and the done flag."""

    kind: np.ndarray          # int32 [n]
    p: np.ndarray             # int32 [n]
    s: np.ndarray             # int32 [n]
    d: np.ndarray             # int32 [n]
    step_counts: np.ndarray   # int64 [steps run]
    done: bool
    diag: dict


def _cold_tables(m: DeviceModel):
    """Pool row-table carry with ``valid=False``: the first repool of the
    next call rebuilds from scratch."""
    P, S = m.assignment.shape
    dev = m.assignment.device
    return (torch.zeros((P, S), device=dev), torch.zeros((P, S), device=dev),
            torch.zeros(P, dtype=torch.bool, device=dev), False)


def _scan_call(m: DeviceModel, cfg: CudaSearchConfig, ca, consts, K: int,
               D: int, T: int, tables):
    """Up to T (repool → rescore → reduce → compact → cohort → auction →
    apply) steps on the device — the port of the reference's
    ``_cached_scan_fn`` body on its default single-device branch.

    Returns (ScanResult, updated model, (size, base, touched) row-table
    carry).  The loop ends on convergence (a step on freshly built pools
    commits nothing), after T steps, or when the next step could overflow
    the slot budget (the host just calls again)."""
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    dev = m.assignment.device
    M = cfg.device_batch_per_step
    repool = max(1, cfg.repool_steps)
    Q = max(1, cfg.moves_per_src)
    NROW = (Q + 1) * B
    M_run = min(M, NROW)
    C = min(cfg.selection_rows, NROW)
    M_step = min(M_run, C)
    slots = min(T, repool) * M_run
    RB_POOL = min(P, cfg.repool_rows_budget)
    incr_repool = cfg.repool_incremental and RB_POOL < P
    R = min(DESTS_PER_SOURCE, D)
    size_t, base_t, tpp, pt_valid = tables

    out = torch.full((4, slots), -1.0, device=dev)
    counts: List[int] = []
    diag_rows: List[Tuple[int, int, int]] = []
    done = False
    t = count = n_incr = 0
    since_pool = repool
    pools = None
    ci = torch.arange(C, device=dev)
    is_move_all = torch.arange(NROW, device=dev) < Q * B
    inf_tail = torch.full((C, R - 1), _INF, device=dev)
    while not done and t < T and count <= slots - M_run:
        if since_pool >= repool:
            # pool-rebuild diet: refresh only the touched rows when the
            # carried tables are valid and the touched set fits the budget
            if incr_repool and pt_valid and int(tpp.sum()) <= RB_POOL:
                size_t, base_t = pool_row_tables_update(
                    m, size_t, base_t, tpp, RB_POOL)
                n_incr += 1
            else:
                size_t, base_t = pool_row_tables(m)
            pools = _build_pools(m, cfg, ca, K, D, tables=(size_t, base_t))
            pt_valid = True
            tpp = torch.zeros(P, dtype=torch.bool, device=dev)
            since_pool = 0
        kp, ks, dest_pool, lp, lsl = pools
        L = lp.shape[0]

        # ---- rescore: the move grid's per-row top-R (K1) + leadership ----
        terms = move_grid_terms(m, cfg, ca, kp, ks)
        src_term = terms["src_term"]
        vals, best_d = _grid_top_r(m, cfg, ca, kp, ks, dest_pool, terms, R,
                                   consts)
        # the reference carries destination terms and re-adds the source
        # term; the round trip is kept for bit-parity of the row scores
        row_scores = src_term[:, None] + (vals - src_term[:, None])
        ls, _ = _score_candidates(
            m, cfg, ca, torch.ones(L, dtype=torch.int32, device=dev), lp,
            lsl, torch.zeros(L, dtype=torch.int32, device=dev),
        )

        # ---- reduce: per-broker best transfer + top-Q move rows ----------
        bl_score, bl_p, bl_s, bl_dst = _reduce_leadership_per_src(
            m, lp, lsl, ls)
        sb = m.assignment[kp.long(), ks.long()].clamp_min(0)
        rows_q2, q_scores = _topq_rows_per_src(sb, row_scores[:, 0], B, Q)
        rows_q = rows_q2.reshape(-1).long()
        valid_q = rows_q < K
        mrow = rows_q.clamp(0, K - 1)

        # ---- compact to the best C rows ---------------------------------
        key_all = torch.cat([q_scores.reshape(-1), bl_score])
        crow = torch.sort(key_all, stable=True).indices[:C]
        is_move_row = is_move_all[crow]
        qrow = crow.clamp(0, Q * B - 1)
        mr_c = mrow[qrow]
        valid_c = valid_q[qrow]
        lrow_c = (crow - Q * B).clamp(0, B - 1)
        imr = is_move_row[:, None]
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

        # ---- cohort: water-filling budgets -------------------------------
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
        src_budget, dst_budget = _step_budgets(m, ca)
        if cfg.cohort_budget_slack != 1.0:
            # relax the soft dims only; capacity-headroom dims stay exact
            soft = NUM_RESOURCES + 2
            src_budget = src_budget.clone()
            dst_budget = dst_budget.clone()
            src_budget[:, :soft] *= cfg.cohort_budget_slack
            dst_budget[:, :soft] *= cfg.cohort_budget_slack
        qualified = is_move_row & ~leader_now_q & valid_c
        # compact partition-conflict ids: rows sharing a partition map to
        # one representative row
        order_pc = torch.argsort(cand_p, stable=True)
        sorted_p = cand_p[order_pc]
        firstp = torch.ones(C, dtype=torch.bool, device=dev)
        firstp[1:] = sorted_p[1:] != sorted_p[:-1]
        start_pos = torch.cummax(torch.where(firstp, ci, -1), dim=0).values
        rep = torch.empty_like(ci)
        rep[order_pc] = order_pc[start_pos]
        improving = cand_score[:, 0] < cfg.improvement_tol
        qual = qualified & improving
        # one row per partition (best first — rows are in score order)
        fminp = _scatter_min(C, rep, torch.where(qual, ci, C), C)
        qual = qual & (ci == fminp[rep])
        d0 = cand_dst[:, 0].clamp_min(0)
        acc_b = _budget_accept(d0, cand_src.clamp_min(0), move_vec,
                               dst_budget, src_budget, qual)

        # ---- auction for the rest, disjoint from the cohort --------------
        used0 = (
            _mark(B, cand_src.clamp_min(0), acc_b),
            _mark(B, d0, acc_b),
            _mark(C, rep, acc_b),
        )
        take_d, win_score_d, win_dst_d = _match_batch(
            cand_score.masked_fill(acc_b[:, None], _INF), cand_dst, cand_src,
            rep, cfg.improvement_tol, B, C, init_used=used0,
            dest_cap=cfg.auction_dest_cap, src_cap=cfg.auction_src_cap,
            stack_ratio=cfg.auction_stack_ratio, rounds=cfg.auction_rounds,
        )
        take = acc_b | take_d
        win_score = torch.where(acc_b, cand_score[:, 0], win_score_d)
        win_dst = torch.where(acc_b, d0.long(), win_dst_d)

        # ---- apply the M_step best; commit order = score order -----------
        vals_all, order_all = torch.sort(
            torch.where(take, win_score, _INF), stable=True)
        order = order_all[:M_step]
        sel_ok = torch.isfinite(vals_all[:M_step])
        take_f = torch.zeros(C, dtype=torch.bool, device=dev)
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
        if cfg.step_diagnostics:
            diag_t = torch.stack([
                improving.sum(), acc_b.sum(), (take & ~acc_b).sum(),
                sel_ok.sum(),
            ]).tolist()
            diag_rows.append(tuple(diag_t[:3]))
            c_step = int(diag_t[3])
        else:
            c_step = int(sel_ok.sum())          # the step's one host sync
        counts.append(c_step)
        # zero commits on fresh pools = converged; on stale pools = force a
        # repool next step and keep going
        done = c_step == 0 and since_pool == 0
        since_pool = repool if c_step == 0 else since_pool + 1
        count += c_step
        t += 1

    t_fetch = time.perf_counter()
    body = out[:, :count].cpu().numpy().astype(np.int32)
    diag = {"steps_run": t, "n_incremental_repool": n_incr,
            "fetch_s": time.perf_counter() - t_fetch}
    if cfg.step_diagnostics:
        d3 = np.asarray(diag_rows, np.int64).reshape(-1, 3)
        diag.update(improving=d3[:, 0], cohort=d3[:, 1], auction=d3[:, 2])
    res = ScanResult(body[0], body[1], body[2], body[3],
                     np.asarray(counts, np.int64), done, diag)
    return res, m, (size_t, base_t, tpp)


def _resync_device_model(m: DeviceModel, ctx: AnalyzerContext) -> DeviceModel:
    """Rebuild device placement + aggregates from the live host context
    (after a host-side rejection)."""
    dev = m.assignment.device
    # copies: on the CPU as_tensor would alias the arrays the host recheck
    # keeps mutating
    m = dataclasses.replace(
        m,
        assignment=torch.tensor(ctx.assignment, device=dev),
        leader_slot=torch.tensor(ctx.leader_slot, device=dev),
        must_move=torch.tensor(ctx.replica_offline, device=dev),
    )
    return _recompute_aggregates(m)


# ---------------------------------------------------------------------------------
# Host-side exact commit validation (verbatim copy of the reference's numpy
# evaluator: it is the f64 twin of the device math)
# ---------------------------------------------------------------------------------

def _np_broker_cost(cfg: CudaSearchConfig, can, cap, load, lnwin, pot, rc, lc,
                    cload=None):
    """Numpy mirror of :func:`_broker_cost` for one broker (exact, host-side).

    The device scores a whole candidate batch against a *snapshot* of the
    aggregates; the host commit loop re-evaluates each candidate against the
    *live* aggregates with this function, so a single device round can commit
    hundreds of dependent actions without broker-disjointness restrictions —
    every committed action's improvement is exact, not stale.

    Delegates to the batch form so the scalar and vectorized paths cannot
    drift apart.
    """
    return float(
        _np_broker_cost_batch(
            cfg, can,
            np.asarray(cap)[None], np.asarray(load)[None],
            np.asarray([lnwin]), np.asarray([pot]),
            np.asarray([rc], np.float64), np.asarray([lc], np.float64),
            cload=None if cload is None else np.asarray(cload)[None],
        )[0]
    )


def _np_broker_cost_batch(cfg: CudaSearchConfig, can, cap, load, lnwin, pot,
                          rc, lc, cload=None):
    """Per-broker soft-goal cost, batch form: cap/load [n, R], rest [n].

    The single source of the host-side cost math — the scalar
    :func:`_np_broker_cost` delegates here (batch-vs-scalar replay parity is
    additionally covered in tests/test_tpu_optimizer.py).  ``cload`` mirrors
    :func:`ops.cost.broker_cost`: the capacity-overrun repair term runs on
    the capacity-estimate loads when they are distinct."""
    cap = np.maximum(cap, 1e-9)
    util = load / cap
    c = np.sum(util * util, axis=1) * cfg.w_util_var
    over = np.maximum(util - can["util_upper"], 0.0)
    under = np.maximum(can["util_lower"] - util, 0.0)
    c += np.sum(over + under, axis=1) * cfg.w_bound
    cutil = util if cload is None else cload / cap
    c += np.sum(np.maximum(cutil - can["cap_threshold"], 0.0), axis=1) * 1000.0
    c += (rc / can["avg_rcount"] - 1.0) ** 2 * cfg.w_count
    c += (lc / can["avg_lcount"] - 1.0) ** 2 * cfg.w_leader_count
    c += (
        np.maximum(rc - can["rcount_upper"], 0.0)
        + np.maximum(can["rcount_lower"] - rc, 0.0)
    ) / can["avg_rcount"] * cfg.w_bound
    c += (
        np.maximum(lc - can["lcount_upper"], 0.0)
        + np.maximum(can["lcount_lower"] - lc, 0.0)
    ) / can["avg_lcount"] * cfg.w_bound
    lnw = lnwin / cap[:, Resource.NW_IN]
    c += lnw * lnw * cfg.w_leader_nwin
    c += np.maximum(lnw - can["leader_nwin_upper"], 0.0) * cfg.w_bound
    pot_u = pot / cap[:, Resource.NW_OUT]
    c += (
        np.maximum(pot_u - can["cap_threshold"][Resource.NW_OUT], 0.0)
        * cfg.w_pot_nwout
    )
    return c


class _HostEvaluator:
    """Exact feasibility + cost-delta evaluation against the live context."""

    def __init__(self, ctx: AnalyzerContext, cfg: CudaSearchConfig, can):
        self.ctx = ctx
        self.cfg = cfg
        self.can = can
        self.dest_ok = ctx.dest_candidates()
        self.lead_ok = ctx.leadership_candidates()
        self.excluded = ctx.excluded_partition_mask()
        #: decision provenance stamped onto every committed action: the
        #: engine phase ("CudaSearch" here) and the device
        #: call/round it was committed in (the search loop advances these)
        self.goal_tag = "TpuSearch"
        self.round_index = 0

    def _cost(self, b: int, dload=0.0, dlnwin=0.0, dpot=0.0, drc=0.0, dlc=0.0,
              dcload=0.0):
        ctx = self.ctx
        return _np_broker_cost(
            self.cfg,
            self.can,
            ctx.broker_capacity[b],
            ctx.broker_load[b] + dload,
            ctx.broker_leader_load[b, Resource.NW_IN] + dlnwin,
            ctx.broker_potential_nw_out[b] + dpot,
            float(ctx.broker_replica_count[b]) + drc,
            float(ctx.broker_leader_count[b]) + dlc,
            cload=(
                ctx.broker_cap_load[b] + dcload if ctx.cap_distinct else None
            ),
        )

    def evaluate(self, kind: int, p: int, s: int, d: int):
        """Returns (action, exact_delta) or (None, inf) when infeasible."""
        ctx, cfg, can = self.ctx, self.cfg, self.can
        row = ctx.assignment[p]
        S = row.shape[0]
        if row[s] == EMPTY_SLOT:
            return None, np.inf
        leader_now = ctx.leader_slot[p] == s
        must_move = bool(ctx.replica_offline[p, s])
        cap_thr = can["cap_threshold"]

        if kind == KIND_MOVE:
            src, dst = int(row[s]), d
            if dst < 0 or src == dst or not self.dest_ok[dst]:
                return None, np.inf
            if (row == dst).any() or (ctx.offline_origin[p] == dst).any():
                return None, np.inf
            # rack clash with any *other* replica of p
            others = np.delete(row, s)
            others = others[others != EMPTY_SLOT]
            if (ctx.broker_rack[others] == ctx.broker_rack[dst]).any():
                return None, np.inf
            move_load = ctx.replica_load_vec(p, s)
            move_cap = ctx.replica_cap_load_vec(p, s)
            dst_after = ctx.broker_cap_load[dst] + move_cap
            if (dst_after > ctx.broker_capacity[dst] * cap_thr + 1e-6).any():
                return None, np.inf
            if ctx.broker_replica_count[dst] + 1 > can["max_replicas"]:
                return None, np.inf
            if self.excluded[p] and not must_move:
                return None, np.inf
            if leader_now and not self.lead_ok[dst]:
                return None, np.inf
            l_delta = 1.0 if leader_now else 0.0
            lnwin_delta = ctx.leader_load[p, Resource.NW_IN] if leader_now else 0.0
            pot_delta = ctx.leader_load[p, Resource.NW_OUT]
            delta = (
                self._cost(src, -move_load, -lnwin_delta, -pot_delta, -1.0,
                           -l_delta, dcload=-move_cap)
                - self._cost(src)
                + self._cost(dst, move_load, lnwin_delta, pot_delta, 1.0,
                             l_delta, dcload=move_cap)
                - self._cost(dst)
            )
            delta += (
                move_load[Resource.DISK] / can["avg_disk_cap"] * cfg.w_move_size
            )
            if must_move:
                delta -= 1e6
            else:
                # rack-violation repair bonus (canonical-holder rule)
                lower = row[:s]
                lower = lower[lower != EMPTY_SLOT]
                if (ctx.broker_rack[lower] == ctx.broker_rack[src]).any():
                    delta -= 1e4
            action = BalancingAction(
                ActionType.INTER_BROKER_REPLICA_MOVEMENT, p, s, src, dst,
                goal=self.goal_tag, round=self.round_index,
            )
            return action, delta

        # leadership transfer to slot s
        src = ctx.leader_broker(p)
        dst = int(row[s])
        if leader_now or not self.lead_ok[dst] or must_move or self.excluded[p]:
            return None, np.inf
        lead_delta = (ctx.leader_load[p] - ctx.follower_load[p]).astype(np.float64)
        lead_cap_delta = (
            ctx.leader_cap_load[p] - ctx.follower_cap_load[p]
        ).astype(np.float64)
        dst_after = ctx.broker_cap_load[dst] + lead_cap_delta
        if (dst_after > ctx.broker_capacity[dst] * cap_thr + 1e-6).any():
            return None, np.inf
        lnwin = ctx.leader_load[p, Resource.NW_IN]
        delta = (
            self._cost(src, -lead_delta, -lnwin, 0.0, 0.0, -1.0,
                       dcload=-lead_cap_delta)
            - self._cost(src)
            + self._cost(dst, lead_delta, lnwin, 0.0, 0.0, 1.0,
                         dcload=lead_cap_delta)
            - self._cost(dst)
        )
        action = BalancingAction(
            ActionType.LEADERSHIP_MOVEMENT,
            p, int(ctx.leader_slot[p]), src, dst, dest_slot=s,
            goal=self.goal_tag, round=self.round_index,
        )
        return action, delta

    def commit_batch(self, kind, p, s, d) -> Tuple[List[BalancingAction], int]:
        """Vectorized evaluate + apply of ONE device step's batch.

        The device selected these actions on two paths: the budgeted cohort
        (many moves may SHARE a source or destination broker, each fitting
        the water-filling budgets — see _step_budgets) plus the disjoint
        auction (partitions/src/dst pairwise-distinct, _match_batch).
        Partitions are always distinct.  Evaluating the whole batch against
        the step-start snapshot matches the device's own acceptance
        semantics; for shared-endpoint cohort rows the budgets guarantee
        each move individually improves the convex cost regardless of the
        rest of the batch, and the cumulative per-destination trim below
        re-checks the hard-capacity headroom that improvement alone does
        not bound.  For src/dst overlaps across the two paths the convexity
        argument in _match_batch applies: realized deltas only improve on
        the snapshot scores.  The batched apply
        stays exact under that overlap ONLY because every aggregate update
        uses unbuffered accumulation (np.add.at) — do not "simplify" those
        to fancy-index assignment, which drops one of two updates to a
        broker that is src of one action and dst of another.  The
        per-action Python replay this replaces cost ~180µs × 70k actions
        ≈ 13s on a north-star run; this is the same arithmetic in a handful
        of numpy passes per step.

        Returns (accepted actions — already applied to the context, #rejected).
        """
        ctx, cfg, can = self.ctx, self.cfg, self.can
        if ctx.replica_disk is not None:
            # JBOD placement picks each move's destination disk from live
            # disk loads (least_loaded_disk) — inherently sequential
            acts: List[BalancingAction] = []
            rej = 0
            for i in range(kind.shape[0]):
                action, delta = self.evaluate(
                    int(kind[i]), int(p[i]), int(s[i]), int(d[i])
                )
                if action is None or delta >= cfg.improvement_tol:
                    rej += 1
                    continue
                ctx.apply(action)
                acts.append(action)
            return acts, rej

        n = kind.shape[0]
        S = ctx.assignment.shape[1]
        B = ctx.num_brokers
        ar = np.arange(n)
        sc = np.clip(s, 0, S - 1)
        row = ctx.assignment[p]                              # [n, S]
        slot_b = row[ar, sc]
        lslot = ctx.leader_slot[p]
        leader_b = row[ar, lslot]
        is_lead = kind == KIND_LEADERSHIP
        src = np.where(is_lead, leader_b, slot_b).astype(np.int64)
        dst = np.where(is_lead, slot_b, d).astype(np.int64)
        exists = slot_b != EMPTY_SLOT
        leader_now = lslot == sc
        must_move = ctx.replica_offline[p, sc]
        excluded = self.excluded[p]

        move_load = np.where(
            leader_now[:, None], ctx.leader_load[p], ctx.follower_load[p]
        ).astype(np.float64)
        lead_delta = (ctx.leader_load[p] - ctx.follower_load[p]).astype(
            np.float64
        )
        dload = np.where(is_lead[:, None], lead_delta, move_load)
        if ctx.cap_distinct:
            cmove = np.where(
                leader_now[:, None],
                ctx.leader_cap_load[p], ctx.follower_cap_load[p],
            ).astype(np.float64)
            clead = (
                ctx.leader_cap_load[p] - ctx.follower_cap_load[p]
            ).astype(np.float64)
            dcload = np.where(is_lead[:, None], clead, cmove)
        else:
            dcload = dload

        dst_c = np.clip(dst, 0, B - 1)
        src_c = np.clip(src, 0, B - 1)
        cap_ok = (
            ctx.broker_cap_load[dst_c] + dcload
            <= ctx.broker_capacity[dst_c] * can["cap_threshold"] + 1e-6
        ).all(axis=1)

        row_safe = np.clip(row, 0, None)
        dup = (row == dst[:, None]).any(axis=1) | (
            ctx.offline_origin[p] == dst[:, None]
        ).any(axis=1)
        others = (row != EMPTY_SLOT) & (np.arange(S)[None, :] != sc[:, None])
        other_racks = np.where(others, ctx.broker_rack[row_safe], -1)
        rack_clash = (other_racks == ctx.broker_rack[dst_c][:, None]).any(axis=1)
        move_ok = (
            (d >= 0)
            & (src != dst)
            & exists
            & self.dest_ok[dst_c]
            & ~dup
            & ~rack_clash
            & cap_ok
            & (ctx.broker_replica_count[dst_c] + 1 <= can["max_replicas"])
            & ~(excluded & ~must_move)
            & (~leader_now | self.lead_ok[dst_c])
        )
        lead_ok = (
            exists & ~leader_now & self.lead_ok[dst_c] & ~must_move
            & ~excluded & cap_ok
        )
        feasible = np.where(is_lead, lead_ok, move_ok) & (src >= 0)

        l_delta = np.where(is_lead | leader_now, 1.0, 0.0)
        r_delta = np.where(is_lead, 0.0, 1.0)
        lnwin_delta = np.where(
            is_lead | leader_now, ctx.leader_load[p, Resource.NW_IN], 0.0
        ).astype(np.float64)
        pot_delta = np.where(
            is_lead, 0.0, ctx.leader_load[p, Resource.NW_OUT]
        ).astype(np.float64)

        def cost(b, dl, dlnw, dpot, drc, dlc, dcl):
            return _np_broker_cost_batch(
                cfg, can, ctx.broker_capacity[b],
                ctx.broker_load[b] + dl,
                ctx.broker_leader_load[b, Resource.NW_IN] + dlnw,
                ctx.broker_potential_nw_out[b] + dpot,
                ctx.broker_replica_count[b].astype(np.float64) + drc,
                ctx.broker_leader_count[b].astype(np.float64) + dlc,
                cload=(
                    ctx.broker_cap_load[b] + dcl if ctx.cap_distinct else None
                ),
            )

        # ONE stacked cost evaluation for (src_new, src_old, dst_new,
        # dst_old): the recheck runs ~2k times per north-star search and
        # was numpy-dispatch bound — 4 separate ~35-op cost calls per step
        # were over half its time (round-5 item #4)
        z1 = np.zeros(n)
        zR = np.zeros((n, NUM_RESOURCES))
        bb = np.concatenate([src_c, src_c, dst_c, dst_c])
        c4 = cost(
            bb,
            np.concatenate([-dload, zR, dload, zR]),
            np.concatenate([-lnwin_delta, z1, lnwin_delta, z1]),
            np.concatenate([-pot_delta, z1, pot_delta, z1]),
            np.concatenate([-r_delta, z1, r_delta, z1]),
            np.concatenate([-l_delta, z1, l_delta, z1]),
            np.concatenate([-dcload, zR, dcload, zR]),
        )
        delta = c4[:n] - c4[n:2 * n] + c4[2 * n:3 * n] - c4[3 * n:]
        delta += np.where(
            is_lead, 0.0,
            move_load[:, Resource.DISK] / can["avg_disk_cap"] * cfg.w_move_size,
        )
        lower = (np.arange(S)[None, :] < sc[:, None]) & (row != EMPTY_SLOT)
        lower_racks = np.where(lower, ctx.broker_rack[row_safe], -1)
        rack_viol = (lower_racks == ctx.broker_rack[src_c][:, None]).any(axis=1)
        delta = np.where(~is_lead & must_move, delta - 1e6, delta)
        delta = np.where(~is_lead & ~must_move & rack_viol, delta - 1e4, delta)

        acc = feasible & (delta < cfg.improvement_tol)
        idx = np.nonzero(acc)[0]
        if idx.size > 1:
            # cumulative per-destination recheck (advisor round-1 medium):
            # cohort batches may land many moves on one destination, and
            # cap_ok above is per-action against the snapshot — a breach of
            # capacity-threshold/max-replicas *within* the batch would only
            # surface later as an OptimizationFailure from _finalize.
            # Segmented inclusive prefixes (batch rows are in device score
            # order) against the snapshot headroom trim breaching rows now,
            # as action-level rejections.  Conservative: a trimmed row
            # still counts in later rows' prefixes.
            ds = dst[idx]
            o = np.argsort(ds, kind="stable")
            dso = ds[o]
            # clip to the positive components: leadership rows may carry a
            # negative delta in some resource (follower load can exceed
            # leader load), and a trimmed row's negative component must not
            # loosen later rows' prefixes — positive-only prefixes keep the
            # trim conservative in every case
            dlo = np.maximum(dcload[idx][o], 0.0)
            rco = r_delta[idx][o]
            cs = np.cumsum(dlo, axis=0)
            csr = np.cumsum(rco)
            firsts = np.ones(dso.size, bool)
            firsts[1:] = dso[1:] != dso[:-1]
            start = np.maximum.accumulate(
                np.where(firsts, np.arange(dso.size), -1)
            )
            incl = cs - (cs[start] - dlo[start])
            inclr = csr - (csr[start] - rco[start])
            head = (
                ctx.broker_capacity[dso] * can["cap_threshold"]
                - ctx.broker_cap_load[dso]
            )
            ok = (incl <= head + 1e-6).all(axis=1) & (
                ctx.broker_replica_count[dso] + inclr <= can["max_replicas"]
            )
            if not ok.all():
                acc[idx[o[~ok]]] = False
                idx = np.nonzero(acc)[0]
        n_rej = n - idx.size
        if not idx.size:
            return [], n_rej

        # ---- batched apply (numpy twin of ctx.apply for the disjoint set) ----
        # mutating aggregates outside ctx.apply: stale memos (balance
        # bounds, alive averages) must not survive into the next recheck
        # or the swap-repair pass
        ctx.invalidate()
        pm, sm = p[idx], sc[idx]
        t = ctx.partition_topic[pm]
        srcs, dsts = src[idx], dst[idx]
        mv = ~is_lead[idx]
        dl = dload[idx]
        ctx.assignment[pm[mv], sm[mv]] = dsts[mv].astype(np.int32)
        ctx.replica_offline[pm[mv], sm[mv]] = False
        ctx.leader_slot[pm[~mv]] = sm[~mv]
        np.add.at(ctx.broker_load, srcs, -dl)
        np.add.at(ctx.broker_load, dsts, dl)
        if ctx.cap_distinct:
            dcl = dcload[idx]
            np.add.at(ctx.broker_cap_load, srcs, -dcl)
            np.add.at(ctx.broker_cap_load, dsts, dcl)
        one = np.ones(int(mv.sum()), np.int64)
        np.add.at(ctx.broker_replica_count, srcs[mv], -one)
        np.add.at(ctx.broker_replica_count, dsts[mv], one)
        np.add.at(ctx.broker_topic_replica_count, (srcs[mv], t[mv]), -one)
        np.add.at(ctx.broker_topic_replica_count, (dsts[mv], t[mv]), one)
        np.add.at(ctx.broker_potential_nw_out, srcs, -pot_delta[idx])
        np.add.at(ctx.broker_potential_nw_out, dsts, pot_delta[idx])
        ll = l_delta[idx] > 0          # leadership landed on dst
        lone = np.ones(int(ll.sum()), np.int64)
        np.add.at(ctx.broker_leader_count, srcs[ll], -lone)
        np.add.at(ctx.broker_leader_count, dsts[ll], lone)
        lload = ctx.leader_load[pm[ll]].astype(np.float64)
        np.add.at(ctx.broker_leader_load, srcs[ll], -lload)
        np.add.at(ctx.broker_leader_load, dsts[ll], lload)
        np.add.at(ctx.broker_topic_leader_count, (srcs[ll], t[ll]), -lone)
        np.add.at(ctx.broker_topic_leader_count, (dsts[ll], t[ll]), lone)

        acts = []
        old_lslot = lslot[idx]
        for j in range(idx.size):
            if mv[j]:
                a = BalancingAction(
                    ActionType.INTER_BROKER_REPLICA_MOVEMENT,
                    int(pm[j]), int(sm[j]), int(srcs[j]), int(dsts[j]),
                    goal=self.goal_tag, round=self.round_index,
                )
            else:
                a = BalancingAction(
                    ActionType.LEADERSHIP_MOVEMENT,
                    int(pm[j]), int(old_lslot[j]), int(srcs[j]), int(dsts[j]),
                    dest_slot=int(sm[j]), goal=self.goal_tag,
                    round=self.round_index,
                )
            acts.append(a)
        ctx.actions.extend(acts)
        return acts, n_rej



# ---------------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------------

class CudaGoalOptimizer:
    """Drop-in engine with the GoalOptimizer API and a CUDA inner loop.

    ``device`` defaults to ``cuda`` and raises when no card is present;
    tests pass ``device="cpu"`` to run the same path on the plain kernels'
    twins."""

    def __init__(
        self,
        constraint: Optional[BalancingConstraint] = None,
        config: Optional[CudaSearchConfig] = None,
        device="cuda",
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh is not ported yet (ROADMAP.md A11 multi-GPU)")
        self.constraint = constraint or BalancingConstraint()
        self.config = config or CudaSearchConfig()
        _check_config(self.config)
        self.device = resolve_device(device)

    # ---- constraint tensors ---------------------------------------------------
    def _constraint_arrays_np(self, ctx: AnalyzerContext) -> Dict[str, np.ndarray]:
        """Host (numpy) constraint bundle — also feeds the exact commit check."""
        c = self.constraint
        alive = ctx.broker_alive
        n_alive = max(int(alive.sum()), 1)
        avg_util = np.array(
            [ctx.avg_alive_utilization(r) for r in Resource], np.float32
        )
        lower = np.empty(NUM_RESOURCES, np.float32)
        upper = np.empty(NUM_RESOURCES, np.float32)
        for r in Resource:
            lower[r], upper[r] = c.balance_bounds(float(avg_util[r]), r)
            if avg_util[r] < c.low_utilization_threshold[r]:
                lower[r], upper[r] = 0.0, np.inf
        cap_thr = np.array([c.capacity_threshold[r] for r in Resource], np.float32)
        total_lnwin = ctx.broker_leader_load[:, Resource.NW_IN].sum()
        cap_nwin = ctx.broker_capacity[alive, Resource.NW_IN].sum()
        avg_lnwin_u = float(total_lnwin / max(cap_nwin, 1e-9))
        _, lnwin_upper = c.balance_bounds(avg_lnwin_u, Resource.NW_IN)
        avg_rcount = float(ctx.broker_replica_count[alive].sum() / n_alive)
        avg_lcount = float(ctx.broker_leader_count[alive].sum() / n_alive)
        rc_lo, rc_up = c.count_bounds(avg_rcount, c.replica_balance_threshold)
        lc_lo, lc_up = c.count_bounds(avg_lcount, c.leader_replica_balance_threshold)
        return {
            "util_lower": lower,
            "util_upper": upper,
            "cap_threshold": cap_thr,
            "avg_rcount": np.float32(max(avg_rcount, 1.0)),
            "avg_lcount": np.float32(max(avg_lcount, 1.0)),
            "rcount_lower": np.float32(rc_lo),
            "rcount_upper": np.float32(rc_up),
            "lcount_lower": np.float32(lc_lo),
            "lcount_upper": np.float32(lc_up),
            "leader_nwin_upper": np.float32(lnwin_upper),
            "max_replicas": np.float32(c.max_replicas_per_broker),
            "avg_disk_cap": np.float32(
                float(ctx.broker_capacity[:, Resource.DISK].mean()) or 1.0
            ),
        }

    def _constraint_arrays(self, ctx: AnalyzerContext) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self._constraint_arrays_np(ctx).items()}

    def _device_model(self, ctx: AnalyzerContext) -> DeviceModel:
        """Upload the host context as a DeviceModel and rebuild its
        aggregates on the device."""
        dev = self.device
        P, S = ctx.assignment.shape
        B = ctx.num_brokers

        def up(x):
            # a copy: the context's cached masks are read-only arrays
            return torch.tensor(np.asarray(x), device=dev)

        zf = torch.zeros(B, dtype=torch.float32, device=dev)
        m = DeviceModel(
            assignment=up(ctx.assignment),
            leader_slot=up(ctx.leader_slot),
            leader_load=up(ctx.leader_load),
            follower_load=up(ctx.follower_load),
            partition_topic=torch.zeros(P, dtype=torch.int32, device=dev),
            capacity=up(ctx.broker_capacity),
            rack=up(ctx.broker_rack),
            dest_ok=up(ctx.dest_candidates()),
            lead_ok=up(ctx.leadership_candidates()),
            alive=up(ctx.broker_alive),
            excluded=up(ctx.excluded_partition_mask()),
            must_move=up(ctx.replica_offline),
            offline_origin=up(ctx.offline_origin),
            broker_load=torch.zeros((B, NUM_RESOURCES), device=dev),
            leader_nwin=zf, pot_nwout=zf, rcount=zf, lcount=zf,
            leader_cload=up(ctx.leader_cap_load) if ctx.cap_distinct else None,
            follower_cload=(up(ctx.follower_cap_load) if ctx.cap_distinct
                            else None),
        )
        m = dataclasses.replace(m, pload=pack_pload(
            m.leader_load, m.follower_load, m.excluded,
            m.leader_cload, m.follower_cload,
        ))
        return _recompute_aggregates(m)

    def _pool_sizes(self, P: int, S: int, B: int) -> Tuple[int, int]:
        cfg = self.config
        D = max(8, min(B, cfg.max_dest_brokers))
        K = min(P * S, cfg.max_source_replicas,
                max(256, cfg.candidate_budget // D))
        return K, min(D, B, max(8, cfg.candidate_budget // max(K, 1)))

    # ---- main loop ------------------------------------------------------------
    def optimize(
        self,
        state: ClusterState,
        options: Optional[OptimizationOptions] = None,
        warm_start=None,
        carry=None,
    ) -> OptimizerResult:
        """Plan a rebalance of ``state`` (host-first; a state on the card is
        copied to the host for the exact recheck)."""
        from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals

        if warm_start is not None or carry is not None:
            raise NotImplementedError(
                "warm_start/carry are not ported yet "
                "(ROADMAP.md A4 (warm start / carry))")
        t0 = time.perf_counter()
        state = state.to("cpu")
        ctx = AnalyzerContext(state, options)
        initial_assignment = ctx.assignment.copy()
        initial_leader_slot = ctx.leader_slot.copy()
        initial_replica_disk = (
            ctx.replica_disk.copy() if ctx.replica_disk is not None else None
        )
        goals = make_goals(constraint=self.constraint)
        violations_before = {g.name: g.violations(ctx) for g in goals}
        stats_before = stats_summary(cluster_stats(state))
        return self._search(
            state, ctx, goals, violations_before, stats_before,
            initial_assignment, initial_leader_slot, initial_replica_disk,
            t0, self.config,
        )

    def _search(
        self, state, ctx, goals, violations_before, stats_before,
        initial_assignment, initial_leader_slot, initial_replica_disk, t0,
        cfg,
    ) -> OptimizerResult:
        t_up = time.perf_counter()
        m = self._device_model(ctx)
        can = self._constraint_arrays_np(ctx)
        ca = {k: torch.as_tensor(v, device=self.device) for k, v in can.items()}
        consts = grid_consts(cfg, ca, self.device)
        P, S, B = ctx.num_partitions, ctx.max_rf, ctx.num_brokers
        K, D = self._pool_sizes(P, S, B)
        evaluator = _HostEvaluator(ctx, cfg, can)
        evaluator.goal_tag = "CudaSearch"
        actions: List[BalancingAction] = []
        pass_summaries: List[dict] = []

        if cfg.device_batch_per_step == 0:
            # auto: the useful batch scales with broker count
            cfg = dataclasses.replace(
                cfg, device_batch_per_step=int(np.clip(B // 2, 32, 2048))
            )
        T = cfg.steps_per_call
        # the bound preserves the score-only path's total action budget
        # counted in steps (evacuations commit one per step)
        calls_budget = max(
            cfg.max_rounds,
            -(cfg.max_rounds * cfg.max_moves_per_round) // -T,
        )
        n_calls = n_committed = n_rejected = n_steps = 0
        tab = _cold_tables(m)
        # host wall-clock by phase: upload (model + aggregates), device
        # (the step loop, whose per-step count read waits for the card),
        # fetch (the packed prefix), recheck (exact f64 replay), resync
        timing = {"upload": time.perf_counter() - t_up, "device": 0.0,
                  "fetch": 0.0, "recheck": 0.0, "resync": 0.0}
        while n_calls < calls_budget:
            t_call = time.perf_counter()
            res, m_new, tab_new = _scan_call(m, cfg, ca, consts, K, D, T, tab)
            timing["fetch"] += res.diag["fetch_s"]
            timing["device"] += (time.perf_counter() - t_call
                                 - res.diag["fetch_s"])
            n_calls += 1
            n_steps += int(res.diag["steps_run"])
            evaluator.round_index = n_calls
            t_re = time.perf_counter()
            batch = rejected = off = 0
            for c in res.step_counts:
                c = int(c)
                if c == 0:
                    continue
                # one device step = one batch: vectorized exact recheck +
                # apply; a rejection skips just that action
                acts, n_rej = evaluator.commit_batch(
                    res.kind[off:off + c], res.p[off:off + c],
                    res.s[off:off + c], res.d[off:off + c],
                )
                off += c
                actions.extend(acts)
                batch += len(acts)
                rejected += n_rej
            timing["recheck"] += time.perf_counter() - t_re
            n_committed += batch
            n_rejected += rejected
            if not batch:
                LOG.debug("device call %d: nothing validated — stopping",
                          n_calls)
                break
            if not rejected:
                # clean validation: the device model is exactly the host's
                m = m_new
                tab = tab_new + (True,)
                if res.done:
                    break
            else:
                LOG.debug(
                    "device call %d: %d committed, %d rejected by host "
                    "recheck — resyncing device model", n_calls, batch,
                    rejected,
                )
                t_rs = time.perf_counter()
                m = _resync_device_model(m_new, ctx)
                tab = _cold_tables(m)
                timing["resync"] += time.perf_counter() - t_rs
        LOG.info(
            "resident search: %d device calls, %d steps, %d actions "
            "committed, %d rejected", n_calls, n_steps, n_committed,
            n_rejected,
        )
        pass_summaries.append({
            "goal": "CudaSearch", "pass": 0,
            "accepted": int(n_committed),
            "rejected": (
                {"no-improvement": int(n_rejected)} if n_rejected else {}
            ),
            "rounds": int(n_calls),
            "steps": int(n_steps),
            "timing_s": timing,
        })

        # Host swap-repair pass: when hard violations survive the search,
        # replay the greedy hard goals host-side (their optimize() carries
        # the swap fallback the device vocabulary lacks).
        if any(g.is_hard and g.violations(ctx) > 0 for g in goals):
            n_before = len(ctx.actions)
            repaired: List = []
            for g in goals:
                if not g.is_hard:
                    continue
                ctx.current_goal = g.name
                ctx.current_round = len(pass_summaries) + len(repaired)
                try:
                    g.optimize(ctx, repaired)
                except Exception as e:  # leave the verdict to _finalize
                    LOG.warning("host swap-repair: %s: %s", g.name, e)
                repaired.append(g)
            ctx.current_goal, ctx.current_round = "", -1
            new_actions = ctx.actions[n_before:]
            actions.extend(new_actions)
            from cruise_control_tpu_torch.analyzer.goal_optimizer import (
                goal_pass_summaries,
            )

            offset = len(pass_summaries)
            for ent in goal_pass_summaries(repaired, ctx):
                ent["pass"] += offset
                pass_summaries.append(ent)
            LOG.info(
                "host swap-repair pass committed %d actions for residual "
                "hard violations", len(new_actions),
            )
        return self._finalize(
            state, ctx, goals, actions, violations_before, stats_before,
            initial_assignment, initial_leader_slot, initial_replica_disk,
            t0, pass_summaries,
        )

    def _finalize(
        self, state, ctx, goals, actions, violations_before, stats_before,
        initial_assignment, initial_leader_slot, initial_replica_disk, t0,
        pass_summaries: Optional[List[dict]] = None,
    ) -> OptimizerResult:
        violations_after = {g.name: g.violations(ctx) for g in goals}
        # same contract as GoalOptimizer: a plan that leaves hard goals
        # violated must not reach the executor
        from cruise_control_tpu_torch.analyzer.goals.base import (
            OptimizationFailure,
        )

        for g in goals:
            if g.is_hard and violations_after[g.name] > 0:
                LOG.error(
                    "hard goal %s still violated after CUDA search: %d "
                    "(before: %d)", g.name, violations_after[g.name],
                    violations_before[g.name],
                )
                e = OptimizationFailure(
                    f"{g.name} still violated after CUDA search "
                    f"({violations_after[g.name]} violations)"
                )
                e.goal_summaries = list(pass_summaries or ())
                raise e
        if ctx.replica_offline.any():
            e = OptimizationFailure(
                "offline replicas could not be evacuated by CUDA search"
            )
            e.goal_summaries = list(pass_summaries or ())
            raise e
        LOG.info(
            "CUDA search done: %d actions, violations %d -> %d, %.2fs",
            len(actions), sum(violations_before.values()),
            sum(violations_after.values()), time.perf_counter() - t0,
        )
        final_state = ctx.to_state(state)
        stats_after = stats_summary(cluster_stats(final_state))
        from cruise_control_tpu_torch.analyzer.provision import (
            analyze_provisioning_arrays,
        )

        return OptimizerResult(
            proposals=diff_proposals(
                initial_assignment, initial_leader_slot, ctx,
                initial_replica_disk,
            ),
            actions=actions,
            violations_before=violations_before,
            violations_after=violations_after,
            stats_before=stats_before,
            stats_after=stats_after,
            final_state=final_state,
            duration_s=time.perf_counter() - t0,
            engine="cuda",
            provision=analyze_provisioning_arrays(
                ctx.broker_alive, ctx.broker_load, ctx.broker_capacity
            ),
            goal_summaries=list(pass_summaries or ()),
        )

"""CudaGoalOptimizer — the rebalance-plan engine on an NVIDIA card.

PyTorch port of the reference's device-resident search
(``cruise_control_tpu.analyzer.tpu_optimizer``), default single-device
path.  The search keeps the model on the card and runs, per step,
**repool → rescore → reduce → compact → cohort → auction → apply**:

* **Candidates**: the top-K priority source replicas × the top-D
  least-loaded destination brokers (the move grid: its terms computed by
  the hand-written kernel K2, scored and ranked per row by K1 —
  :func:`ops.grid.grid_rescore`), plus a pruned pool of leadership
  transfers scored by K6 (:mod:`analyzer.score_kernel`).
* **Feasibility** (hard goals) and **cost** (soft goals) are the same
  fused mask and exact O(1) cost deltas as the reference.
* **Selection**: per-source-broker reduction (kernel K3), compaction to
  the best C rows (K7, :mod:`analyzer.compact_kernel`), a budgeted cohort
  (water-filling sufficient conditions, K4) and a disjoint auction
  started from the cohort's footprint (K5) pick a batch per step
  (:mod:`analyzer.step_kernels`); K8 commits it in score order and
  applies it to the device model, and K9 rebuilds the aggregates at
  upload and resync (:mod:`analyzer.commit_kernels`).  Each wrapper sits
  beside its plain twin, which keeps the reference's name
  (``_score_candidates``, ``_reduce_leadership_per_src`` /
  ``_topq_rows_per_src``, ``_cohort_budgets`` / ``_budget_accept``,
  ``_match_batch``, ``_apply_batch_on_device``,
  ``_recompute_aggregates``); this module imports them under those
  names.
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
# the step's chains: their plain twins are imported under their reference
# names beside the kernel wrappers that replace them on the card
from cruise_control_tpu_torch.analyzer.commit_kernels import (  # noqa: F401
    MUTABLE,
    _apply_batch_on_device,
    _recompute_aggregates,
    commit_batch,
    recompute_aggregates,
)
from cruise_control_tpu_torch.analyzer.compact_kernel import compact_rows
from cruise_control_tpu_torch.analyzer.score_kernel import (  # noqa: F401
    KIND_LEADERSHIP,
    KIND_MOVE,
    _score_candidates,
    score_candidates,
)
from cruise_control_tpu_torch.analyzer.step_kernels import (  # noqa: F401
    _budget_accept,
    _cohort_budgets,
    _match_batch,
    _reduce_leadership_per_src,
    _scatter_min,
    _seg_excl_prefix,
    _seg_prefix_fits,
    _step_budgets,
    _topq_rows_per_src,
    budget_accept,
    match_batch,
    per_src_top,
)
from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.models.stats import cluster_stats, stats_summary
from cruise_control_tpu_torch.ops.cost import pack_pload
from cruise_control_tpu_torch.ops.grid import (
    grid_consts,
    grid_rescore,
    terms_consts,
)
from cruise_control_tpu_torch.ops.pools import (
    pool_prio,
    pool_row_tables,
    pool_row_tables_update,
)
from cruise_control_tpu_torch.utils.device import resolve_device
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("engine")

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


def _resolve_batch(cfg: CudaSearchConfig, B: int) -> CudaSearchConfig:
    """``cfg`` with the step's commit batch set: ``device_batch_per_step=0``
    (auto) scales it with the broker count."""
    if cfg.device_batch_per_step:
        return cfg
    return dataclasses.replace(
        cfg, device_batch_per_step=int(np.clip(B // 2, 32, 2048)))


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

    # the commit (K8) updates the model in place on the card: the loop
    # works on its own copy of the mutable tensors, the caller's stays
    m = dataclasses.replace(m, **{
        f: getattr(m, f).clone() for f in MUTABLE
        if getattr(m, f) is not None})
    out = torch.full((4, slots), -1.0, device=dev)
    counts: List[int] = []
    diag_rows: List[Tuple[int, int, int]] = []
    done = False
    t = count = n_incr = 0
    since_pool = repool
    pools = None
    tconsts = terms_consts(cfg, ca, dev)
    # the leadership candidates' kinds and (unused) destinations for K6
    L = _leadership_pool_size(P, S, K)
    kind_l = torch.full((L,), KIND_LEADERSHIP, dtype=torch.int32, device=dev)
    cd_l = torch.zeros(L, dtype=torch.int32, device=dev)
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
            kp, ks, dest_pool, lp, lsl = pools
            # the flat [P·S] index of each move row's slot
            slot_of_row = kp.long() * S + ks.long()
            pt_valid = True
            tpp = torch.zeros(P, dtype=torch.bool, device=dev)
            since_pool = 0
        # every step's tensors keep the types and shapes of the first: the
        # wrappers check their inputs once a call
        checked = t > 0

        # ---- rescore: the move grid's terms (K2), per-row top-R (K1) and
        # the leadership pool (K6)
        src_term, vals, best_d = grid_rescore(m, cfg, ca, kp, ks, dest_pool,
                                              R, consts, tconsts)
        ls, _ = score_candidates(m, cfg, ca, kind_l, lp, lsl, cd_l, consts,
                                 tconsts, checked=checked)

        # ---- reduce: per-broker best transfer + top-Q move rows (K3); the
        # rows' best scores re-add the carried destination terms to the
        # source term, as the reference does (bit-parity of the row scores)
        sb = m.assignment.view(-1)[slot_of_row].clamp_min(0)
        row_best = src_term + (vals[:, 0] - src_term)
        bl, (rows_q, q_scores) = per_src_top(m, lp, lsl, ls, sb, row_best,
                                             B, Q)

        # ---- compact to the best C rows and the cohort's inputs (K7) -----
        c = compact_rows(m, q_scores, rows_q, bl, src_term, vals, best_d,
                         dest_pool, kp, ks, sb, C, cfg.improvement_tol,
                         checked=checked)

        # ---- cohort: water-filling budgets, two rounds of acceptance (K4)
        acc_b, _, _ = budget_accept(m, ca, c.d0, c.cand_src, c.move_vec,
                                    c.qual, cfg.cohort_budget_slack)

        # ---- auction for the rest, disjoint from the cohort (K5) --------
        take_d, win_score_d, win_dst_d = match_batch(
            c.cand_score, c.cand_dst, c.cand_src, c.rep, cfg.improvement_tol,
            B, C, dest_cap=cfg.auction_dest_cap, src_cap=cfg.auction_src_cap,
            stack_ratio=cfg.auction_stack_ratio, rounds=cfg.auction_rounds,
            acc=acc_b,
        )

        # ---- commit the M_step best in score order (K8) -----------------
        m, tpp, c_dev = commit_batch(
            m, acc_b, take_d, win_score_d, win_dst_d, c.cand_score, c.d0,
            c.is_move_row, c.cand_p, c.cand_s, c.cand_src, M_step, out,
            count, tpp, checked=checked)
        if cfg.step_diagnostics:
            diag_t = torch.cat([
                torch.stack([c.improving.sum(), acc_b.sum(),
                             (take_d & ~acc_b).sum()]),
                c_dev.long(),
            ]).tolist()
            diag_rows.append(tuple(diag_t[:3]))
            c_step = int(diag_t[3])
        else:
            c_step = int(c_dev)                 # the step's one host sync
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
    return recompute_aggregates(m)


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
        return recompute_aggregates(m)

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

        cfg = _resolve_batch(cfg, B)
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

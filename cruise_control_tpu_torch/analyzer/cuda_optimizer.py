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

Off the default path, as the reference: ``cohort_mode="corrected"`` runs
the exact-conservative stacked cohort (K15,
:mod:`analyzer.corrected_kernel`) in the step in place of K4;
``steps_per_call=0`` or ``scoring="columnar"`` make the **score-only
rounds** the search — each round a full repool, every candidate scored,
the ``topk_per_round`` best fetched in one packed read and rechecked on
the host one by one (:func:`_round`, kernels K13 / K14 in
:mod:`analyzer.round_kernels`) — and ``polish_rounds`` runs that loop
after the resident search; ``incremental_rescore=True`` keeps each row's
top-R as destination terms in a device carry and rescores only what the
step before made stale (:func:`_incremental_rescore`, kernels K16 / K17
in :mod:`analyzer.rescore_kernels`); ``time_budget_s`` caps each call's
steps once the hard goals hold (the cap rides the device carry).

The reference's ``lax.while_loop`` becomes chunks of masked steps: the
loop's carry (done flag, step, commit count, repool bookkeeping) lives in
a small device vector (:mod:`analyzer.step_state`) that K8 advances and
K10 / K11 read, so a step past the end of the loop does nothing.  On the
card a chunk of steps is captured once per optimizer and shape as a CUDA
graph and replayed (:mod:`analyzer.step_graph`); the host reads the carry
once a chunk and fetches the call's packed prefix once.  The repool is
kernels too: K10 builds the tables and priorities and decides the
incremental diet on the device, K11 selects the pools
(:mod:`analyzer.pool_kernels`).  Every selection that feeds a discrete
choice uses stable sorts or (score, index) scatter-mins, so ties go to
the lowest index as in XLA; every float segment sum is exact and
deterministic (:mod:`ops.segment`), so plans repeat run to run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.analyzer.compact_kernel import compact_rows
from cruise_control_tpu_torch.analyzer.corrected_kernel import (  # noqa: F401
    _corrected_accept,
    corrected_accept,
)
from cruise_control_tpu_torch.analyzer.pool_kernels import (
    PoolBuffers,
    pool_tables,
    top_select,
)
from cruise_control_tpu_torch.analyzer.rescore_kernels import (
    grid_patch,
    stale_sets,
)
from cruise_control_tpu_torch.analyzer.round_kernels import (
    DESTS_PER_SOURCE,
    round_keys,
    round_pack,
    score_columnar,
    unpack_round_result,
)
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
from cruise_control_tpu_torch.analyzer.step_graph import STEP_CHUNK, StepChunk
from cruise_control_tpu_torch.analyzer.step_state import StepState
from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.models.stats import cluster_stats, stats_summary
from cruise_control_tpu_torch.ops.cost import pack_pload
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.grid import (
    SRC_TERM_COL,
    grid_consts,
    grid_rescore,
    grid_rescore_carry,
    grid_terms,
    launch_grid_top_r,
    terms_consts,
)
from cruise_control_tpu_torch.telemetry import (
    device_cost,
    device_stats,
    kernel_budget,
    mesh_budget,
)
from cruise_control_tpu_torch.utils.device import DEVICE_LOCK, resolve_device
from cruise_control_tpu_torch.utils.locks import InstrumentedLock
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("engine")


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
    #: "auto" = "grid": the move grid through kernels K2 + K1; "columnar"
    #: scores the flattened K×D grid and every leadership transfer (K14),
    #: which only the score-only rounds run
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
    _resolve_scoring(cfg)
    if cfg.cohort_mode not in ("budget", "corrected"):
        raise ValueError(f"unknown cohort_mode {cfg.cohort_mode!r}")
    if cfg.topk_mode not in ("approx", "exact"):
        raise ValueError(f"unknown topk_mode {cfg.topk_mode!r}")


def _resolve_scoring(cfg: CudaSearchConfig) -> str:
    """The round's scoring form: "auto" is "grid"."""
    if cfg.scoring not in ("auto", "grid", "columnar"):
        raise ValueError(
            f"unknown scoring {cfg.scoring!r} (auto/grid/columnar)")
    return "grid" if cfg.scoring == "auto" else cfg.scoring


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

def _leadership_pool_size(P: int, S: int, K: int) -> int:
    """Static leadership-pool size: full grid for small models, pruned to
    the move-pool scale for large ones."""
    return min(P * S, max(K, 4096))


def _repool(m: DeviceModel, ca, pb: PoolBuffers, state, rows_budget: int,
            checked: bool = False) -> None:
    """One repool into ``pb`` when the carry ``state`` asks for it: the
    tables and priorities (K10), then top-K move slots, top-D destinations
    and top-L leadership slots (K11) — the reference's ``rebuild_pools``
    under ``lax.cond`` (:1016) with ``_select_round_pools`` (:688) and
    ``_leadership_pool`` (:2173): four launches on the card, K10's one
    and K11's three."""
    S = m.assignment.shape[1]
    ws = pb.select_ws
    pool_tables(m, ca, pb, state, rows_budget, checked=checked)
    top_select(pb.prio.view(-1), pb.kp, pb.ks, pb.slot, S=S, state=state,
               ws=ws)
    top_select(pb.dneg, pb.dest_pool, state=state, ws=ws)
    top_select(pb.lprio.view(-1), pb.lp, pb.lsl, S=S, state=state, ws=ws)


def _build_pools(m: DeviceModel, cfg, ca, K: int, D: int, tables=None):
    """All P·S-scale candidate-pool selection → (kp, ks, dest_pool, lp,
    lsl): one repool into fresh buffers.  ``tables`` = stored move-pool row
    tables (ops.pools), used as they are; ``None`` recomputes them."""
    P, S = m.assignment.shape
    dev = m.assignment.device
    pb = PoolBuffers.empty(P, S, m.capacity.shape[0], K, D,
                           _leadership_pool_size(P, S, K), dev)
    st = StepState.empty(1, 1, 0, dev)
    st.state.copy_(st.initial(pt_valid=tables is not None))
    if tables is not None:
        pb.size.copy_(tables[0])
        pb.base.copy_(tables[1])
    _repool(m, ca, pb, st.state, P if tables is not None else -1)
    return pb.kp, pb.ks, pb.dest_pool, pb.lp, pb.lsl


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


#: the kernel wrappers a step launches (their ``.launches`` count replays);
#: a step runs K4 or, with ``cohort_mode="corrected"``, K15, and with
#: ``incremental_rescore=True`` K16 and K17
STEP_KERNELS = (pool_tables, top_select, grid_terms, launch_grid_top_r,
                score_candidates, per_src_top, compact_rows, budget_accept,
                corrected_accept, match_batch, commit_batch, stale_sets,
                grid_patch)


@dataclasses.dataclass
class RescoreCarry:
    """The incremental rescore's carry (``incremental_rescore=True``; the
    reference's ``sc``, ``tb``, ``tpm`` at :943, :1432-1447): each pool
    row's top-R destination terms and pool indices, the leadership scores,
    the step before's marks (K8 sets them, and clears its own from the
    lists ``marks``), and K16's index lists and stale counts for the
    patch.  Reset at every call (:meth:`reset`)."""

    dt: torch.Tensor          # f32 [K, R] score − src_term
    bd: torch.Tensor          # int32 [K, R] pool index (-1: none)
    ls: torch.Tensor          # f32 [L] leadership scores
    tb: torch.Tensor          # bool [B] brokers the step before touched
    tpm: torch.Tensor         # bool [P] partitions it moved
    marks: torch.Tensor       # int32 [3, M] K8's lists of those marks
    ridx: torch.Tensor        # int32 [RB] stale rows first
    cidx: torch.Tensor        # int32 [CB] stale columns (pool index, -1)
    lidx: torch.Tensor        # int32 [LB] stale leadership entries first
    nstale: torch.Tensor      # int32 [3] stale counts (rows, cols, leads)

    @classmethod
    def empty(cls, cfg, P, B, K, D, L, R, M, device):
        i32 = functools.partial(torch.empty, dtype=torch.int32, device=device)
        b8 = functools.partial(torch.zeros, dtype=torch.bool, device=device)
        return cls(torch.empty((K, R), device=device), i32((K, R)),
                   torch.empty(L, device=device), b8(B), b8(P),
                   i32((3, M)), i32(min(K, cfg.rescore_rows_budget)),
                   i32(min(D, cfg.rescore_cols_budget)),
                   i32(min(L, cfg.rescore_lead_budget)), i32(3))

    def reset(self) -> None:
        """The carry a call starts from (:1432-1447): no stored entries, no
        marks (one [P] fill a call, never a step)."""
        self.dt.fill_(float("inf"))
        self.bd.fill_(-1)
        self.ls.fill_(float("inf"))
        self.tb.zero_()
        self.tpm.zero_()
        self.marks.fill_(-1)


class _StepLoop:
    """The step loop's static buffers — every tensor a step reads or
    writes: the model, the constraint constants, the pool buffers, the
    device carry, the per-step meta and the output — and, on the card, the
    captured chunk of steps.  A search copies its model's fixed tensors and
    its constants in (:meth:`bind`), each scan call its placement,
    aggregates and row tables (:meth:`load`); the process keeps the loop
    (:func:`_keep_loop`) for the next search of the same shape on the same
    card, by any optimizer, which then replays the chunk without capturing
    it again."""

    def __init__(self, m: DeviceModel, cfg: CudaSearchConfig, ca, consts,
                 K: int, D: int, T: int, chunk: int = STEP_CHUNK):
        P, S = m.assignment.shape
        B = m.capacity.shape[0]
        dev = m.assignment.device
        self.cfg = cfg
        self.m = dataclasses.replace(m, **{
            f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)
            if getattr(m, f.name) is not None})
        self.ca = {k: v.clone() for k, v in ca.items()}
        self.consts = consts.clone()
        self.tconsts = terms_consts(cfg, ca, dev)
        self.B = B
        self.Q = max(1, cfg.moves_per_src)
        NROW = (self.Q + 1) * B
        M_run = min(cfg.device_batch_per_step, NROW)
        self.C = min(cfg.selection_rows, NROW)
        self.M_step = min(M_run, self.C)
        repool = max(1, cfg.repool_steps)
        slots = min(T, repool) * M_run
        RB_POOL = min(P, cfg.repool_rows_budget)
        # the pool-rebuild diet: refresh only the touched rows when the
        # carried tables are valid and the touched set fits the budget
        # (decided on the device); off when the budget covers every row
        self.rows_budget = (RB_POOL if cfg.repool_incremental and RB_POOL < P
                            else -1)
        self.R = min(DESTS_PER_SOURCE, D)
        L = _leadership_pool_size(P, S, K)
        self.pools = PoolBuffers.empty(P, S, B, K, D, L, dev)
        self.st = StepState.empty(T, repool, slots - M_run, dev)
        self.initial = {v: self.st.initial(v).to(dev) for v in (False, True)}
        self.out = torch.full((4, slots), -1.0, device=dev)
        # the leadership candidates' kinds and (unused) destinations for K6
        self.kind_l = torch.full((L,), KIND_LEADERSHIP, dtype=torch.int32,
                                 device=dev)
        self.cd_l = torch.zeros(L, dtype=torch.int32, device=dev)
        # every broker's cost as it stands, written by K2 and read by K6
        # in the same step
        self.bcost = torch.empty(B, dtype=torch.float32, device=dev)
        # the incremental rescore's carry, on that path only: the default
        # loop allocates nothing for it
        self.sc = (RescoreCarry.empty(cfg, P, B, K, D, L, self.R,
                                      self.M_step, dev)
                   if cfg.incremental_rescore else None)
        self.chunk = StepChunk(functools.partial(_step, self), chunk,
                               list(STEP_KERNELS))
        #: the key the search keeps the loop under (:func:`_keep_loop`):
        #: the signature its chunk's capture is counted and costed by
        self.key: Optional[tuple] = None

    def bind(self, m: DeviceModel, ca, consts) -> None:
        """Copy a search's fixed model tensors and constants in."""
        for f in dataclasses.fields(m):
            if f.name not in MUTABLE:
                _copy_in(getattr(m, f.name), getattr(self.m, f.name))
        for k, v in self.ca.items():
            v.copy_(ca[k])
        self.consts.copy_(consts)
        self.tconsts.copy_(terms_consts(self.cfg, ca, self.consts.device))

    def load(self, m: DeviceModel, tables, t_cap: Optional[int] = None
             ) -> None:
        """Copy the call's placement, aggregates and row-table carry into
        the static buffers and reset the carry, with the call's step cap
        ``t_cap`` (``None``: the loop's steps) — no host read."""
        for f in MUTABLE:
            _copy_in(getattr(m, f), getattr(self.m, f))
        size, base, tpp, pt_valid = tables
        pb = self.pools
        for src, dst in ((size, pb.size), (base, pb.base), (tpp, pb.tpp)):
            if src is not dst:
                dst.copy_(src)
        self.st.state.copy_(self.initial[bool(pt_valid)])
        if t_cap is not None:
            SS.cap(self.st, t_cap)
        if self.sc is not None:
            self.sc.reset()


#: device → (shape key, step loop): the one loop each device keeps, that
#: of its latest search, for the next search of the same shape, whichever
#: optimizer runs it (the served path builds a fresh optimizer for every
#: request).  A served process plans one cluster, so one shape is live at
#: a time; a search of another shape drops the kept loop before it builds
#: its own
_LOOPS: Dict[str, Tuple[tuple, "_StepLoop"]] = {}
_LOOPS_LOCK = InstrumentedLock("device.step_loops")


def _take_loop(key: tuple) -> Optional[_StepLoop]:
    """The loop kept on ``key``'s device, taken out for one search when it
    has ``key``'s shape (else dropped), or None."""
    with _LOOPS_LOCK:
        kept = _LOOPS.pop(key[0], None)
    return kept[1] if kept is not None and kept[0] == key else None


def _keep_loop(key: tuple, loop: _StepLoop) -> None:
    """Keep a search's loop on its device for the next search."""
    with _LOOPS_LOCK:
        _LOOPS[key[0]] = (key, loop)


def _copy_in(src, dst) -> None:
    if (src is None) != (dst is None):
        raise ValueError("step loop: the model's capacity loads are not "
                         "those the loop was built for")
    if src is not None and src is not dst:
        dst.copy_(src)


#: the functions a captured step chunk (analyzer/step_graph.py) records:
#: StepChunk holds the step as a callable, so cclint's jax-hot-path and
#: jax-transitive rules read their roots from this tuple
CAPTURED_ROOTS = ("_step",)


def _step(lp: _StepLoop, checked: bool) -> None:
    """One masked step (repool → rescore → reduce → compact → cohort →
    auction → apply) on the loop's static buffers — the reference's
    ``step`` (:941).  Every kernel reads the device carry or writes only
    scratch; the commit (K8) does nothing on an inactive step and advances
    the carry on an active one.  ``checked=True`` skips the wrappers'
    input checks (done on a call's first step)."""
    m, cfg, ca, pb = lp.m, lp.cfg, lp.ca, lp.pools
    _repool(m, ca, pb, lp.st.state, lp.rows_budget, checked)

    # ---- rescore: the move grid's terms (K2), per-row top-R (K1) and the
    # leadership pool (K6) — or, incrementally, only what went stale
    if lp.sc is None:
        src_term, vals, best_d = grid_rescore(m, cfg, ca, pb.kp, pb.ks,
                                              pb.dest_pool, lp.R, lp.consts,
                                              lp.tconsts, bcost=lp.bcost)
        ls, _ = score_candidates(m, cfg, ca, lp.kind_l, pb.lp, pb.lsl,
                                 lp.cd_l, lp.consts, lp.tconsts,
                                 checked=checked, bcost=lp.bcost)
    else:
        src_term = _incremental_rescore(lp, checked)
        vals, best_d, ls = lp.sc.dt, lp.sc.bd, lp.sc.ls

    # ---- reduce: per-broker best transfer + top-Q move rows (K3), from
    # the rows' slots and scores (it writes their source brokers, sb) ------
    bl, (rows_q, q_scores), sb = per_src_top(
        m, pb.lp, pb.lsl, ls, pb.slot, src_term, vals, lp.B, lp.Q,
        dest_terms=lp.sc is not None)

    # ---- compact to the best C rows and the cohort's inputs (K7) ---------
    c = compact_rows(m, q_scores, rows_q, bl, src_term, vals, best_d,
                     pb.dest_pool, pb.kp, pb.ks, sb, lp.C,
                     cfg.improvement_tol, checked=checked,
                     dest_terms=lp.sc is not None)

    # ---- cohort: water-filling budgets, two rounds of acceptance (K4), or
    # the exact-conservative stacked cohort (K15); static per loop
    if cfg.cohort_mode == "corrected":
        acc_b = corrected_accept(
            m, cfg, ca, c.cand_p, c.cand_s, c.cand_src, c.d0, c.move_vec,
            c.qual, cfg.improvement_tol, snap_score=c.cand_score[:, 0],
            consts=lp.consts, tconsts=lp.tconsts, checked=checked)
    else:
        acc_b, _, _ = budget_accept(m, ca, c.d0, c.cand_src, c.move_vec,
                                    c.qual, cfg.cohort_budget_slack)

    # ---- auction for the rest, disjoint from the cohort (K5) ------------
    take_d, win_score_d, win_dst_d = match_batch(
        c.cand_score, c.cand_dst, c.cand_src, c.rep, cfg.improvement_tol,
        lp.B, lp.C, dest_cap=cfg.auction_dest_cap,
        src_cap=cfg.auction_src_cap, stack_ratio=cfg.auction_stack_ratio,
        rounds=cfg.auction_rounds, acc=acc_b,
    )

    # ---- commit the M_step best in score order; advance the carry (K8);
    # on the incremental path, mark what the commits touched
    marks = ({} if lp.sc is None else
             dict(tb=lp.sc.tb, tpm=lp.sc.tpm, marks=lp.sc.marks))
    lp.m, pb.tpp, _ = commit_batch(
        m, acc_b, take_d, win_score_d, win_dst_d, c.cand_score, c.d0,
        c.is_move_row, c.cand_p, c.cand_s, c.cand_src, lp.M_step, lp.out,
        pb.tpp, c.improving, lp.st, checked=checked, **marks)


def _incremental_rescore(lp: _StepLoop, checked: bool) -> torch.Tensor:
    """The rescore of a step with ``incremental_rescore=True`` — the
    reference's :1075-1160 — into the loop's :class:`RescoreCarry`; every
    branch is taken on the device from the carry, so a captured chunk holds
    them all.  K2 packs the terms; K16 finds what the step before made
    stale and decides (FRESH); then either the full rescore — K1 over every
    row and K6 over the leadership pool, as destination terms — or the
    patch: K17 (the stale columns and the exact R + CB merge), K1 on the
    stale rows (b) and K6 on the stale leadership entries (c), each gated
    on FRESH.  → the source terms [K] (a view of K2's table)."""
    m, cfg, ca, pb, sc = lp.m, lp.cfg, lp.ca, lp.pools, lp.sc
    state = lp.st.state
    packed = grid_terms(m, cfg, ca, pb.kp, pb.ks, pb.dest_pool, lp.consts,
                        lp.tconsts, lp.bcost)
    stale_sets(m, pb.kp, pb.dest_pool, pb.lp, pb.lsl, sc.tb, sc.tpm, state,
               sc.ridx, sc.cidx, sc.lidx, sc.nstale,
               cfg.rescore_refresh_steps, checked=checked)
    grid = functools.partial(grid_rescore_carry, m, cfg, ca, pb.kp, pb.ks,
                             pb.dest_pool, packed, lp.R, sc.dt, sc.bd, state)
    lead = functools.partial(score_candidates, m, cfg, ca, lp.kind_l, pb.lp,
                             pb.lsl, lp.cd_l, lp.consts, lp.tconsts,
                             checked=checked, out=(sc.ls, None),
                             gate=state, bcost=lp.bcost)
    # the full rescore (:1056-1073)
    grid(1)
    lead(want=1)
    # the patch (:1096-1150): (a) before (b), which overwrites stale rows
    grid_patch(m, cfg, ca, pb.kp, pb.ks, pb.dest_pool, packed, sc.cidx, sc.tb,
               sc.dt, sc.bd, state, checked=checked)
    grid(0, rows=sc.ridx, n_rows=sc.nstale[0:1])
    lead(want=0, rows=sc.lidx, n_rows=sc.nstale[2:3])
    return packed["src_f"][:, SRC_TERM_COL]


#: the captured step chunk's name in the build and cost tables
#: (telemetry/device_stats.py, telemetry/device_cost.py)
SCAN_FN = "analyzer.scan_fn"
ROUND_FN = "analyzer.round_fn"


def _loop_nbytes(lp: "_StepLoop") -> int:
    """Bytes of the step loop's static buffers, each storage once."""
    seen, total = set(), 0
    stack = [v for k, v in vars(lp).items() if k != "chunk"]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return total


def _capture_chunk(lp: "_StepLoop") -> None:
    """The search's first step, eagerly (it checks every wrapper's inputs
    and loads every kernel), then the chunk's CUDA-graph capture — counted
    as a build of :data:`SCAN_FN` keyed by the loop's key, with its cost
    queued: the captured launches' work a replay, the loop's buffers, the
    allocator's growth across the capture."""
    dev = lp.out.device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated(dev)
    _step(lp, False)
    lp.chunk.capture()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    key = lp.key if lp.key is not None else (str(dev), id(lp))
    device_stats.MONITOR.record_compile(SCAN_FN, seconds, key)
    device_cost.MONITOR.note_compile(SCAN_FN, key, device_cost.work_source(
        lp.chunk.work, arg_bytes=_loop_nbytes(lp),
        output_bytes=lp.out.nbytes + lp.st.state.nbytes + lp.st.counts.nbytes,
        temp_bytes=max(0, torch.cuda.memory_allocated(dev) - mem0)))


def _scan_call(m: DeviceModel, cfg: CudaSearchConfig, ca, consts, K: int,
               D: int, T: int, tables, loop: Optional[_StepLoop] = None,
               chunk: Optional[int] = None, capture: Optional[bool] = None,
               t_cap: Optional[int] = None):
    """Up to T (repool → rescore → reduce → compact → cohort → auction →
    apply) steps on the device — the port of the reference's
    ``_cached_scan_fn`` body on its default single-device branch.

    The steps run in chunks of ``chunk`` (the loop's, or :data:`STEP_CHUNK`
    for a new loop), masked on the device (:func:`_step`);
    the host reads the device carry once a chunk.  On the card
    (``capture`` defaults to True there) the search's first call runs one
    step eagerly, records a chunk as a CUDA graph and replays it; on the
    CPU, or with ``capture=False``, the chunks run eagerly.  ``loop`` holds
    the search's static buffers (a fresh one is built when None).

    ``t_cap`` (1 ≤ t_cap ≤ T; ``None``: T) caps the call's steps — the
    reference's runtime step cap of the anytime deadline (:1400-1406): it
    rides the device carry, so capped and uncapped calls replay one
    captured chunk.

    Returns (ScanResult, updated model, (size, base, touched) row-table
    carry).  The loop ends on convergence (a step on freshly built pools
    commits nothing), after ``min(T, t_cap)`` steps, or when the next step
    could overflow the slot budget (the host just calls again)."""
    lp = loop if loop is not None else _StepLoop(
        m, cfg, ca, consts, K, D, T, chunk or STEP_CHUNK)
    if chunk is not None and lp.chunk.n != chunk:
        raise ValueError(f"step loop runs chunks of {lp.chunk.n}, not {chunk}")
    lp.load(m, tables, t_cap)
    if capture is None:
        capture = lp.out.device.type == "cuda"
    syncs = replays = captures = 0
    checked = False
    if capture and lp.chunk.graph is None:
        _capture_chunk(lp)
        captures = 1
    # an armed kernel capture starts its trace here, after any graph
    # capture (telemetry/kernel_budget.py); a no-op otherwise
    kernel_budget.CAPTURE.begin()
    while True:
        if capture:
            lp.chunk.replay()
            replays += 1
        else:
            lp.chunk.run_eager(checked)
            checked = True
        # the chunk's one host read
        state = mesh_budget.fetch(lp.st.state, fn="analyzer.scan_carry")
        syncs += 1
        if not state[SS.ACTIVE]:
            break
    device_cost.MONITOR.note_call(SCAN_FN, syncs)

    t_fetch = time.perf_counter()
    t, count = int(state[SS.STEP]), int(state[SS.COUNT])
    packed = mesh_budget.fetch(torch.cat([
        lp.out[:, :count].reshape(-1),
        lp.st.counts[:, :t].reshape(-1).to(torch.float32),
    ]), fn="analyzer.scan_fetch")
    syncs += 1
    body = packed[:4 * count].reshape(4, count).astype(np.int32)
    meta = packed[4 * count:].reshape(4, t).astype(np.int64)
    diag = {"steps_run": t, "n_incremental_repool": int(state[SS.N_INCR]),
            "repools": int(state[SS.N_REPOOL]), "host_syncs": syncs,
            "graph_replays": replays, "graph_captures": captures,
            # full rescores forced by a stale set over its budget, and the
            # steps that patched (incremental_rescore=True; else 0)
            "n_overflow": int(state[SS.N_OVF]),
            "patch_steps": int(state[SS.N_PATCH]),
            "fetch_s": time.perf_counter() - t_fetch}
    if cfg.step_diagnostics:
        diag.update(improving=meta[1], cohort=meta[2], auction=meta[3])
    res = ScanResult(body[0], body[1], body[2], body[3], meta[0],
                     bool(state[SS.DONE]), diag)
    pb = lp.pools
    m_out = dataclasses.replace(lp.m, **{
        f: getattr(lp.m, f).clone() for f in MUTABLE
        if getattr(lp.m, f) is not None})
    return res, m_out, (pb.size.clone(), pb.base.clone(), pb.tpp.clone())


def _hard_goals_hold(ctx: AnalyzerContext, goals) -> bool:
    """No replica is offline and every hard goal holds on the plan so far:
    the condition under which a time budget may end the search."""
    return (not ctx.replica_offline.any()
            and all(g.violations(ctx) == 0 for g in goals if g.is_hard))


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


@dataclasses.dataclass(frozen=True)
class CarriedBrokers:
    """What a :class:`replan.delta.ReplanCarry` keeps of its plan's model,
    in its ``model`` slot: host copies of the broker capacities and racks
    the carried row tables were built on.  The next warm start uploads its
    model in full and takes the tables only while these still hold."""

    capacity: np.ndarray
    rack: np.ndarray


def carry_nbytes(carry) -> int:
    """Bytes a :class:`replan.delta.ReplanCarry` holds on the device: its
    row tables."""
    return sum(t.numel() * t.element_size() for t in carry.tables or ())


# ---------------------------------------------------------------------------------
# The score-only round
# ---------------------------------------------------------------------------------

def _grid_round_scores(m: DeviceModel, cfg: CudaSearchConfig, ca, pools,
                       consts=None, tconsts=None):
    """The grid form's scores on ``pools`` → (vals f32 [K, R], ls f32 [L],
    best_i int32 [K, R]): each pool row's top-R raw grid scores and their
    pool indices (K2 + K1) and the leadership pool's scores (K6)."""
    kp, ks, dest_pool, lp, lsl = pools
    dev = m.assignment.device
    R = min(DESTS_PER_SOURCE, dest_pool.shape[0])
    bcost = torch.empty(m.capacity.shape[0], dtype=torch.float32,
                        device=dev)
    _, vals, best_i = grid_rescore(m, cfg, ca, kp, ks, dest_pool, R, consts,
                                   tconsts, bcost=bcost)
    L = lp.shape[0]
    ls, _ = score_candidates(
        m, cfg, ca,
        torch.full((L,), KIND_LEADERSHIP, dtype=torch.int32, device=dev),
        lp, lsl, torch.zeros(L, dtype=torch.int32, device=dev), consts,
        tconsts, bcost=bcost)
    return vals, ls, best_i


def _round_scores(m: DeviceModel, cfg: CudaSearchConfig, ca, K: int, D: int,
                  consts=None, tconsts=None):
    """The first half of a score-only round: the flat key it selects from
    → ``(key, layout, pools)``.

    A full repool (K10 + K11: the reference rebuilds the pools from
    scratch every round) gives ``pools`` = (kp, ks, dest_pool, lp, lsl).
    The grid form scores each pool row's top-R raw grid scores and the
    leadership pool (:func:`_grid_round_scores`), K·R + L flat, and K13 (a)
    negates them into the key; the columnar form's K14 scores the K·D + P·S
    flat candidates and stores the key itself.  ``layout`` is what K13 (b)
    decodes the selected indices with (:func:`_round_pick`)."""
    S = m.assignment.shape[1]
    pools = _build_pools(m, cfg, ca, K, D)
    kp, ks, dest_pool, lp, lsl = pools
    if _resolve_scoring(cfg) == "columnar":
        return (score_columnar(m, cfg, ca, kp, ks, dest_pool, consts,
                               tconsts), {"S": S}, pools)
    vals, ls, best_i = _grid_round_scores(m, cfg, ca, pools, consts, tconsts)
    return (round_keys(vals, ls), {"best_i": best_i, "lp": lp, "lsl": lsl},
            pools)


def _round_pick(key, layout, pools, topk: int) -> torch.Tensor:
    """The second half of a score-only round: K11 keeps the ``min(topk,
    N)`` largest of the flat ``key`` (``top_k``'s order) and K13 (b)
    decodes and packs them → f32 [5, k]."""
    sel = torch.empty(min(topk, key.shape[0]), dtype=torch.int32,
                      device=key.device)
    top_select(key, sel)
    kp, ks, dest_pool = pools[:3]
    return round_pack(key, sel, kp, ks, dest_pool, **layout)


def _round(m: DeviceModel, cfg: CudaSearchConfig, ca, K: int, D: int,
           consts=None, tconsts=None) -> torch.Tensor:
    """One score-only round → the packed f32 [5, k] (score, kind, p, s, d)
    of the ``k = min(topk_per_round, N)`` best candidates — the
    reference's ``_cached_round_fn(cfg, K, D, None)(m, ca)`` (plain twin:
    :func:`analyzer.round_kernels.round_plain`): :func:`_round_scores`
    then :func:`_round_pick`.  No host read."""
    return _round_pick(*_round_scores(m, cfg, ca, K, D, consts, tconsts),
                       cfg.topk_per_round)


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

    def _constraint_arrays(self, ctx: AnalyzerContext, can=None
                           ) -> Dict[str, torch.Tensor]:
        """The constraint arrays (``can``, else built from ``ctx``) on the
        device, charged to the transfer ledger as one upload."""
        if can is None:
            can = self._constraint_arrays_np(ctx)
        t0 = time.perf_counter()
        ca = {k: torch.as_tensor(v, device=self.device)
              for k, v in can.items()}
        mesh_budget.note_transfer(
            "h2d", "analyzer.constraints_upload",
            sum(int(v.nbytes) for v in can.values()),
            time.perf_counter() - t0)
        return ca

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

    def _warm_device_model(self, ctx: AnalyzerContext, warm_start, carry):
        """The search's device model (always the full upload,
        :meth:`_device_model`) and the row-table carry its first scan call
        starts from — the reference's ``_warm_device_model`` (:3120-3225)
        without its delta re-upload of the model, which lost to the full
        upload on the card at 1 000 / 20 000 (PERF.md §6, PR 17).  →
        ``(m, tab, warm)``: ``tab`` ``None`` means cold tables; ``warm`` the
        record for the pass summary (``None`` on a cold search).

        The carried tables ride along only when the warm start seeds the
        search at the carried placement bit for bit, on the same broker
        capacities and racks, with no capacity-estimate loads and no
        excluded partitions.  Every row whose table inputs may differ is
        marked for the first repool, which refreshes only those (K10's
        incremental form): the dirty rows, the rows touched after the
        tables were captured, and the rows with must-move flags then or
        now (their repair bonuses ride the tables)."""
        m = self._device_model(ctx)
        if warm_start is None:
            return m, None, None
        P = ctx.num_partitions
        dirty = warm_start.dirty_partitions
        kept = carry.model if carry is not None and carry.valid else None
        usable = (
            isinstance(kept, CarriedBrokers)
            and carry.tables is not None
            and carry.tables[0].shape[0] == P
            and carry.tables[0].device == m.assignment.device
            and np.array_equal(carry.assignment, ctx.assignment)
            and np.array_equal(carry.leader_slot, ctx.leader_slot)
            and np.array_equal(kept.capacity, ctx.broker_capacity)
            and np.array_equal(kept.rack, ctx.broker_rack)
            and not ctx.cap_distinct
            and m.leader_cload is None
            and not ctx.excluded_partition_mask().any()
        )
        warm = {"dirty_rows": P if dirty is None else int(np.count_nonzero(
            dirty)), "table_carry": usable, "marked_rows": None}
        if not usable:
            return m, None, warm
        tpp0 = np.ones(P, bool) if dirty is None else np.array(dirty, bool)
        if carry.pending_touched is not None:
            tpp0 |= carry.pending_touched
        if carry.had_must_move is not None:
            tpp0 |= carry.had_must_move
        tpp0 |= np.any(ctx.replica_offline, axis=1)
        warm["marked_rows"] = int(tpp0.sum())
        tab = (carry.tables[0], carry.tables[1],
               mesh_budget.device_put(tpp0, self.device,
                                      fn="analyzer.warm_marks"), True)
        return m, tab, warm

    def _export_carry(self, carry, ctx: AnalyzerContext, tab,
                      post_table_touched: np.ndarray) -> None:
        """Keep this plan's end state in ``carry`` for the next warm start
        (the reference's :3239-3258): host copies of the final placement
        and of the brokers the row tables were built on, and the row
        tables with the rows touched since their capture.  The tables are
        clones the carry alone owns (the scan call returns them cloned),
        so a search of the same shape, which overwrites the kept step
        loop's buffers, leaves them as they were."""
        carry.model = CarriedBrokers(ctx.broker_capacity.copy(),
                                     ctx.broker_rack.copy())
        carry.assignment = ctx.assignment.copy()
        carry.leader_slot = ctx.leader_slot.copy()
        carry.had_must_move = np.any(ctx.replica_offline, axis=1)
        if tab is not None and tab[3]:
            carry.tables = (tab[0], tab[1])
            # one host read of the touched set, outside any capture
            carry.pending_touched = (
                mesh_budget.fetch(tab[2], fn="analyzer.carry_fetch")
                .astype(bool) | post_table_touched)
        else:
            carry.tables = None
            carry.pending_touched = None
        carry.valid = True

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
        copied to the host for the exact recheck).  Holds
        :data:`~cruise_control_tpu_torch.utils.device.DEVICE_LOCK`
        throughout, the warm upload and the carry export included: one
        search at a time in the process, whichever thread and optimizer
        ask, so no other search runs between a carry's export and the next
        warm start's read of it.

        ``warm_start`` (a :class:`replan.delta.WarmStart`) seeds the search
        at a previous plan's final placement and enables the exact
        signature-based partial re-verification; ``carry`` (a
        :class:`replan.delta.ReplanCarry`) keeps the pool row tables on the
        card across plans, and the next warm start's first repool refreshes
        only their marked rows (:meth:`_warm_device_model`).

        An armed kernel capture (``telemetry/kernel_budget.py``) is claimed
        for this search's scan calls; ``profiler_trace_dir`` traces the
        whole search into that directory through the same entry point."""
        with DEVICE_LOCK, kernel_budget.CAPTURE.search_scope(
                legacy_trace_dir=self.config.profiler_trace_dir):
            return self._optimize(state, options, warm_start, carry)

    def _optimize(self, state: ClusterState,
                  options: Optional[OptimizationOptions], warm_start=None,
                  carry=None) -> OptimizerResult:
        from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
        from cruise_control_tpu_torch.analyzer.verifier import (
            partial_violations,
        )

        t0 = time.perf_counter()
        state = state.to("cpu")
        ctx = AnalyzerContext(state, options)
        initial_assignment = ctx.assignment.copy()
        initial_leader_slot = ctx.leader_slot.copy()
        initial_replica_disk = (
            ctx.replica_disk.copy() if ctx.replica_disk is not None else None
        )
        if warm_start is not None:
            ctx.reseed(warm_start.assignment, warm_start.leader_slot,
                       warm_start.replica_disk)
        goals = make_goals(constraint=self.constraint)
        if warm_start is not None:
            violations_before, _, reused_before = partial_violations(
                ctx, goals, warm_start.prev_signatures,
                warm_start.prev_violations,
                force_full=warm_start.full_verify,
            )
        else:
            violations_before = {g.name: g.violations(ctx) for g in goals}
            reused_before = []
        stats_before = stats_summary(cluster_stats(state))
        return self._search(
            state, ctx, goals, violations_before, stats_before,
            initial_assignment, initial_leader_slot,
            initial_replica_disk, t0, self.config, warm_start=warm_start,
            carry=carry, reused_before=reused_before,
        )

    def _search(
        self, state, ctx, goals, violations_before, stats_before,
        initial_assignment, initial_leader_slot, initial_replica_disk, t0,
        cfg, warm_start=None, carry=None, reused_before=(),
    ) -> OptimizerResult:
        t_up = time.perf_counter()
        m, tab, warm = self._warm_device_model(ctx, warm_start, carry)
        can = self._constraint_arrays_np(ctx)
        ca = self._constraint_arrays(ctx, can)
        P, S, B = ctx.num_partitions, ctx.max_rf, ctx.num_brokers
        K, D = self._pool_sizes(P, S, B)
        evaluator = _HostEvaluator(ctx, cfg, can)
        actions: List[BalancingAction] = []
        pass_summaries: List[dict] = []
        upload_s = time.perf_counter() - t_up

        def budget_left() -> Optional[float]:
            # the anytime budget (the reference's :3369-3380): the seconds
            # left (< 0: spent), or None while it may not cut the plan — no
            # budget, a hard goal failing or a replica offline; until then
            # the budget keeps extending.  Shared by both search phases so
            # their guarantees cannot drift apart.
            if not cfg.time_budget_s or not _hard_goals_hold(ctx, goals):
                return None
            return cfg.time_budget_s - (time.perf_counter() - t0)

        if cfg.steps_per_call and _resolve_scoring(cfg) != "columnar":
            # the device-resident search, then (``polish_rounds``) the
            # score-only rounds as polish on a model resynced from the host
            m, tab = self._resident_search(ctx, m, cfg, ca, K, D, evaluator,
                                           actions, pass_summaries, upload_s,
                                           budget_left, tab, warm)
            rounds_budget = cfg.polish_rounds
            timing = {"score": 0.0, "fetch": 0.0, "recheck": 0.0,
                      "resync": 0.0}
            if rounds_budget:
                t_rs = time.perf_counter()
                m = _resync_device_model(m, ctx)
                timing["resync"] += time.perf_counter() - t_rs
        else:
            # score-only configs (steps_per_call=0, scoring="columnar"):
            # the rounds are the search
            rounds_budget = cfg.max_rounds
            tab = None
            timing = {"upload": upload_s, "score": 0.0, "fetch": 0.0,
                      "recheck": 0.0, "resync": 0.0}
        #: actions committed past this index postdate the row tables the
        #: search ended with (polish, swap repair): the carry marks their rows
        n_actions_at_tables = len(actions)
        if rounds_budget:
            evaluator.goal_tag = ("CudaPolish" if pass_summaries
                                  else "CudaSearch")
            self._score_rounds(ctx, m, cfg, ca, K, D, evaluator, actions,
                               pass_summaries, rounds_budget, timing,
                               budget_left)

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
        if carry is not None:
            post = np.zeros(ctx.num_partitions, bool)
            for a in actions[n_actions_at_tables:]:
                post[a.partition] = True
                if a.action_type == ActionType.INTER_BROKER_REPLICA_SWAP:
                    post[a.swap_partition] = True
            self._export_carry(carry, ctx, tab, post)
        return self._finalize(
            state, ctx, goals, actions, violations_before, stats_before,
            initial_assignment, initial_leader_slot, initial_replica_disk,
            t0, pass_summaries, warm_start=warm_start,
            reused_before=reused_before,
        )

    def _resident_search(self, ctx, m, cfg, ca, K: int, D: int, evaluator,
                         actions, pass_summaries, upload_s: float,
                         budget_left, tab=None, warm=None):
        """The device-resident search: scan calls of up to
        ``steps_per_call`` steps on the card, each call's committed actions
        replayed through the exact host recheck; a rejection resyncs the
        device model from the host context.  ``tab`` is the row-table carry
        the first call starts from (``None``: cold tables); ``warm`` the
        warm upload's record (:meth:`_warm_device_model`), which the pass
        summary gains with the first call's repools.  Appends its pass
        summary and returns the device model and the row-table carry it
        ended with.

        With ``time_budget_s`` (the reference's :3515-3594): no call starts
        once ``budget_left()`` is spent, and while it is not None (the hard
        goals hold) each call is capped at the steps the remaining budget buys at the measured
        step rate — a first probe of ``min(steps_per_call, 256)``, then
        ``remaining / rate`` clipped to [1, steps_per_call] — the rate an
        EMA of the calls' seconds a step that skips the first capped call.
        The cap rides the device carry (:func:`_scan_call`)."""
        P, S, B = ctx.num_partitions, ctx.max_rf, ctx.num_brokers
        consts = grid_consts(cfg, ca, self.device)
        evaluator.goal_tag = "CudaSearch"
        cfg = _resolve_batch(cfg, B)
        T = cfg.steps_per_call
        # the bound preserves the score-only path's total action budget
        # counted in steps (evacuations commit one per step)
        calls_budget = max(
            cfg.max_rounds,
            -(cfg.max_rounds * cfg.max_moves_per_round) // -T,
        )
        n_calls = n_committed = n_rejected = n_steps = n_capped = 0
        #: measured seconds per executed step, per-call overheads included:
        #: the anytime deadline's rate model
        step_rate: Optional[float] = None
        device_loop = {"host_syncs": 0, "graph_replays": 0,
                       "graph_captures": 0, "repools": 0,
                       "n_incremental_repool": 0, "n_overflow": 0,
                       "patch_steps": 0}
        if tab is None:
            tab = _cold_tables(m)
        # the static buffers (and, on the card, the captured step chunk)
        # every call steps on: kept process-wide for the next search of the
        # same shape on the same card, by this optimizer or another.  The
        # budget is a host-loop knob: one loop serves every deadline
        # the budget is a host-loop knob and the trace directory a
        # telemetry one: neither keys the loop
        key = (str(m.assignment.device), P, S, B, K, D, T,
               dataclasses.replace(cfg, time_budget_s=0.0,
                                   profiler_trace_dir=""),
               m.pload.shape[1], STEP_CHUNK)
        loop = _take_loop(key) or _StepLoop(m, cfg, ca, consts, K, D, T,
                                            STEP_CHUNK)
        loop.key = key
        loop.bind(m, ca, consts)
        if warm is not None:
            # the first repool refreshes only the marked rows when the
            # tables ride along and the marks fit the loop's budget (K10
            # decides on the device; < 0: every repool rebuilds every row)
            warm = dict(warm, rows_budget=int(loop.rows_budget))
        # host wall-clock by phase: upload (model + aggregates), device
        # (the step loop, whose carry read a chunk waits for the card),
        # fetch (the packed prefix), recheck (exact f64 replay), resync
        timing = {"upload": upload_s, "device": 0.0, "fetch": 0.0,
                  "recheck": 0.0, "resync": 0.0}
        while n_calls < calls_budget:
            left = budget_left()
            if left is not None and left < 0:
                LOG.info("anytime budget (%.1fs) exhausted after %d calls",
                         cfg.time_budget_s, n_calls)
                break
            t_cap = None
            if left is not None:
                # the per-step deadline: the remaining budget as a step cap
                # at the measured rate; the first capped call is a short
                # probe.  Until the hard goals hold the budget never cuts
                t_cap = (int(np.clip(left / step_rate, 1, T))
                         if step_rate else min(T, 256))
            t_call = time.perf_counter()
            # an armed kernel capture's traced window (a no-op disarmed)
            with kernel_budget.CAPTURE.scan_call():
                res, m_new, tab_new = _scan_call(m, cfg, ca, consts, K, D, T,
                                                 tab, loop, t_cap=t_cap)
            for k in device_loop:
                device_loop[k] += res.diag[k]
            timing["fetch"] += res.diag["fetch_s"]
            timing["device"] += (time.perf_counter() - t_call
                                 - res.diag["fetch_s"])
            n_calls += 1
            n_steps += int(res.diag["steps_run"])
            if warm is not None and n_calls == 1:
                warm.update(first_call_repools=res.diag["repools"],
                            first_call_incremental=res.diag[
                                "n_incremental_repool"])
            if t_cap is not None:
                n_capped += 1
            if cfg.time_budget_s and res.diag["steps_run"] > 0 and not (
                    t_cap is not None and n_capped == 1):
                # the first capped call's sample is skipped: it follows the
                # switch to capped calls and would fold that one-off cost
                # into the rate, over-truncating the next cap
                rate = (time.perf_counter() - t_call) / res.diag["steps_run"]
                step_rate = rate if step_rate is None else (
                    0.5 * step_rate + 0.5 * rate)
            if res.diag["n_overflow"]:
                LOG.debug("device call %d: %d staleness-overflow full "
                          "rescores", n_calls, res.diag["n_overflow"])
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
        # a search that raised keeps no loop: its buffers (or capture) may
        # be half-written
        _keep_loop(key, loop)
        LOG.info(
            "resident search: %d device calls, %d steps, %d actions "
            "committed, %d rejected", n_calls, n_steps, n_committed,
            n_rejected,
        )
        pass_summaries.append({
            "goal": "CudaSearch", "pass": len(pass_summaries),
            "accepted": int(n_committed),
            "rejected": (
                {"no-improvement": int(n_rejected)} if n_rejected else {}
            ),
            "rounds": int(n_calls),
            "steps": int(n_steps),
            "capped_calls": int(n_capped),
            "timing_s": timing,
            # device-to-host reads of the step loop (carry reads and
            # fetches), captured-chunk replays, repools run, and the
            # incremental rescore's overflows and patch steps
            **device_loop,
            **({} if warm is None else {"warm": warm}),
        })
        return m, tab

    def _score_rounds(self, ctx, m, cfg, ca, K: int, D: int, evaluator,
                      actions, pass_summaries, rounds_budget: int,
                      timing, budget_left) -> None:
        """The score-only loop (the reference's :3694-3753), at most
        ``rounds_budget`` rounds: each round (:func:`_round`) proposes its
        top-k against a snapshot of the aggregates, fetched in one read;
        the host walks them best first (a stable argsort), rechecks each
        against the live aggregates in f64 (:meth:`_HostEvaluator
        .evaluate`) and applies every one that still improves, up to
        ``max_moves_per_round``; then the device model is resynced from
        the host (K9).  A round that applies nothing ends the loop, and
        no round starts once ``budget_left()`` is spent (:3703); a loop that
        runs no round appends no summary.
        ``timing`` (host seconds by phase: score — the round's kernels and
        the wait for them —, fetch, recheck, resync) is added to and goes
        into the pass summary, tagged ``evaluator.goal_tag``."""
        dev = self.device
        consts = grid_consts(cfg, ca, dev)
        tconsts = terms_consts(cfg, ca, dev)
        cost = device_cost.MONITOR
        accepted = rejected = rounds = 0
        for round_idx in range(rounds_budget):
            left = budget_left()
            if left is not None and left < 0:
                break
            evaluator.round_index = round_idx
            rounds += 1
            t_sc = time.perf_counter()
            # the round's cost, once a shape (telemetry/device_cost.py)
            sig = (str(dev), K, D, tuple(m.assignment.shape),
                   _resolve_scoring(cfg))
            fresh = cost.enabled and not cost.known(ROUND_FN, sig)
            with (kernels.WORK.recording() if fresh
                  else contextlib.nullcontext({})) as work:
                packed = _round(m, cfg, ca, K, D, consts, tconsts)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            cost.note_call(ROUND_FN)
            if fresh:
                cost.note_compile(ROUND_FN, sig, device_cost.work_source(
                    work, output_bytes=packed.nbytes))
            t_f = time.perf_counter()
            scores, k_top, p_top, s_top, d_top = unpack_round_result(
                mesh_budget.fetch(packed, fn="analyzer.round_fetch"))
            t_re = time.perf_counter()
            timing["score"] += t_f - t_sc
            timing["fetch"] += t_re - t_f
            # exact-recheck commit: hundreds of dependent actions a round,
            # each checked against the live aggregates, never stale
            batch = 0
            for i in np.argsort(scores, kind="stable"):
                if (scores[i] >= cfg.improvement_tol
                        or not np.isfinite(scores[i])):
                    break
                action, delta = evaluator.evaluate(
                    int(k_top[i]), int(p_top[i]), int(s_top[i]),
                    int(d_top[i]))
                if action is None or delta >= cfg.improvement_tol:
                    rejected += 1
                    continue
                ctx.apply(action)
                actions.append(action)
                batch += 1
                if batch >= cfg.max_moves_per_round:
                    break
            timing["recheck"] += time.perf_counter() - t_re
            accepted += batch
            if not batch:
                break
            t_rs = time.perf_counter()
            m = _resync_device_model(m, ctx)
            timing["resync"] += time.perf_counter() - t_rs
        if not rounds:
            return
        LOG.info("score-only rounds (%s): %d rounds, %d actions committed, "
                 "%d rejected", evaluator.goal_tag, rounds, accepted,
                 rejected)
        pass_summaries.append({
            "goal": evaluator.goal_tag, "pass": len(pass_summaries),
            "accepted": int(accepted),
            "rejected": (
                {"no-improvement": int(rejected)} if rejected else {}
            ),
            "rounds": int(rounds),
            "timing_s": timing,
        })

    def _finalize(
        self, state, ctx, goals, actions, violations_before, stats_before,
        initial_assignment, initial_leader_slot, initial_replica_disk, t0,
        pass_summaries: Optional[List[dict]] = None, warm_start=None,
        reused_before=(),
    ) -> OptimizerResult:
        replan_verify = None
        if warm_start is not None:
            # the partial re-verification: a goal whose inputs are
            # bit-identical to the previously verified final state reuses
            # that verdict exactly; replan.full.verify forces the full pass
            from cruise_control_tpu_torch.analyzer.verifier import (
                partial_violations,
            )

            violations_after, sigs_after, reused_after = partial_violations(
                ctx, goals, warm_start.prev_signatures,
                warm_start.prev_violations,
                force_full=warm_start.full_verify,
            )
            replan_verify = {
                "signatures": sigs_after,
                "reusedBefore": list(reused_before),
                "reusedAfter": list(reused_after),
                "fullVerify": bool(warm_start.full_verify),
            }
        else:
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

        result = OptimizerResult(
            proposals=diff_proposals(
                initial_assignment, initial_leader_slot, ctx,
                initial_replica_disk,
            ),
            actions=(list(warm_start.prev_actions) + actions
                     if warm_start is not None else actions),
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
        if replan_verify is not None:
            result.replan_verify = replan_verify
        return result

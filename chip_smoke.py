"""Drive the PyTorch port's rebalance-plan search on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. environment: the card (``nvidia-smi``), CUDA, the TF32 settings;
2. build: every hand-written kernel compiled from ``csrc/`` (set-up time),
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the search's first step hands it — at the main path's
   mid-scale shapes, with percentile capacity loads on, and on a ragged
   case — with its wrapper time, its device time, the plain version's
   time and the card's bound for the same work; then the candidate scorer
   on moves and transfers mixed, the compaction on 50 000 tie-rich keys
   and the aggregate rebuild at 3 M replica slots;
4. plan at 50 brokers / 1 000 partitions: verified, no worse than the
   port's greedy oracle, twice with identical action lists;
5. plan at 1 000 brokers / 20 000 partitions at the engine's default
   widths — the main path: verified, under the quality bar, with every
   kernel's launch count from this run (each must be > 0).

The last two lines are the ``{"kernels": [...]}`` summary and the
``{"ok": true, "device": ...}`` verdict.  Nothing here imports JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

#: the greedy oracle's violation score on the 1 000-broker / 20 000-partition
#: fixture (seed 12, 20 racks, mean utilization 0.35), from the repo's
#: PARITY_GATE_MIDSCALE.json ("greedy": {"violation_score": 1595}); the JAX
#: engine reached 1 035 there on the CPU backend
MIDSCALE_SCORE_BAR = 1595
MIDSCALE = dict(seed=12, num_brokers=1000, num_racks=20,
                num_partitions=20000, mean_utilization=0.35)
SMALL = dict(num_brokers=50, num_racks=10, num_partitions=1000)
#: kernel-vs-plain tolerance on finite scores: both paths run the same f32
#: operations in the same order (the kernel is built without FMA
#: contraction), so they should agree to the bit; the bound leaves room
#: for the scores' 1e6 / 1e4 repair bonuses
RTOL, ATOL = 1e-5, 1e-4
#: published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
#: cores, HBM bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

_REF = "cruise_control_tpu/analyzer/tpu_optimizer.py"
#: every hand-written kernel (``cruise_control_tpu_torch/csrc/<name>.cu``)
#: → the reference code it replaces: phase 2 builds these, phase 3 checks
#: each, phases 4-5 count each, and the kernels line lists each
KERNELS = {
    "grid_top_r": "cruise_control_tpu/ops/grid.py:140 move_grid_scores + "
                  f"{_REF}:2194 _grid_top_r",
    "grid_terms": "cruise_control_tpu/ops/grid.py:54 move_grid_terms "
                  "(+ :39 gather_pload, ops/cost.py broker_cost)",
    "per_src_top": f"{_REF}:2357 _reduce_leadership_per_src + "
                   f"{_REF}:2381 _topq_rows_per_src",
    "budget_accept": f"{_REF}:2411 _step_budgets + {_REF}:2503 "
                     f"_seg_excl_prefix + {_REF}:2630 _seg_prefix_fits + "
                     f"{_REF}:2653 _budget_accept",
    "match_batch": f"{_REF}:2684 _match_batch + {_REF}:1322-1334 the "
                   "cohort's footprint",
    "score_candidates": f"{_REF}:513 _score_candidates",
    "compact_rows": f"{_REF}:1202-1309 step compaction (sort_key_val "
                    ":1206, gathers, move_vec, order_pc :1293, fminp :1305)",
    "commit_batch": f"{_REF}:1335-1391 commit order (sort_key_val :1342), "
                    f"output and tpp + {_REF}:751 _apply_batch_on_device",
    "recompute_aggregates": f"{_REF}:444 _recompute_aggregates",
}
#: why no single PyTorch call computes each kernel's function
LIBRARY_NOTES = {
    "grid_top_r": "no single PyTorch call computes a masked grid score "
                  "with a per-row top-R",
    "grid_terms": "a chain of gathers and the fused cost: no single "
                  "PyTorch call",
    "per_src_top": "scatter_reduce(amin) gives a per-broker minimum but "
                   "not its lowest row, nor Q dependent passes",
    "budget_accept": "segmented prefix sums with a budget test in two "
                     "dependent rounds: no single PyTorch call",
    "match_batch": "an iterative auction: no single PyTorch call",
    "score_candidates": "a chain of gathers and four fused costs: no "
                        "single PyTorch call",
    "compact_rows": "torch.sort ranks the keys, but not the gathers, "
                    "budget vectors and partition filter that follow",
    "commit_batch": "a sort, an output write and exact segment sums: no "
                    "single PyTorch call",
    "recompute_aggregates": "index_add_ over the slots' load rows "
                            "(library_ms) sums one of the six aggregates "
                            "with float atomics, not exactly",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_ms(fn, tag: str, reps: int = 10):
    """Milliseconds of device time a call of ``fn`` spends in kernels whose
    name holds ``tag``, from ``torch.profiler`` over ``reps`` calls; None
    if the profiler shows no such kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and tag in e.name]
    return sum(us) * 1e-3 / reps if us else None


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def grid_inputs(state, cfg_kw, dev):
    """The engine's first-step K1 inputs for ``state``: model, constraints,
    pools and source terms, exactly as the search builds them."""
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        DESTS_PER_SOURCE,
        CudaGoalOptimizer,
        CudaSearchConfig,
        _build_pools,
    )
    from cruise_control_tpu_torch.ops.grid import grid_consts, move_grid_terms

    opt = CudaGoalOptimizer(config=CudaSearchConfig(**cfg_kw), device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    kp, ks, dest_pool, _, _ = _build_pools(m, opt.config, ca, K, D)
    terms = move_grid_terms(m, opt.config, ca, kp, ks)
    R = min(DESTS_PER_SOURCE, D)
    consts = grid_consts(opt.config, ca, dev)
    return (m, opt.config, ca, kp, ks, dest_pool, terms, R), consts


def check_grid_top_r(label, args, consts):
    """K1, on the tables K2 packs for it as the search does, against its
    plain twin on the same inputs; returns the record."""
    from cruise_control_tpu_torch.ops import grid as G

    m, cfg, ca, kp, ks, dest_pool, terms, R = args
    packed = G.grid_terms(m, cfg, ca, kp, ks, dest_pool, consts)
    ks_, ki = G.launch_grid_top_r(packed, R)
    torch.cuda.synchronize()
    ps, pi = G.grid_top_r_plain(*args)
    g = G.move_grid_scores(m, cfg, ca, kp, ks, dest_pool, terms=terms)
    ks_, ki, ps, pi = (x.cpu() for x in (ks_, ki, ps, pi))
    inf_k, inf_p = torch.isinf(ks_), torch.isinf(ps)
    if not torch.equal(inf_k, inf_p):
        raise AssertionError(f"{label}: +inf masks differ "
                             f"({int((inf_k != inf_p).sum())} entries)")
    fin = ~inf_p
    err = float((ks_[fin] - ps[fin]).abs().max()) if fin.any() else 0.0
    if not torch.allclose(ks_[fin], ps[fin], rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{label}: finite scores differ, max abs {err}")
    # tie-free rows: the plain scores of ranks 0..R (R+1 entries) are
    # pairwise separated by more than the tolerance
    srt = torch.sort(g, dim=1, stable=True).values[:, : R + 1].cpu()
    gaps = srt[:, 1:] - srt[:, :-1]
    # (+inf entries order by index on both paths, so they never tie)
    tie_free = ((gaps > ATOL + RTOL * srt[:, 1:].abs())
                | torch.isinf(srt[:, 1:])).all(dim=1)
    idx_eq = (ki == pi).all(dim=1)
    if not bool(idx_eq[tie_free].all()):
        raise AssertionError(
            f"{label}: indices differ on {int((~idx_eq & tie_free).sum())} "
            "tie-free rows")
    K, D = kp.shape[0], dest_pool.shape[0]
    S = m.assignment.shape[1]
    n_feasible = int(torch.isfinite(g).sum())
    ms = cuda_ms(lambda: G.launch_grid_top_r(packed, R))
    dev_ms = (device_ms(lambda: G.launch_grid_top_r(packed, R),
                        "grid_top_r_kernel") if label == "midscale" else None)
    plain_ms = cuda_ms(lambda: G.grid_top_r_plain(*args), reps=20)
    # least time for the same work: inputs read once, outputs written once;
    # operations counted from the kernel source (ops/grid.py)
    nbytes = (K * (G._SF + 3 * S + 2) + D * (G._DF + G._DI) + G._NC) * 4 \
        + K * R * 8
    ops = G.grid_top_r_ops(K * D, n_feasible, S)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    rec = {
        "phase": "kernel", "case": label, "name": "grid_top_r",
        "K": K, "D": D, "S": S, "R": R, "feasible_cells": n_feasible,
        "max_abs_err": err, "rows_identical": int(idx_eq.sum()),
        "tie_free_rows": int(tie_free.sum()),
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "bytes": nbytes, "operations": ops,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a masked grid "
                        "score with a per-row top-R",
    }
    emit(rec)
    return rec


def counters():
    """Each kernel's counted wrapper (``.launches``)."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK
    from cruise_control_tpu_torch.ops import grid as G

    from cruise_control_tpu_torch.analyzer import commit_kernels as K89
    from cruise_control_tpu_torch.analyzer import compact_kernel as K7
    from cruise_control_tpu_torch.analyzer import score_kernel as K6

    return {"grid_top_r": G.launch_grid_top_r, "grid_terms": G.grid_terms,
            "per_src_top": SK.per_src_top,
            "budget_accept": SK.budget_accept,
            "match_batch": SK.match_batch,
            "score_candidates": K6.score_candidates,
            "compact_rows": K7.compact_rows,
            "commit_batch": K89.commit_batch,
            "recompute_aggregates": K89.recompute_aggregates}


def with_percentile(state, seed: int = 3):
    """``state`` with seeded per-window loads and a 90th-percentile
    capacity estimate, so the search runs with capacity loads apart from
    the mean loads (the ``has_cap`` branches of K2 and K4)."""
    g = torch.Generator().manual_seed(seed)
    P, R = state.leader_load.shape
    f = lambda x: (x[:, None, :] * (0.7 + 0.8 * torch.rand(  # noqa: E731
        (P, 6, R), generator=g))).to(torch.float32)
    return dataclasses.replace(
        state, leader_load_windows=f(state.leader_load.cpu()),
        follower_load_windows=f(state.follower_load.cpu()),
        capacity_percentile=90.0)


def first_step_calls(state, cfg_kw, dev):
    """The arguments the search's first step hands each wrapper of K2-K8,
    recorded (copied: K8 updates the model in place) from one step of the
    engine's own step loop; and the uploaded model K9 rebuilt."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.ops.grid import grid_consts

    opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(**cfg_kw), device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    names = ("grid_rescore", "score_candidates", "per_src_top",
             "compact_rows", "budget_accept", "match_batch", "commit_batch")
    saved = {n: getattr(C, n) for n in names}
    calls = {"recompute_aggregates": ((m,), {})}

    def shim(n):
        def f(*a, **k):
            if n not in calls:
                calls[n] = copy.deepcopy((a, k))
            return saved[n](*a, **k)
        return f

    try:
        for n in names:
            setattr(C, n, shim(n))
        cfg = C._resolve_batch(opt.config, ctx.num_brokers)
        C._scan_call(m, cfg, ca, grid_consts(cfg, ca, dev), K, D, 1,
                     C._cold_tables(m))
    finally:
        for n in names:
            setattr(C, n, saved[n])
    return calls, m.broker_cload is not None


def compare(label, got, want) -> float:
    """Integer and boolean outputs must be equal, +inf masks equal and
    finite floats within RTOL/ATOL; → the largest finite abs error."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.cpu(), b.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label}[{i}]: {a.dtype} {tuple(a.shape)} "
                                 f"vs plain {b.dtype} {tuple(b.shape)}")
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{label}[{i}]: {int((a != b).sum())} "
                                     "entries differ")
            continue
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise AssertionError(f"{label}[{i}]: +inf masks differ")
        fin = torch.isfinite(b)
        if fin.any():
            err = max(err, float((a[fin] - b[fin]).abs().max()))
            if not torch.allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{label}[{i}]: finite values differ, "
                                     f"max abs {err}")
    return err


def bound(nbytes: float, ops: float) -> dict:
    """Least time for the work: bytes at HBM rate vs f32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def record_kernel(label, name, fn, plain, args, kw, extra, nbytes, ops,
                  plain_kw=None, timed=False):
    """Run kernel wrapper ``fn`` and its plain twin ``plain`` on copies of
    the same inputs (K8 updates its inputs in place), compare their
    outputs, time both and bound the work → the emitted record.  With
    ``timed`` the record also has the kernel's device time alone."""
    plain_kw = kw if plain_kw is None else plain_kw
    got = fn(*copy.deepcopy(args), **kw)
    torch.cuda.synchronize()
    want = plain(*copy.deepcopy(args), **plain_kw)
    err = compare(f"{label} {name}", got, want)
    targs, pargs = copy.deepcopy(args), copy.deepcopy(args)
    kernel = name.split("[")[0]
    # timed as the step calls it after its first step: inputs checked once
    tkw = dict(kw, checked=True) if "checked" in kw else kw
    rec = {"phase": "kernel", "case": label, "name": name,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: fn(*targs, **tkw)),
           "device_ms": (device_ms(lambda: fn(*targs, **tkw),
                                   f"{kernel}_kernel") if timed else None),
           "plain_ms": cuda_ms(lambda: plain(*pargs, **plain_kw), reps=15),
           **bound(nbytes, ops), "library_ms": None,
           "library_note": LIBRARY_NOTES[kernel], **extra}
    emit(rec)
    return rec


def _model_fields(m):
    """The tensors of a DeviceModel, in field order (None skipped)."""
    return [getattr(m, f.name) for f in dataclasses.fields(m)
            if getattr(m, f.name) is not None]


def check_step_kernels(label, state, cfg_kw, dev):
    """K2-K9 against their plain twins on the first step's inputs →
    {name: record}.  K5 runs three times: as the step calls it (from the
    cohort's accepted rows), with destination and source caps of 2 (its
    ``track_bars`` branch), and in its older form from the three occupancy
    tables the cohort's footprint gives."""
    from cruise_control_tpu_torch.analyzer import commit_kernels as K89
    from cruise_control_tpu_torch.analyzer import compact_kernel as K7
    from cruise_control_tpu_torch.analyzer import score_kernel as K6
    from cruise_control_tpu_torch.analyzer import step_kernels as SK
    from cruise_control_tpu_torch.ops import grid as G

    calls, has_cap = first_step_calls(state, cfg_kw, dev)
    timed = label == "midscale"
    recs = {}

    def record(name, fn, plain, args, kw, extra, nbytes, ops,
               plain_kw=None):
        recs[name] = record_kernel(
            label, name, fn, plain, args, kw,
            {"percentile_cload": has_cap, **extra}, nbytes, ops,
            plain_kw=plain_kw, timed=timed and "[" not in name)

    # K2: the packed tables K1 reads
    (m, cfg, ca, kp, ks, dp, R, consts, tconsts), _ = calls["grid_rescore"]
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    K, D = kp.shape[0], dp.shape[0]
    W = m.pload.shape[1]
    NR = m.capacity.shape[1]
    n_part = int(torch.unique(kp).numel())
    #: bytes of one broker's tables: capacity, load (and capacity load),
    #: four f32 aggregates, rack, two flags
    broker_b = 4 * (NR * (3 if has_cap else 2) + 4) + 6
    keys = ("src_f", "src_i", "dst_f", "dst_i")
    tables = lambda packed: [packed[k] for k in keys]  # noqa: E731
    record("grid_terms",
           lambda *a: tables(G.grid_terms(*a)),
           lambda *a: tables(G.grid_terms_plain(*a[:7])),
           (m, cfg, ca, kp, ks, dp, consts, tconsts), {},
           {"K": K, "D": D, "S": S, "distinct_partitions": n_part},
           # each input once: kp, ks and the pool; each distinct partition
           # row (slots, origins, must-move, leader slot, load row); the
           # broker tables; the constants; the four packed tables out
           K * 8 + D * 4 + n_part * (9 * S + 4 + 4 * W) + B * broker_b
           + 4 * (G._NC + G._NT)
           + K * 4 * (G._SF + 3 * S + 2) + D * 4 * (G._DF + G._DI),
           # two broker costs (~85 operations each) and ~20 more a source;
           # one cost and ~20 more a destination (csrc/grid_terms.cu)
           K * 190 + D * 105)
    # K6 on the leadership pool, as the step calls it
    args, kw = calls["score_candidates"]
    recs.update(check_score_candidates(label, args, kw, has_cap, timed))
    # K3
    args, kw = calls["per_src_top"]
    _, lp, _, _, sb, _, _, Q = args
    L = lp.shape[0]
    flat = lambda out: [x for t in out for x in t]  # noqa: E731
    record("per_src_top", lambda *a: flat(SK.per_src_top(*a)),
           lambda *a: flat(SK.per_src_top_plain(*a)),
           args, kw, {"L": L, "K": sb.shape[0], "B": B, "Q": Q},
           # each input once: the L candidates (lp, lsl, score, two
           # assignment words), the K rows' source broker and best score;
           # the best transfer per broker and the Q rows and scores out
           L * 20 + sb.shape[0] * 8 + B * 16 + Q * B * 8,
           L * 2 + Q * sb.shape[0] * 2)
    # K7
    args, kw = calls["compact_rows"]
    recs.update(check_compact_rows(label, args, kw, has_cap, timed))
    # K4
    args, kw = calls["budget_accept"]
    Cn, NB = args[4].shape
    record("budget_accept", SK.budget_accept, SK.budget_accept_plain,
           args, kw, {"C": Cn, "B": B, "NB": NB},
           B * (4 * 4 * (3 if has_cap else 2) + 10) + Cn * (13 + 4 * NB)
           + Cn + 2 * B * NB * 4,
           B * (12 * 3 + 40) + 2 * (2 * 4 + 3) * Cn * NB)
    # K5 from the cohort's rows (as the step calls it), on the track_bars
    # branch, and from the footprint's occupancy tables
    args, kw = calls["match_batch"]
    N, A = args[0].shape
    acc = kw["acc"]
    used = SK._cohort_footprint(acc, args[1], args[2], args[3], B, args[6])
    masked = (args[0].masked_fill(acc[:, None], float("inf")),) + args[1:]
    for name, a5, kw5 in (
            ("match_batch", args, kw),
            ("match_batch[track_bars]", args,
             dict(kw, dest_cap=2, src_cap=2)),
            ("match_batch[init_used]", masked,
             dict(kw, acc=None, init_used=used))):
        record(name, SK.match_batch, SK.match_batch_plain, a5, kw5,
               {"N": N, "A": A, "B": B, "cohort_rows": int(acc.sum())},
               # the alternates, ids and cohort flags (or the three
               # occupancy tables) in; take, score, destination out
               N * A * 8 + N * 17 + 2 * B + args[6] + N * 13,
               (kw5.get("rounds") or A) * N * 20)
    # K8
    args, kw = calls["commit_batch"]
    recs.update(check_commit_batch(label, args, kw, has_cap, timed))
    # K9 on the uploaded model
    (m0,), _ = calls["recompute_aggregates"]
    recs["recompute_aggregates"] = check_recompute_aggregates(
        label, m0, has_cap, timed)
    return recs


def check_score_candidates(label, args, kw, has_cap, timed,
                           name="score_candidates"):
    """K6 against ``_score_candidates`` → {name: record}."""
    from cruise_control_tpu_torch.analyzer import score_kernel as K6

    m, _, _, kind, cp, cs, cd = args[:7]
    S = m.assignment.shape[1]
    N = cp.shape[0]
    W = m.pload.shape[1]
    NR = m.capacity.shape[1]
    row = m.assignment[cp.long()]
    brokers = torch.cat([row.reshape(-1), cd]).clamp_min(0)
    n_part = int(torch.unique(cp).numel())
    n_brk = int(torch.unique(brokers).numel())
    rec = record_kernel(
        label, name, K6.score_candidates,
        lambda *a, **k: K6._score_candidates(*a[:7]), args, kw,
        {"percentile_cload": has_cap, "N": N,
         "moves": int((kind == 0).sum()), "distinct_partitions": n_part,
         "distinct_brokers": n_brk},
        # each input once: the four ids a candidate; each distinct
        # partition's row (slots, origins, must-move, leader slot, load
        # row); each broker read (tables as K2's); the constants; delta and
        # the feasible flag out
        N * 16 + n_part * (9 * S + 4 + 4 * W)
        + n_brk * (4 * (NR * (3 if has_cap else 2) + 4) + 6)
        + 4 * (3 * NR + 16) + N * 5,
        # four broker costs (~85 operations each) and ~60 more a candidate
        N * 400, plain_kw={}, timed=timed)
    return {name: rec}


def check_compact_rows(label, args, kw, has_cap, timed, name="compact_rows"):
    """K7 against ``_compact_rows`` → {name: record}."""
    from cruise_control_tpu_torch.analyzer import compact_kernel as K7

    (m, q_scores, q_rows, bl, src_term, vals, best_d, dest_pool, kp, ks, sb,
     C, tol) = args
    Q, B = q_rows.shape
    K, R = vals.shape
    W = m.pload.shape[1]
    nrow = (Q + 1) * B
    out = K7._compact_rows(*args)
    NB = out.move_vec.shape[1]
    n_part = int(torch.unique(out.cand_p).numel())
    log_c = max(C - 1, 1).bit_length()
    return {name: record_kernel(
        label, name, K7.compact_rows, K7._compact_rows, args, kw,
        {"percentile_cload": has_cap, "NROW": nrow, "C": C, "R": R,
         "distinct_partitions": n_part},
        # each input once: the NROW scores; a kept row's q row index,
        # R scores and pool indices, source term, kp / ks / sb and its
        # leadership entry; R pool entries a kept move row at most; each
        # distinct partition's leader slot and load row; the outputs
        nrow * 4 + C * (4 + 8 * R + 4 + 12 + 16 + 4 * R)
        + n_part * (4 + 4 * W)
        + C * (1 + 8 * R + 8 + 8 + 4 * NB + 1 + 8 + 1 + 4),
        # four histogram passes and the gather over NROW keys, two bitonic
        # sorts of C keys, ~(8R + 2NB + 30) operations a kept row
        5 * nrow * 3 + 2 * C * log_c * (log_c + 1) // 2
        + C * (8 * R + 2 * NB + 30),
        plain_kw={}, timed=timed)}


def check_commit_batch(label, args, kw, has_cap, timed):
    """K8 against ``commit_batch_plain`` → {name: record}: the returned
    model, touched marks and count, and the output rows written."""
    from cruise_control_tpu_torch.analyzer import commit_kernels as K89

    def outs(fn):
        def run(*a, **k):
            m, tpp, c_step = fn(*a, **k)
            return [*_model_fields(m), tpp, c_step, a[12]]
        return run

    m = args[0]
    C, R = args[5].shape
    M_step = args[11]
    B, NR = m.capacity.shape
    W = m.pload.shape[1]
    ncol = NR * (2 if has_cap else 1) + 4
    n_commit = int(K89.commit_batch_plain(*copy.deepcopy(args))[2])
    log_c = max(C - 1, 1).bit_length()
    return {"commit_batch": record_kernel(
        label, "commit_batch", outs(K89.commit_batch),
        outs(K89.commit_batch_plain), args, kw,
        {"percentile_cload": has_cap, "C": C, "M_step": M_step,
         "commits": n_commit},
        # each input once: ~39 B a candidate row and its partition's leader
        # slot and load row; the broker aggregates read and written; a
        # commit's placement entries, output row and touched mark
        C * (39 + 4 + 4 * W) + 2 * B * ncol * 4 + n_commit * (4 + 1 + 16 + 1),
        # the sort of C keys; a commit's ~12 operations a column; the
        # aggregate update
        C * log_c * (log_c + 1) // 2 + n_commit * 12 * ncol + 2 * B * ncol,
        plain_kw={}, timed=timed)}


def check_recompute_aggregates(label, m, has_cap, timed):
    """K9 against ``_recompute_aggregates`` → the record, with index_add_
    over the slots' load rows timed beside it."""
    from cruise_control_tpu_torch.analyzer import commit_kernels as K89

    P, S = m.assignment.shape
    B, NR = m.capacity.shape
    cols = ("broker_load", "leader_nwin", "pot_nwout", "rcount", "lcount",
            "broker_cload")

    def outs(fn):
        def run(mm):
            r = fn(mm)
            return [getattr(r, f) for f in cols if getattr(r, f) is not None]
        return run

    rec = record_kernel(
        label, "recompute_aggregates", outs(K89.recompute_aggregates),
        outs(K89._recompute_aggregates), (m,), {},
        {"percentile_cload": has_cap, "P": P, "S": S, "B": B},
        # each input once: the placement and leader slots, the leader and
        # follower load rows (and capacity loads); six aggregates out
        P * S * 4 + P * 4 + P * NR * 4 * (4 if has_cap else 2)
        + B * (NR * (2 if has_cap else 1) + 4) * 4,
        # per slot: a column max and a fixed-point product and add a column
        P * S * (NR * (2 if has_cap else 1) + 2) * 3, timed=timed)
    # yardstick: one index_add_ of the slots' load rows (float atomics)
    ids = torch.where(m.assignment >= 0, m.assignment, B).reshape(-1).long()
    rows = torch.where(
        (torch.arange(S, device=m.assignment.device)[None, :]
         == m.leader_slot[:, None])[:, :, None],
        m.leader_load[:, None, :], m.follower_load[:, None, :]
    ).reshape(-1, NR).contiguous()
    rec["library_ms"] = cuda_ms(lambda: torch.zeros(
        (B + 1, NR), device=rows.device).index_add_(0, ids, rows))
    emit({"phase": "kernel_library", "case": label,
          "name": "recompute_aggregates", "library_ms": rec["library_ms"]})
    return rec


def mixed_candidates(calls):
    """Moves and transfers built from the first step's model: every move
    row of the grid's pool to a seeded destination of the destination pool
    (one in eight to -1), then the leadership pool."""
    (m, cfg, ca, kp, ks, dp, _R, consts, tconsts), _ = calls["grid_rescore"]
    (_, _, _, kind_l, lp, lsl, cd_l, *_), kw = calls["score_candidates"]
    g = torch.Generator(device=dp.device).manual_seed(7)
    K = kp.shape[0]
    cd = dp[torch.randint(0, dp.shape[0], (K,), generator=g,
                          device=dp.device)]
    cd = torch.where(torch.rand(K, generator=g, device=dp.device) < 0.125,
                     -1, cd).to(torch.int32)
    kind = torch.cat([torch.zeros_like(kp), kind_l])
    return (m, cfg, ca, kind, torch.cat([kp, lp]), torch.cat([ks, lsl]),
            torch.cat([cd, cd_l]), consts, tconsts), kw


def synthetic_compaction(dev, B=10_000, Q=4, K=8192, R=8, C=1024, P=20_000,
                         seed=11):
    """K7's inputs at NROW = (Q+1)·B = 50 000 keys: scores drawn from a few
    values (many ties, +inf, -0.0 and +0.0), a fifth of the move rows
    invalid, on a seeded model table."""
    import numpy as np

    from cruise_control_tpu_torch.analyzer.cuda_optimizer import DeviceModel

    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32
    t = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    vals_pick = np.array([-3.0, -1.0, -0.0, 0.0, 2.5, np.inf], f32)
    q_scores = rng.choice(vals_pick, (Q, B))
    q_rows = np.where(rng.random((Q, B)) < 0.2, K,
                      rng.integers(0, K, (Q, B))).astype(i32)
    bl = (t(rng.choice(np.array([-1.0, -0.0, 0.0, np.inf], f32), B)),
          t(rng.integers(0, P, B).astype(i32)),
          t(rng.integers(0, 3, B).astype(i32)),
          t(rng.integers(0, B, B).astype(i32)))
    vals = np.sort(rng.normal(size=(K, R)).astype(f32), axis=1)
    vals[rng.random((K, R)) < 0.2] = np.inf
    nm = torch.zeros(1, device=dev)
    m = DeviceModel(
        assignment=nm, leader_slot=t(rng.integers(0, 3, P).astype(i32)),
        leader_load=nm, follower_load=nm, partition_topic=nm, capacity=nm,
        rack=nm, dest_ok=nm, lead_ok=nm, alive=nm, excluded=nm,
        must_move=nm, offline_origin=nm, broker_load=nm, leader_nwin=nm,
        pot_nwout=nm, rcount=nm, lcount=nm,
        pload=t(rng.random((P, 9)).astype(f32)))
    return (m, t(q_scores), t(q_rows), bl, t(rng.normal(size=K).astype(f32)),
            t(vals), t(rng.integers(-1, 64, (K, R)).astype(i32)),
            t(rng.integers(0, B, 64).astype(i32)),
            t(rng.integers(0, P, K).astype(i32)),
            t(rng.integers(0, 3, K).astype(i32)),
            t(rng.integers(0, B, K).astype(i32)), C, -1e-4)


def north_star_placement(dev, P=1_000_000, S=3, B=10_000, seed=13):
    """A seeded placement at the north star's scale (10 000 brokers,
    1 000 000 partitions, 3 replicas: 3 M slots, a few empty) with
    percentile capacity loads, for K9."""
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import DeviceModel

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.rand(shape, generator=g, device=dev)  # noqa
    a = torch.randint(0, B, (P, S), generator=g, device=dev,
                      dtype=torch.int32)
    a = torch.where(r(P, S) < 0.01, -1, a).to(torch.int32)
    nm = torch.zeros(1, device=dev)
    lead = r(P, 4) * 5.0
    return DeviceModel(
        assignment=a, leader_slot=torch.randint(
            0, S, (P,), generator=g, device=dev, dtype=torch.int32),
        leader_load=lead, follower_load=lead * 0.5, partition_topic=nm,
        capacity=torch.ones((B, 4), device=dev), rack=nm, dest_ok=nm,
        lead_ok=nm, alive=nm, excluded=nm, must_move=nm, offline_origin=nm,
        broker_load=nm, leader_nwin=nm, pot_nwout=nm, rcount=nm, lcount=nm,
        leader_cload=lead * 1.3, follower_cload=lead * 0.6)


def run_plan(opt, state):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = opt.optimize(state)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def actions_of(res):
    return [(int(a.action_type), a.partition, a.slot, a.source_broker,
             a.dest_broker, a.dest_slot) for a in res.actions]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaGoalOptimizer,
        recompute_aggregates,
    )
    from cruise_control_tpu_torch.analyzer.goal_optimizer import (
        GoalOptimizer,
        make_goals,
    )
    from cruise_control_tpu_torch.analyzer.verifier import (
        verify_result,
        violation_score,
    )
    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.ops import kernels

    # nothing on this path is a matrix product; pin full f32 all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t = time.perf_counter()
    built = kernels.build(list(KERNELS))
    build_s = time.perf_counter() - t
    ptxas = {n: p.with_suffix(".log").read_text().strip().splitlines()[-4:]
             for n, p in built.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    # ---- kernels against their plain versions on the card ------------------
    mid = random_cluster(**MIDSCALE)
    args, consts = grid_inputs(mid, {}, dev)
    k1 = check_grid_top_r("midscale", args, consts)
    ragged = random_cluster(seed=5, num_brokers=77, num_racks=7,
                            num_partitions=3001, dead_brokers=3)
    rargs, rconsts = grid_inputs(ragged, {"max_source_replicas": 1999}, dev)
    rk = check_grid_top_r("ragged", rargs, rconsts)
    if rk["K"] % 2 == 0 or rk["D"] % 32 == 0 \
            or not bool(rargs[0].must_move.any()):
        raise AssertionError(f"ragged case is not ragged: {rk}")
    del rargs
    steps = {
        "midscale": check_step_kernels("midscale", mid, {}, dev),
        "midscale_percentile": check_step_kernels(
            "midscale_percentile", with_percentile(mid), {}, dev),
        "ragged": check_step_kernels(
            "ragged", ragged, {"max_source_replicas": 1999}, dev),
    }
    if not all(r["percentile_cload"] for r in
               steps["midscale_percentile"].values()):
        raise AssertionError("percentile case ran without capacity loads")
    # K6 on moves and transfers mixed; K7 on 50 000 tie-rich keys; K9 at
    # the north star's 3 M slots
    calls, _ = first_step_calls(mid, {}, dev)
    margs, mkw = mixed_candidates(calls)
    extra = check_score_candidates("mixed_kinds", margs, mkw, False, False)
    if not 0 < extra["score_candidates"]["moves"] < margs[4].shape[0]:
        raise AssertionError("mixed-kind case holds one kind only")
    sargs = synthetic_compaction(dev)
    extra.update(check_compact_rows("nrow_50k", sargs, {}, False, False))
    if extra["compact_rows"]["NROW"] < 50_000:
        raise AssertionError("synthetic compaction is below 50 000 keys")
    extra["recompute_aggregates"] = check_recompute_aggregates(
        "north_star_slots", north_star_placement(dev), True, True)
    steps["extra"] = extra
    del calls, margs, sargs
    # deterministic aggregates: two rebuilds agree to the bit
    m0 = args[0]
    a1, a2 = recompute_aggregates(m0), recompute_aggregates(m0)
    for f in ("broker_load", "leader_nwin", "pot_nwout", "rcount", "lcount"):
        if not torch.equal(getattr(a1, f), getattr(a2, f)):
            raise AssertionError(f"aggregate {f} differs between two runs")
    emit({"phase": "aggregates", "bitwise_identical": True})
    del args, m0, a1, a2

    # ---- plan at 50 brokers / 1 000 partitions ------------------------------
    goals = make_goals()
    opt = CudaGoalOptimizer()
    opt.optimize(random_cluster(seed=43, **SMALL))          # warm-up plan
    small = random_cluster(seed=42, **SMALL)
    for fn in counters().values():
        fn.launches = 0
    r1, s1 = run_plan(opt, small)
    launches_small = {n: fn.launches for n, fn in counters().items()}
    r2, s2 = run_plan(opt, small)
    verify_result(small, r1, goals)
    score = violation_score(r1.final_state, goals)
    greedy = GoalOptimizer(goals).optimize(small)
    g_score = violation_score(greedy.final_state, goals)
    summ = r1.goal_summaries[0]
    rec = {"phase": "plan_50b_1k", "wallclock_s": s1, "wallclock_s_rerun": s2,
           "violation_score": score, "greedy_violation_score": g_score,
           "actions": len(r1.actions), "steps": summ["steps"],
           "device_calls": summ["rounds"], "launches": launches_small,
           "identical_reruns": actions_of(r1) == actions_of(r2),
           "timing_s": summ["timing_s"]}
    emit(rec)
    if score > g_score:
        raise AssertionError(f"50b plan score {score} > greedy {g_score}")
    if not rec["identical_reruns"]:
        raise AssertionError("two 50b plans differ")
    for name, n in launches_small.items():
        if n <= 0:
            raise AssertionError(f"50b plan never launched {name}")

    # ---- the main path: plan at 1 000 brokers / 20 000 partitions -----------
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    r, s = run_plan(opt, mid)
    launches = {n: fn.launches for n, fn in counters().items()}
    verify_result(mid, r, goals)
    score = violation_score(r.final_state, goals)
    summ = r.goal_summaries[0]
    emit({"phase": "plan_1000b_20k", "wallclock_s": s,
          "violation_score": score, "score_bar": MIDSCALE_SCORE_BAR,
          "actions": len(r.actions), "steps": summ["steps"],
          "device_calls": summ["rounds"],
          "mean_step_ms": summ["timing_s"]["device"] / summ["steps"] * 1e3,
          "timing_s": summ["timing_s"], "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if score > MIDSCALE_SCORE_BAR:
        raise AssertionError(f"midscale score {score} > {MIDSCALE_SCORE_BAR}")
    if set(launches) != set(KERNELS):
        raise AssertionError(f"counted {sorted(launches)}, built "
                             f"{sorted(KERNELS)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")

    # the kernels line: main-path shapes (mid-scale); errors over every case
    cases = [steps[c] for c in steps]
    main_rec = {"grid_top_r": k1, **steps["midscale"]}
    errs = {n: max([r[n]["max_abs_err"] for r in cases if n in r]
                   + ([k1["max_abs_err"], rk["max_abs_err"]]
                      if n == "grid_top_r" else []))
            for n in KERNELS}
    errs["match_batch"] = max(errs["match_batch"], *(
        r[f"match_batch[{v}]"]["max_abs_err"] for r in cases
        for v in ("track_bars", "init_used") if f"match_batch[{v}]" in r))
    line = []
    for name, replaces in KERNELS.items():
        rec = main_rec[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"cruise_control_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_note": LIBRARY_NOTES[name],
            "device_ms": rec.get("device_ms"),
        })
    print(nvidia_smi(), flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

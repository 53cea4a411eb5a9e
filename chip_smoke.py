"""Drive the PyTorch port's rebalance-plan search on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. environment: the card (``nvidia-smi``), CUDA, the TF32 settings;
2. build: every hand-written kernel compiled from ``csrc/`` (set-up time);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's mid-scale shapes and on a ragged case, with its time,
   the plain version's time and the card's bound for the same work;
4. plan at 50 brokers / 1 000 partitions: verified, no worse than the
   port's greedy oracle, twice with identical action lists;
5. plan at 1 000 brokers / 20 000 partitions at the engine's default
   widths — the main path: verified, under the quality bar, with every
   kernel's launch count from this run.

The last two lines are the ``{"kernels": [...]}`` summary and the
``{"ok": true, "device": ...}`` verdict.  Nothing here imports JAX.
"""

from __future__ import annotations

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


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
    """K1 against its plain twin on the same inputs; returns the record."""
    from cruise_control_tpu_torch.ops import grid as G

    m, cfg, ca, kp, ks, dest_pool, terms, R = args
    ks_, ki = G.grid_top_r(*args, consts=consts)
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
    # "ms" is the wrapper as the search calls it (input packing + launch);
    # "kernel_only_ms" the launch on inputs packed beforehand
    ms = cuda_ms(lambda: G.grid_top_r(*args, consts=consts))
    packed = G.pack_grid_inputs(m, cfg, ca, dest_pool, terms, consts)
    kernel_only_ms = cuda_ms(lambda: G.launch_grid_top_r(packed, R))
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
        "ms": ms, "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "bytes": nbytes, "operations": ops,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a masked grid "
                        "score with a per-row top-R",
    }
    emit(rec)
    return rec


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
        _recompute_aggregates,
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
    from cruise_control_tpu_torch.ops import grid as G
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
    built = kernels.build(["grid_top_r"])
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
    # deterministic aggregates: two rebuilds agree to the bit
    m0 = args[0]
    a1, a2 = _recompute_aggregates(m0), _recompute_aggregates(m0)
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
    G.grid_top_r.launches = 0
    r1, s1 = run_plan(opt, small)
    launches_small = G.grid_top_r.launches
    r2, s2 = run_plan(opt, small)
    verify_result(small, r1, goals)
    score = violation_score(r1.final_state, goals)
    greedy = GoalOptimizer(goals).optimize(small)
    g_score = violation_score(greedy.final_state, goals)
    summ = r1.goal_summaries[0]
    rec = {"phase": "plan_50b_1k", "wallclock_s": s1, "wallclock_s_rerun": s2,
           "violation_score": score, "greedy_violation_score": g_score,
           "actions": len(r1.actions), "steps": summ["steps"],
           "device_calls": summ["rounds"], "grid_top_r_launches":
           launches_small, "identical_reruns": actions_of(r1) == actions_of(r2),
           "timing_s": summ["timing_s"]}
    emit(rec)
    if score > g_score:
        raise AssertionError(f"50b plan score {score} > greedy {g_score}")
    if not rec["identical_reruns"]:
        raise AssertionError("two 50b plans differ")
    if launches_small <= 0:
        raise AssertionError("50b plan never launched grid_top_r")

    # ---- the main path: plan at 1 000 brokers / 20 000 partitions -----------
    torch.cuda.reset_peak_memory_stats()
    G.grid_top_r.launches = 0
    r, s = run_plan(opt, mid)
    launches = {"grid_top_r": G.grid_top_r.launches}
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")

    print(nvidia_smi(), flush=True)
    emit({"kernels": [{
        "name": "grid_top_r", "route": "cuda",
        "source": "cruise_control_tpu_torch/csrc/grid_top_r.cu",
        "replaces": "cruise_control_tpu/ops/grid.py:140 move_grid_scores + "
                    "cruise_control_tpu/analyzer/tpu_optimizer.py:2194 "
                    "_grid_top_r",
        "launches": launches["grid_top_r"],
        "max_abs_err": max(k1["max_abs_err"], rk["max_abs_err"]),
        "ms": k1["ms"], "kernel_only_ms": k1["kernel_only_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch port's rebalance-plan search and what-if engine on
one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. environment: the card (``nvidia-smi``), CUDA, the TF32 settings;
2. build: every hand-written kernel compiled from ``csrc/`` (set-up time),
   one ``nvcc`` per source, all started together;
3. kernels: first the kernels one repool launches, by name (exactly
   K10's one and K11's three); then each kernel against its plain PyTorch
   version on the card, on the inputs the search's first step hands it —
   at the main path's mid-scale shapes, with percentile capacity loads
   on, and on a ragged case — with its wrapper time, its device time, the
   plain version's time and the card's bound for the same work (K1, K2,
   K6 and K11 bit for bit, with their registers, spills and resident
   blocks an SM); the repool's tables (K10) also in their incremental form
   and bit for bit on its hard cases (incremental over every row, at its
   touched budget and one above it, every partition excluded, must-move
   slots with a dead broker, gated launches that must change nothing but
   the carry's repool flag, 10 000 brokers, replication factors 1 and 8,
   the north star's 10 000 brokers / 1 000 000 partitions); K1 in
   its three forms and K17 at replication factors 1, 2, 4 and 8 (their
   slot instances); then K2 (the grid's terms and the brokers' cost
   table) and K6 (the candidate scorer) bit for bit on chosen slots
   emptied, excluded partitions with and without a slot to move, a pool
   padded with -1, zero capacities, 10 000 brokers, at 50 / 1 000 and
   at replication factors 1 and 8, K6 also on
   moves and transfers mixed and in its row-list and carry forms; the
   compaction on 50 000 tie-rich keys, the per-broker
   reductions (K3, bit for bit with the source brokers and row scores it
   reads itself) over 10 000, 20 000 and 45 000 brokers, on one source
   broker, all +inf, at Q = 1 and 8, on -0.0 / +0.0 ties and on two
   cases past shared memory, the
   aggregate rebuild
   (K9, bit for bit, with its launches' device times) at 3 M replica
   slots and on a skewed placement (one broker hosting a quarter of the
   slots, mean and capacity loads), and the top-k (K11) over a 3 M-slot
   tie-rich
   priority and at its edge cases (k = 1, every key equal, 4 097 keys,
   tie-rich 60 000 → 8 192);
4. the step loop: one scan call at mid-scale stepped eagerly (masked
   steps, chunk by chunk) and through captured CUDA-graph chunks, with
   identical results, and the host reads each made;
5. plan at 50 brokers / 1 000 partitions: verified, no worse than the
   port's greedy oracle, twice with identical action lists;
6. plan at 1 000 brokers / 20 000 partitions at the engine's default
   widths, twice (the first captures the step chunk, the second — the
   main path — replays it), identical: verified, under the quality bar,
   with every kernel's launch count from the second run (each must be
   > 0), the launches that acted (from the device carry: K8 on active
   steps, K10 and K11 on repools; each must be > 0, and the plan must
   repool), the host reads per scan call and the graph replays;
7. what-if: the verdict kernel (K12) against its plain version, bit for
   bit on every output, at 50 brokers / 1 000 partitions × 64 futures,
   1 000 / 20 000 × 64 and × 256 (the futures cap), on the ragged case,
   on two skewed placements (one broker hosting a quarter of the slots,
   alive in every future, then dead in every other) and at the north
   star's 10 000 brokers / 1 000 000 partitions × 64, with the same times
   and bounds as phase 3 and each launch's device time and resources; the engine on the card against
   the engine on the CPU at 50 / 1 000; the host compile, the upload of
   the multipliers and the batched call timed; then the what-if path, the
   artifact's batched sweep (``whatif.artifact.measure_batch``), end to
   end at 50 / 1 000 and at 1 000 / 20 000 (the path read for launches),
   against the reference's gates: one dispatch, ≥ 64 futures, wall under
   2× one plan search;
8. search paths (the off-default configs): the score-only round's kernels
   (K13 ``round_pack``, K14 ``score_columnar``, which writes the
   columnar form's flat key itself, K11 on the flat key) and
   the corrected cohort (K15 ``corrected_accept``) against their plain
   versions, bit for bit, on 1 000 / 20 000 first-round and first-step
   inputs (mean and percentile loads, stacking guard off and on), on the
   ragged case, K15 also on one destination, one source, 777 and 1 rows,
   10 000 brokers and 65 536 rows over 66 000 brokers (its device
   scratch, chunked scan and 64-bit keys), and K14 + K11 at the north
   star's 10 000 brokers /
   1 000 000 partitions; whole rounds against ``round_plain``; one
   score-only round at 1 000 / 20 000 timed in each form (the columnar
   one launching no K13 (a)), and its full plan; then the
   paths' plans, each twice with identical actions, verified and under
   the bar: score-only rounds at 50 / 1 000 in the grid and the columnar
   form, 1 000 / 20 000 with ``polish_rounds=4`` after the resident
   search, and 1 000 / 20 000 with ``cohort_mode="corrected"`` — each
   read for its kernels' launches (the default plan of phase 6 must have
   launched none of K13-K17, and be the plan PERF.md §5 records:
   score 1 026, 162 steps, 7 081 actions, 176 launches each of K1 and
   K6).  Its incremental leg (``incremental_rescore=True``): K16
   ``stale_sets`` and K17 ``grid_patch`` against their plain versions, bit
   for bit, on the first patching step's inputs at 1 000 / 20 000, with
   percentile loads and on the ragged case, with the same times and
   bounds as phase 3, and K1 / K6 on that step's row lists and in their
   full carry-writing form; one incremental scan call eager against
   captured; calls capped at 1, 7 and ``steps_per_call`` on one captured
   chunk (default and incremental); the incremental 1 000 / 20 000 plan
   twice (identical, verified, under the bar, with patching steps) beside
   the default plan's steps and mean step time; and the 1 000 / 20 000
   plan in calls of 16 steps under a time budget, twice: one that never
   runs out (every call once the hard goals hold is capped, at most its
   cap, and the plan is the unbudgeted one's), then one of 2 s in which
   host time passes after the first capped call until about half a call
   is left (capped calls at most their caps, fewer steps, the hard goals
   held).

Every kernel of a path must have launched on that path's run (the plan
path: K1-K11, the what-if path: K12, the search paths: theirs, K13-K17
among them).  The last two lines are the ``{"kernels": [...]}`` summary
and the ``{"ok": true, "device": ...}`` verdict.  Nothing here imports
JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import re
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
#: the default plan on that fixture as PERF.md §5 records it (violation
#: score, steps, actions) and its K1 / K6 launches (11 replays of 16-step
#: chunks): the off-default paths must leave it as it is
MIDSCALE_DEFAULT_PLAN = (1026, 162, 7081)
MIDSCALE_DEFAULT_K1_K6 = 176
MIDSCALE = dict(seed=12, num_brokers=1000, num_racks=20,
                num_partitions=20000, mean_utilization=0.35)
SMALL = dict(num_brokers=50, num_racks=10, num_partitions=1000)
#: the score-only round's (K, D, L) on MIDSCALE at the engine's widths:
#: K·R + L = 73 728 flat grid-form scores, K·D + P·S = 8 252 000 columnar
MIDSCALE_ROUND = (8192, 1000, 8192)
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
#: → the reference code it replaces: phase 2 builds these, phases 3 and 7
#: check each, the runs of their paths count each, and the kernels line
#: lists each
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
    "pool_tables": "cruise_control_tpu/ops/pools.py:50-213 row tables, "
                   "broker terms, pool_prio + "
                   f"{_REF}:2120-2172 _leadership_prio_terms / "
                   f"_leadership_prio_rows + {_REF}:1016-1022 the repool's "
                   "predicates",
    "top_select": f"{_REF}:688 _select_round_pools (top_k over P·S and B) + "
                  f"{_REF}:2173 _leadership_pool (top-L)",
    "whatif_verdict": "cruise_control_tpu/whatif/engine.py:39 _verdict_one "
                      "under jax.vmap (_EVALUATE :140)",
    "round_pack": f"{_REF}:2892 _cached_round_fn: lax.top_k(-scores) over "
                  f":2334 _merged_scores, :2875 _decode_flat_idx (or "
                  f":2902 columnar_topk's gathers), :2059 _pack_round_result",
    "score_columnar": f"{_REF}:720 _build_round_candidates + {_REF}:513 "
                      "_score_candidates (as :2902 columnar_topk calls it)",
    "corrected_accept": f"{_REF}:2522 _corrected_accept + {_REF}:2503 "
                        "_seg_excl_prefix",
    "stale_sets": f"{_REF}:1075-1095 stale rows / columns / leadership, "
                  "overflow and fresh (+ the argsorts :1098, :1130, :1146, "
                  "since_full :1157)",
    "grid_patch": f"{_REF}:1096-1127 patch_rescore (a): the [K, CB] grid "
                  "over the stale columns and the exact lax.top_k R + CB "
                  "merge",
}
#: the what-if path's kernels (phase 7)
WHATIF_PATH = ("whatif_verdict",)
#: the kernels only the search's off-default paths run (phase 8)
OFF_DEFAULT = ("round_pack", "score_columnar", "corrected_accept",
               "stale_sets", "grid_patch")
_PLAN = tuple(n for n in KERNELS if n not in WHATIF_PATH + OFF_DEFAULT)
#: each path the script drives → the kernels its run must launch
PATHS = {"plan": _PLAN,
         "whatif": WHATIF_PATH,
         # score-only rounds: a full repool, the grid form's K2/K1/K6 or the
         # columnar form's K14, K13 around K11, and K9 at each resync
         "score_only_grid": ("pool_tables", "top_select", "grid_terms",
                             "grid_top_r", "score_candidates", "round_pack",
                             "recompute_aggregates"),
         "score_only_columnar": ("pool_tables", "top_select",
                                 "score_columnar", "round_pack",
                                 "recompute_aggregates"),
         "polish": _PLAN + ("round_pack",),
         "corrected": tuple(n for n in _PLAN if n != "budget_accept")
         + ("corrected_accept",),
         "incremental": _PLAN + ("stale_sets", "grid_patch")}
#: the path whose run gives each off-default kernel's launches in the
#: kernels line
LAUNCH_PATH = {"round_pack": "polish", "score_columnar":
               "score_only_columnar", "corrected_accept": "corrected",
               "stale_sets": "incremental", "grid_patch": "incremental"}
#: the what-if sweep's size: the artifact's floor, and the futures cap
#: (``whatif.max.futures``)
WHATIF_FUTURES = 64
WHATIF_MAX_FUTURES = 256
#: K12's kernels by ``whatif_verdict_attrs``' phase number
VERDICT_PHASES = ("alive", "part", "sort_count", "prep", "scatter", "brokers",
                  "finish")
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
    "score_candidates": "a chain of gathers and two fused costs, the two "
                        "before the move read from K2's table: no single "
                        "PyTorch call",
    "compact_rows": "torch.sort ranks the keys, but not the gathers, "
                    "budget vectors and partition filter that follow",
    "commit_batch": "a sort, an output write and exact segment sums: no "
                    "single PyTorch call",
    "recompute_aggregates": "index_add_ over the slots' load rows "
                            "(library_ms) sums one of the six aggregates "
                            "with float atomics, not exactly",
    "pool_tables": "row tables with a rack scan, broker terms and two "
                   "priorities over P·S: no single PyTorch call",
    "top_select": "torch.topk (library_ms) keeps the same k largest but "
                  "orders ties in no fixed way on CUDA; torch.sort(stable="
                  "True) (library_sort_ms) gives the same order by sorting "
                  "all N",
    "whatif_verdict": "index_add_ of the futures' slot loads into [N·(B+1), "
                      "R] (library_ms) sums the hosted load with float "
                      "atomics, not exactly; no single PyTorch call gives "
                      "the verdicts",
    "round_pack": "torch.topk of the negated flat key (library_ms) keeps the "
                  "same k largest but orders ties in no fixed way on CUDA; "
                  "the gather, decode and pack are no single PyTorch call",
    "score_columnar": "a chain of gathers and four fused costs over the "
                      "flat K·D + P·S candidates: no single PyTorch call",
    "corrected_accept": "two segmented prefix sums and four fused costs a "
                        "row: no single PyTorch call",
    "stale_sets": "three gathered masks, their counts, a decision and "
                  "three stable compactions: no single PyTorch call",
    "grid_patch": "a masked grid score over gathered columns and an exact "
                  "top-R merge in the floats' total order: no single "
                  "PyTorch call",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def kernel_name(name: str) -> str:
    """A profiled kernel's name without its namespace and arguments."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name


def device_ms(fn, tag: str, reps: int = 10, by_name: bool = False):
    """Milliseconds of device time a call of ``fn`` spends in kernels whose
    name holds ``tag``, from ``torch.profiler`` over ``reps`` calls; None
    if the profiler shows no such kernel.  With ``by_name`` a dict of the
    milliseconds a call by kernel name (its name up to the argument
    list)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [(kernel_name(e.name), e.time_range.elapsed_us())
          for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and tag in e.name]
    if by_name:
        names = {}
        for n, t in us:
            names[n] = names.get(n, 0.0) + t * 1e-3 / reps
        return names
    return sum(t for _, t in us) * 1e-3 / reps if us else None


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
    plain twin on the same inputs, bit for bit (scores and indices), with
    the built instance's registers, spills and resident blocks an SM;
    returns the record."""
    from cruise_control_tpu_torch.ops import grid as G

    m, cfg, ca, kp, ks, dest_pool, terms, R = args
    packed = G.grid_terms(m, cfg, ca, kp, ks, dest_pool, consts)
    got = G.launch_grid_top_r(packed, R)
    torch.cuda.synchronize()
    want = G.grid_top_r_plain(*args)
    bitwise(f"{label} grid_top_r", got, want)
    g = G.move_grid_scores(m, cfg, ca, kp, ks, dest_pool, terms=terms)
    K, D = kp.shape[0], dest_pool.shape[0]
    S = m.assignment.shape[1]
    n_feasible = int(torch.isfinite(g).sum())
    ms = cuda_ms(lambda: G.launch_grid_top_r(packed, R))
    dev_ms = (device_ms(lambda: G.launch_grid_top_r(packed, R),
                        "grid_top_r_kernel") if label == "midscale" else None)
    plain_ms = cuda_ms(lambda: G.grid_top_r_plain(*args), reps=20)
    # least time for the same work: inputs read once, outputs written once;
    # the function's least operations (ops/grid.py: grid_top_r_ops)
    nbytes = (K * (G._SF + 3 * S + 2) + D * (G._DF + G._DI) + G._NC) * 4 \
        + K * R * 8
    ops = G.grid_top_r_ops(K * D, n_feasible, S, D)
    n = K
    W, grid = G.grid_top_r_geometry(
        n, D, torch.cuda.get_device_properties(0).multi_processor_count,
        G.grid_top_r_attrs(S, packed["has_cap"], D)["blocks_per_sm"])
    rec = {
        "phase": "kernel", "case": label, "name": "grid_top_r",
        "K": K, "D": D, "S": S, "R": R, "feasible_cells": n_feasible,
        "percentile_cload": bool(packed["has_cap"]),
        "max_abs_err": 0.0, "bit_equal": True,
        "attrs": G.grid_top_r_attrs(S, packed["has_cap"], D),
        "warps_a_row": W, "grid": grid,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        **bound(nbytes, ops), "library_ms": None,
        "library_note": LIBRARY_NOTES["grid_top_r"],
    }
    emit(rec)
    return rec


def check_slot_instances(dev):
    """K1 in its three forms (the full grid, a row list, into the carry)
    and K17 at replication factors 1, 2, 4 and 8 — each a compiled slot
    instance (S = 3 runs in every other phase) — against their plain twins
    bit for bit, on a 200-broker / 4 000-partition cluster's first-step
    tables; K17 over 32 pool columns, 20 of them stale → the records."""
    from cruise_control_tpu_torch.analyzer import rescore_kernels as RK
    from cruise_control_tpu_torch.analyzer import step_state as SS
    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.ops import grid as G

    recs = []
    for S in (1, 2, 4, 8):
        state = random_cluster(seed=5, num_brokers=200, num_racks=20,
                               num_partitions=4000, replication_factor=S)
        args, consts = grid_inputs(state, {}, dev)
        m, cfg, ca, kp, ks, dp, terms, R = args
        if m.assignment.shape[1] != S:
            raise AssertionError(f"rf {S} cluster has {m.assignment.shape}")
        packed = G.grid_terms(m, cfg, ca, kp, ks, dp, consts)
        K, D = packed["K"], packed["D"]
        bitwise(f"rf{S} grid_top_r", G.launch_grid_top_r(packed, R),
                G.grid_top_r_plain(*args))
        gate = torch.zeros(SS.NSTATE, dtype=torch.int32, device=dev)
        gate[SS.ACTIVE] = 1
        gate[SS.FRESH] = 1
        carry = [torch.zeros((K, R), dtype=torch.float32, device=dev),
                 torch.zeros((K, R), dtype=torch.int32, device=dev)]
        twin = [t.clone() for t in carry]
        G.grid_rescore_carry(m, cfg, ca, kp, ks, dp, packed, R, *carry, gate,
                             1)
        G.grid_rescore_carry_plain(m, cfg, ca, kp, ks, dp, packed, R, *twin,
                                   gate, 1)
        bitwise(f"rf{S} grid_top_r[carry_full]", carry, twin)
        g = torch.Generator(device=dev).manual_seed(S)
        rows = torch.randperm(K, generator=g, device=dev)[:64].to(
            torch.int32)
        n_rows = torch.tensor([37], dtype=torch.int32, device=dev)
        patch = gate.clone()
        patch[SS.FRESH] = 0
        got = [t.clone() for t in carry]
        want = [t.clone() for t in carry]
        G.grid_rescore_carry(m, cfg, ca, kp, ks, dp, packed, R, *got, patch,
                             0, rows, n_rows)
        G.grid_rescore_carry_plain(m, cfg, ca, kp, ks, dp, packed, R, *want,
                                   patch, 0, rows, n_rows)
        bitwise(f"rf{S} grid_top_r[rows]", got, want)
        cols = torch.full((32,), -1, dtype=torch.int32, device=dev)
        cols[:20] = torch.randperm(D, generator=g, device=dev)[:20].to(
            torch.int32)
        tb = torch.rand(m.capacity.shape[0], generator=g, device=dev) < 0.1
        got = [t.clone() for t in carry]
        want = [t.clone() for t in carry]
        RK.grid_patch(m, cfg, ca, kp, ks, dp, packed, cols, tb, *got, patch)
        RK.grid_patch_plain(m, cfg, ca, kp, ks, dp, packed, cols, tb, *want,
                            patch)
        bitwise(f"rf{S} grid_patch", got, want)
        rec = {"phase": "slot_instance", "S": S,
               "instance": G.slot_instance(S), "K": K, "D": D,
               "forms_bit_equal": ["grid_top_r", "grid_top_r[carry_full]",
                                   "grid_top_r[rows]", "grid_patch"],
               "stale_rows": 37, "stale_columns": 20,
               "attrs": G.grid_top_r_attrs(S, packed["has_cap"], D),
               "attrs_grid_patch": RK.grid_patch_attrs(S, packed["has_cap"],
                                                       32)}
        emit(rec)
        recs.append(rec)
    return recs


def counters():
    """Each kernel's counted wrapper (``.launches``)."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK
    from cruise_control_tpu_torch.ops import grid as G

    from cruise_control_tpu_torch.analyzer import commit_kernels as K89
    from cruise_control_tpu_torch.analyzer import compact_kernel as K7
    from cruise_control_tpu_torch.analyzer import score_kernel as K6

    from cruise_control_tpu_torch.analyzer import corrected_kernel as K15
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.analyzer import rescore_kernels as K1617
    from cruise_control_tpu_torch.analyzer import round_kernels as RK
    from cruise_control_tpu_torch.whatif import verdict_kernels as VK

    # K13's first entry point (``round_keys``) counts apart: see
    # search_path_plan
    return {"grid_top_r": G.launch_grid_top_r, "grid_terms": G.grid_terms,
            "per_src_top": SK.per_src_top,
            "budget_accept": SK.budget_accept,
            "match_batch": SK.match_batch,
            "score_candidates": K6.score_candidates,
            "compact_rows": K7.compact_rows,
            "commit_batch": K89.commit_batch,
            "recompute_aggregates": K89.recompute_aggregates,
            "pool_tables": PK.pool_tables, "top_select": PK.top_select,
            "whatif_verdict": VK.whatif_verdict,
            "round_pack": RK.round_pack,
            "score_columnar": RK.score_columnar,
            "corrected_accept": K15.corrected_accept,
            "stale_sets": K1617.stale_sets,
            "grid_patch": K1617.grid_patch}


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
    K10 and K11 (its three calls), recorded (copied: K8 and K10 update
    their inputs in place) from one step of the engine's own step loop,
    stepped eagerly; and the uploaded model K9 rebuilt."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.ops.grid import grid_consts

    opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(**cfg_kw), device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    names = ("grid_rescore", "score_candidates", "per_src_top",
             "compact_rows", "budget_accept", "corrected_accept",
             "match_batch", "commit_batch", "pool_tables", "top_select")
    saved = {n: getattr(C, n) for n in names}
    calls = {"recompute_aggregates": ((m,), {}), "top_select": []}

    def shim(n):
        def f(*a, **k):
            if n == "top_select":
                if len(calls[n]) < 3:
                    calls[n].append(copy.deepcopy((a, k)))
            elif n not in calls:
                calls[n] = copy.deepcopy((a, k))
            return saved[n](*a, **k)
        return f

    try:
        for n in names:
            setattr(C, n, shim(n))
        cfg = C._resolve_batch(opt.config, ctx.num_brokers)
        C._scan_call(m, cfg, ca, grid_consts(cfg, ca, dev), K, D, 1,
                     C._cold_tables(m), capture=False)
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


def bitwise(label, got, want) -> None:
    """Every output equal to the plain twin's bit for bit (floats compared
    by their bits: -0.0, +0.0 and the infinities apart)."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label}[{i}]: {a.dtype} {tuple(a.shape)} "
                                 f"vs plain {b.dtype} {tuple(b.shape)}")
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{label}[{i}]: {int((a != b).sum())} "
                                 "entries differ from the plain twin in "
                                 "their bits")


def bound(nbytes: float, ops: float) -> dict:
    """Least time for the work: bytes at HBM rate vs f32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def record_kernel(label, name, fn, plain, args, kw, extra, nbytes, ops,
                  plain_kw=None, timed=False, tag=None, exact=False):
    """Run kernel wrapper ``fn`` and its plain twin ``plain`` on copies of
    the same inputs (K8 updates its inputs in place), compare their
    outputs (with ``exact``, every output bit for bit), time both and bound
    the work → the emitted record.  With ``timed`` the record also has the
    kernel's device time alone (the kernels whose names hold ``tag``, by
    default ``<kernel>_kernel``)."""
    plain_kw = kw if plain_kw is None else plain_kw
    got = fn(*copy.deepcopy(args), **kw)
    torch.cuda.synchronize()
    want = plain(*copy.deepcopy(args), **plain_kw)
    err = compare(f"{label} {name}", got, want)
    if exact:
        bitwise(f"{label} {name}", got, want)
    targs, pargs = copy.deepcopy(args), copy.deepcopy(args)
    kernel = name.split("[")[0]
    # timed as the step calls it after its first step: inputs checked once
    tkw = dict(kw, checked=True) if "checked" in kw else kw
    rec = {"phase": "kernel", "case": label, "name": name,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: fn(*targs, **tkw)),
           "device_ms": (device_ms(lambda: fn(*targs, **tkw),
                                   tag or f"{kernel}_kernel")
                         if timed else None),
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
    calls, has_cap = first_step_calls(state, cfg_kw, dev)
    timed = label == "midscale"
    recs = {}

    # K2: the packed tables K1 reads
    args, _ = calls["grid_rescore"]
    recs.update(check_grid_terms(label, args[:6] + args[7:], has_cap, timed))
    # K6 on the leadership pool, as the step calls it
    args, kw = calls["score_candidates"]
    recs.update(check_score_candidates(label, args, kw, has_cap, timed))
    # K3, its inputs' gathers folded in
    args, kw = calls["per_src_top"]
    recs.update(check_per_src_top(label, args, kw, timed, has_cap))
    # K7
    args, kw = calls["compact_rows"]
    recs.update(check_compact_rows(label, args, kw, has_cap, timed))
    # K4
    args, kw = calls["budget_accept"]
    recs.update(check_budget_accept(label, args, kw, has_cap, timed))
    # K5 from the cohort's rows (as the step calls it), on the track_bars
    # branch, and from the footprint's occupancy tables
    args, kw = calls["match_batch"]
    for name, a5, kw5 in match_forms(args, kw):
        recs.update(check_match_batch(label, a5, kw5, has_cap,
                                      timed and "[" not in name, name=name))
    # K8
    args, kw = calls["commit_batch"]
    recs.update(check_commit_batch(label, args, kw, has_cap, timed))
    # K9 on the uploaded model
    (m0,), _ = calls["recompute_aggregates"]
    recs["recompute_aggregates"] = check_recompute_aggregates(
        label, m0, has_cap, timed)
    # K10 on the first step's repool (full) and in its incremental form
    args, kw = calls["pool_tables"]
    recs.update(check_pool_tables(label, args, kw, has_cap, timed))
    # K11: the first repool's three selections (top-K, top-D, top-L)
    for tag, (args, kw) in zip(("", "[dest]", "[lead]"),
                               calls["top_select"]):
        recs.update(check_top_select(label, "top_select" + tag, args, kw,
                                     timed and not tag, has_cap))
    return recs


def _pool_outputs(fn, state0, tpp0):
    """K10 (or its twin) as a function of its inputs → the buffers it
    writes; the carry and touched set are restored first, so every timed
    call repools as the first did (two small copies)."""
    def run(m, ca, pb, state, rows_budget, **kw):
        state.copy_(state0)
        pb.tpp.copy_(tpp0)
        fn(m, ca, pb, state, rows_budget, **kw)
        return [pb.size, pb.base, pb.tpp, pb.prio, pb.lprio, pb.dneg, state]
    return run


def check_pool_tables(label, args, kw, has_cap, timed):
    """K10 against ``pool_tables_plain`` → {name: record}: as the first
    step calls it (a full rebuild), and incremental — the stored tables of
    the full rebuild, the carry valid, ~1 % of the partitions touched —
    which must also equal the full rebuild to the bit."""
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.analyzer import step_state as SS

    m, ca, pb, state, _ = args
    P, S = m.assignment.shape
    B, NR = m.capacity.shape
    full = copy.deepcopy(args)
    PK.pool_tables(*full, **kw)
    g = torch.Generator(device=state.device).manual_seed(5)
    inc_pb = copy.deepcopy(full[2])
    inc_pb.tpp.copy_(torch.rand(P, generator=g, device=state.device) < 0.01)
    inc_state = state.clone()
    inc_state[SS.PT_VALID] = 1
    n_touched = int(inc_pb.tpp.sum())
    inc_args = (m, ca, inc_pb, inc_state, max(n_touched, P // 2))
    recs = {}
    for name, a, n_ref in (("pool_tables", args, P),
                           ("pool_tables[incremental]", inc_args,
                            n_touched)):
        s0, t0 = a[3].clone(), a[2].tpp.clone()
        recs[name] = record_kernel(
            label, name, _pool_outputs(PK.pool_tables, s0, t0),
            _pool_outputs(PK.pool_tables_plain, s0, t0), a, kw,
            {"percentile_cload": has_cap, "P": P, "S": S, "B": B,
             "rows_refreshed": n_ref},
            # each input once: the broker tables; a partition's slots,
            # leader slot, must-move flags, exclusion and touched mark; a
            # refreshed row's load rows and written tables, an untouched
            # row's stored tables; both priorities out, the dest scores
            B * (4 * NR * (3 if has_cap else 2) + 15) + P * (5 * S + 6)
            + n_ref * (8 * NR + 8 * S) + (P - n_ref) * 8 * S + P * 8 * S
            + B * 4,
            # ~60 operations a broker; a refreshed slot's divisions and
            # rack scan; ~12 a slot for the two priorities
            B * 60 + n_ref * S * (2 * NR + S + 6) + P * S * 12,
            plain_kw={}, timed=timed and "[" not in name,
            tag="pool_tables_")
    if timed:
        recs["pool_tables"]["attrs"] = PK.pool_tables_attrs(S)
    # the diet's exactness on the card: incremental == full rebuild
    got = _pool_outputs(PK.pool_tables, inc_args[3].clone(),
                        inc_args[2].tpp.clone())(*copy.deepcopy(inc_args))
    want = [full[2].size, full[2].base, full[2].tpp, full[2].prio,
            full[2].lprio, full[2].dneg]
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: incremental K10 output {i} "
                                 "differs from the full rebuild")
    if int(got[6][SS.FULL]) != 0 or int(got[6][SS.N_INCR]) != 1:
        raise AssertionError(f"{label}: incremental K10 rebuilt every row")
    return recs


def repool_args(state, dev, rows_budget: int = -1):
    """K10's arguments for the first repool of ``state``'s uploaded model
    (fresh pool buffers, the carry of a first step: active, a repool
    asked for, the stored tables not valid) → (m, ca, pb, state,
    rows_budget)."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext

    opt = C.CudaGoalOptimizer(device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    P, S = m.assignment.shape
    K, D = opt._pool_sizes(P, S, ctx.num_brokers)
    pb = C.PoolBuffers.empty(P, S, ctx.num_brokers, K, D,
                             C._leadership_pool_size(P, S, K), dev)
    st = C.StepState.empty(1, 1, 0, dev)
    return m, ca, pb, st.initial(False).to(dev), rows_budget


@functools.lru_cache(maxsize=None)
def north_star_state(seed=13):
    """The north star's seeded cluster: 10 000 brokers in 100 racks,
    1 000 000 partitions of 3 replicas."""
    from cruise_control_tpu_torch.models.generators import random_cluster

    return random_cluster(seed=seed, num_brokers=10_000, num_racks=100,
                          num_partitions=1_000_000)


def pool_cases(args, dev, seed=7):
    """K10's hard cases beside the first step's repool (``args``, a
    full rebuild): incremental over every row, at a touched count equal
    to its budget (the diet on) and one above it (off), every partition
    excluded, must-move slots with a dead broker, gated launches (an
    inactive step, a step that needs no repool: nothing but the carry's
    repool flag may change), 10 000 brokers, replication factors 1 and 8
    and the north star's 10 000 brokers / 1 000 000 partitions →
    {case: args}."""
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.analyzer import step_state as SS
    from cruise_control_tpu_torch.models.generators import random_cluster

    m, ca, pb, state, _ = args
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    stored = copy.deepcopy(pb)
    PK.pool_tables_plain(m, ca, stored, state.clone(), -1)
    g = torch.Generator(device=dev).manual_seed(seed)
    some = torch.rand(P, generator=g, device=dev) < 0.01
    n = int(some.sum())

    def incr(tpp, budget, **carry):
        pb2 = copy.deepcopy(stored)
        pb2.tpp.copy_(tpp)
        st = state.clone()
        st[SS.PT_VALID] = 1
        for k, v in carry.items():
            st[getattr(SS, k)] = v
        return (m, ca, pb2, st, budget)

    cases = {
        "incr_all_rows": incr(torch.ones_like(some), P),
        "incr_at_budget": incr(some, n),
        "incr_over_budget": incr(some, n - 1),
        "gated_inactive": incr(some, n, ACTIVE=0),
        "gated_no_repool": incr(some, n, NEED_POOL=0),
        "all_excluded": (dataclasses.replace(
            m, excluded=torch.ones_like(m.excluded)), ca,
            copy.deepcopy(pb), state.clone(), -1),
    }
    dead = int(m.assignment[m.assignment >= 0][0])
    alive = m.alive.clone()
    alive[dead] = False
    dest_ok = m.dest_ok.clone()
    dest_ok[dead] = False
    must = (m.assignment == dead) | (torch.rand(
        (P, S), generator=g, device=dev) < 0.02)
    cases["must_move_dead"] = (dataclasses.replace(
        m, alive=alive, dest_ok=dest_ok, must_move=must & (m.assignment >= 0)),
        ca, copy.deepcopy(pb), state.clone(), -1)
    tile = 10
    big = tile_brokers(m, tile)
    spread = torch.randint(0, B * tile, (P, S), generator=g, device=dev,
                           dtype=torch.int32)
    big = dataclasses.replace(big, assignment=torch.where(
        m.assignment >= 0, spread, m.assignment))
    cases["b10k"] = (big, ca, PK.PoolBuffers.empty(
        P, S, B * tile, pb.kp.shape[0], pb.dest_pool.shape[0],
        pb.lp.shape[0], dev), state.clone(), -1)
    for rf in (1, 8):
        cases[f"rf{rf}"] = repool_args(random_cluster(
            seed=5, num_brokers=200, num_racks=20, num_partitions=4000,
            replication_factor=rf), dev)
    cases["north_star"] = repool_args(north_star_state(), dev)
    return cases


def check_pool_case(label, args):
    """K10 against ``pool_tables_plain`` on one of :func:`pool_cases`, bit
    for bit on every output and the carry; a gated case must also leave
    every output as it was → {name: record}."""
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.analyzer import step_state as SS

    m, _, pb, state, budget = args
    run = lambda fn: _pool_outputs(fn, state.clone(), pb.tpp.clone())(  # noqa
        *copy.deepcopy(args))
    got = run(PK.pool_tables)
    torch.cuda.synchronize()
    want = run(PK.pool_tables_plain)
    name = f"pool_tables[{label}]"
    bitwise(name, got, want)
    repool = int(got[6][SS.REPOOL])
    if label.startswith("gated"):
        before = [pb.size, pb.base, pb.tpp, pb.prio, pb.lprio, pb.dneg]
        bitwise(f"{name} unchanged", got[:6], before)
        carry = state.clone()
        carry[SS.REPOOL] = 0
        bitwise(f"{name} carry", got[6], carry)
    P, S = m.assignment.shape
    rec = {"phase": "kernel_case", "case": label, "name": name,
           "max_abs_err": 0.0, "bit_equal": True, "P": P, "S": S,
           "B": m.capacity.shape[0], "rows_budget": budget,
           "touched": int(pb.tpp.sum()), "repool": repool,
           "full": int(got[6][SS.FULL])}
    emit(rec)
    return {name: rec}


def check_top_select(label, name, args, kw, timed, has_cap=False):
    """K11 against ``top_select_plain``, bit for bit, → {name: record},
    with its grid, its registers, spills and resident blocks an SM, and
    torch.topk and a stable torch.sort on the same input timed beside
    it."""
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK

    def outs(fn):
        def run(x, hi, lo=None, flat=None, **k):
            fn(x, hi, lo, flat, **k)
            return [t for t in (hi, lo, flat) if t is not None]
        return run

    x, hi, lo, flat = (list(args) + [None, None])[:4]
    N, k = x.shape[0], hi.shape[0]
    log_k = max(k - 1, 1).bit_length()
    rec = record_kernel(
        label, name, outs(PK.top_select), outs(PK.top_select_plain), args,
        kw, {"percentile_cload": has_cap, "N": N, "k": k,
             "blocks": PK.top_select_grid(
                 N, k, torch.cuda.get_device_properties(
                     x.device).multi_processor_count),
             "attrs": PK.top_select_attrs(k),
             "finite": int(torch.isfinite(x).sum())},
        # each key read once; the k indices (and slots, flat ids) out
        N * 4 + k * 4 * (1 + (lo is not None)) + k * 8 * (flat is not None),
        # three radix passes, the gather over N keys; the rank of the k
        # kept (the least a comparison sort needs: k log2 k)
        4 * N + k * log_k, timed=timed, tag="top_select_kernel",
        exact=True)
    rec["library_ms"] = cuda_ms(lambda: torch.topk(x, k))
    rec["library_sort_ms"] = cuda_ms(
        lambda: torch.sort(x, descending=True, stable=True))
    emit({"phase": "kernel_library", "case": label, "name": name,
          "library_ms": rec["library_ms"],
          "library_sort_ms": rec["library_sort_ms"]})
    return {name: rec}


def check_top_select_cases(dev):
    """K11 on the edge cases of its selection, each bit for bit against
    ``top_select_plain`` (all three outputs): k = 1 of 60 000 tie-rich
    keys, 60 000 equal keys → 8 192, one key past a block's slice (4 097 →
    2 048) and the tie-rich ±0.0 / -inf keys at the main path's 60 000 →
    8 192 (k = N is the repool's top-D, phase 3's ``top_select[dest]``; the
    3 M-slot priority is ``top_select[3M]``) → {name: record}."""
    recs = {}
    for name, n, k, equal in (("top_select[k1]", 60_000, 1, False),
                              ("top_select[all_equal]", 60_000, 8192, True),
                              ("top_select[4097]", 4097, 2048, False),
                              ("top_select[60k]", 60_000, 8192, False)):
        args, kw = synthetic_priority(dev, n=n, k=k, seed=23)
        if equal:
            args = (torch.full((n,), 2.5, device=dev),) + args[1:]
        recs.update(check_top_select("edge_cases", name, args, kw, False))
    return recs


def check_grid_terms(label, args, has_cap, timed, name="grid_terms"):
    """K2 against ``grid_terms_plain``, bit for bit, on ``args`` = (m, cfg,
    ca, kp, ks, dest_pool, consts, tconsts) → {name: record}: the four
    packed tables and the brokers' cost table, which each run writes into
    a buffer of its own."""
    from cruise_control_tpu_torch.ops import grid as G

    m, kp, dp = args[0], args[3], args[5]
    B = m.capacity.shape[0]
    K, D = kp.shape[0], dp.shape[0]
    S = m.assignment.shape[1]
    W = m.pload.shape[1]
    NR = m.capacity.shape[1]
    n_part = int(torch.unique(kp).numel())

    def run(fn, *a):
        packed = fn(*a, bcost=torch.empty(B, device=m.capacity.device))
        return [packed[k] for k in ("src_f", "src_i", "dst_f", "dst_i",
                                    "bcost")]
    return {name: record_kernel(
        label, name, functools.partial(run, G.grid_terms),
        lambda *a: run(G.grid_terms_plain, *a[:7]), args, {},
        {"percentile_cload": has_cap, "K": K, "D": D, "S": S, "B": B,
         "distinct_partitions": n_part,
         "attrs": G.grid_terms_attrs(S, W == 4 * NR + 1)},
        # each input once: kp, ks and the pool; each distinct partition
        # row (slots, origins, must-move, leader slot, load row); the
        # broker tables; the constants; the four packed tables and the
        # brokers' costs out
        K * 8 + D * 4 + n_part * (9 * S + 4 + 4 * W)
        + B * (4 * (NR * (3 if has_cap else 2) + 4) + 6)
        + 4 * (G._NC + G._NT)
        + K * 4 * (G._SF + 3 * S + 2) + D * 4 * (G._DF + G._DI) + B * 4,
        # two broker costs (~85 operations each) and ~20 more a source;
        # one cost and ~20 more a destination, one a broker's cost
        # (csrc/grid_terms.cu)
        K * 190 + D * 105 + B * 85, timed=timed,
        tag="grid_terms_", exact=True)}


def score_outputs(plain, *args, **kw):
    """K6's wrapper (or, with ``plain``, its twin) → its outputs: (delta,
    feasible), or in a carry form (``out`` in ``kw``) the carry it writes,
    on a copy of its own."""
    from cruise_control_tpu_torch.analyzer import score_kernel as K6

    if "out" not in kw:
        return list(K6._score_candidates(*args[:7]) if plain
                    else K6.score_candidates(*args, **kw))
    out = kw["out"][0].clone()
    if plain:
        K6._score_candidates_into(*args[:7], out, None, kw.get("rows"),
                                  kw.get("n_rows"), kw.get("gate"),
                                  kw.get("want", 1))
    else:
        K6.score_candidates(*args, **dict(kw, out=(out, None)))
    return [out]


def check_score_candidates(label, args, kw, has_cap, timed,
                           name="score_candidates"):
    """K6 against ``_score_candidates`` (or, in a carry form,
    ``_score_candidates_into``), bit for bit → {name: record}."""
    from cruise_control_tpu_torch.analyzer import score_kernel as K6

    m, _, _, kind, cp, cs, cd = args[:7]
    S = m.assignment.shape[1]
    N = cp.shape[0]
    if kw.get("rows") is not None:
        N = min(kw["rows"].shape[0], int(kw["n_rows"][0]))
    W = m.pload.shape[1]
    NR = m.capacity.shape[1]
    row = m.assignment[cp.long()]
    brokers = torch.cat([row.reshape(-1), cd]).clamp_min(0)
    n_part = min(N, int(torch.unique(cp).numel()))
    n_brk = int(torch.unique(brokers).numel())
    rec = record_kernel(
        label, name, functools.partial(score_outputs, False),
        functools.partial(score_outputs, True), args, kw,
        {"percentile_cload": has_cap, "N": N,
         "B": m.capacity.shape[0], "moves": int((kind == 0).sum()),
         "distinct_partitions": n_part,
         "distinct_brokers": n_brk,
         "attrs": K6.score_candidates_attrs(S, W == 4 * NR + 1)},
        # each input once: the four ids a candidate; each distinct
        # partition's row (slots, origins, must-move, leader slot, load
        # row); each broker read (tables as K2's, and its cost from K2's
        # table); the constants; delta and the feasible flag out
        N * 16 + n_part * (9 * S + 4 + 4 * W)
        + n_brk * (4 * (NR * (3 if has_cap else 2) + 4) + 6 + 4)
        + 4 * (3 * NR + 16) + N * 5,
        # two broker costs, after the move (~85 operations each; K2's
        # table gives the two before it) and ~60 more a candidate
        N * 230, timed=timed, tag="score_candidates_",
        exact=True)
    return {name: rec}


def tile_brokers(m, tile: int):
    """``m`` with its broker tables repeated ``tile`` times."""
    return dataclasses.replace(m, **{
        f: getattr(m, f).repeat(tile, *([1] * (getattr(m, f).dim() - 1)))
        for f in ("capacity", "rack", "dest_ok", "lead_ok", "alive",
                  "broker_load", "broker_cload", "leader_nwin", "pot_nwout",
                  "rcount", "lcount")
        if getattr(m, f) is not None})


def score_terms_cases(calls, dev, seed=41):
    """K2's and K6's inputs on a first step (``calls``, from
    :func:`first_step_calls`) made hard → {case: (K2 args or None, (K6
    args, kw) or None)}, each K6 given its model's cost table
    (``broker_costs_plain``): a quarter of the chosen slots emptied; a
    third of the chosen partitions excluded, half of those with the chosen
    slot to move; the destination pool's last 100 entries -1 (K2; K6's
    moves to -1 are in ``mixed_kinds``); one resource of every seventh
    broker at zero capacity; the broker tables tiled to 10 000 brokers,
    every slot's broker and the pool spread over the copies; K6 on moves
    and transfers mixed, on a row list (1 203 of 2 048 entries, the
    patch's form) and into the carry (the full rescore's form)."""
    from cruise_control_tpu_torch.analyzer import step_state as SS
    from cruise_control_tpu_torch.ops import grid as G

    (m, cfg, ca, kp, ks, dp, _R, consts, tconsts), _ = calls["grid_rescore"]
    a6, kw6 = calls["score_candidates"]
    lp, lsl = a6[4], a6[5]
    g = torch.Generator(device=dev).manual_seed(seed)
    NR = m.capacity.shape[1]
    B = m.capacity.shape[0]

    def case(mm, dp_=dp):
        # K6 reads the cost table of the case's own model
        return ((mm, cfg, ca, kp, ks, dp_, consts, tconsts),
                ((mm,) + tuple(a6[1:]),
                 dict(kw6, bcost=G.broker_costs_plain(mm, cfg, ca))))

    a = m.assignment.clone()
    a[kp[::4].long(), ks[::4].long()] = -1
    a[lp[1::4].long(), lsl[1::4].long()] = -1
    pl = m.pload.clone()
    pl[torch.cat([kp[::3], lp[::3]]).long(), 2 * NR] = 1.0
    mm = m.must_move.clone()
    mm[kp[::6].long(), ks[::6].long()] = True
    mm[lp[::6].long(), lsl[::6].long()] = True
    cap = m.capacity.clone()
    b = torch.arange(0, B, 7, device=dev)
    cap[b, b % NR] = 0.0
    pad = dp.clone()
    pad[-100:] = -1
    tile = 10
    spread = lambda x: torch.where(  # noqa: E731
        x >= 0, x + B * torch.randint(0, tile, x.shape, generator=g,
                                      device=dev).to(x), x)
    cases = {
        "empty_slot": case(dataclasses.replace(m, assignment=a)),
        "excluded": case(dataclasses.replace(m, pload=pl, must_move=mm)),
        "pool_pad": (case(m, pad)[0], None),
        "zero_cap": case(dataclasses.replace(m, capacity=cap)),
        "b10k": case(dataclasses.replace(tile_brokers(m, tile),
                                         assignment=spread(m.assignment)),
                     spread(dp)),
        "mixed_kinds": (None, mixed_candidates(calls)),
    }
    # the incremental rescore's two carry forms
    L = lp.shape[0]
    gate = torch.zeros(SS.NSTATE, dtype=torch.int32, device=dev)
    gate[SS.ACTIVE] = 1
    full = gate.clone()
    full[SS.FRESH] = 1
    ls = torch.zeros(L, dtype=torch.float32, device=dev)
    rows = torch.randperm(L, generator=g, device=dev)[:2048].to(torch.int32)
    n_rows = torch.tensor([1203], dtype=torch.int32, device=dev)
    cases["rows"] = (None, (a6, dict(kw6, out=(ls, None), rows=rows,
                                     n_rows=n_rows, gate=gate, want=0)))
    cases["carry_full"] = (None, (a6, dict(kw6, out=(ls, None), gate=full,
                                           want=1)))
    return cases


def slot_cases(dev):
    """K2's and K6's first-step inputs (:func:`score_terms_cases`' form) at
    50 brokers / 1 000 partitions and at replication factors 1 and 8 (the
    clusters of :func:`check_slot_instances`) → {case: (K2 args, (K6 args,
    kw))}."""
    from cruise_control_tpu_torch.models.generators import random_cluster

    out = {}
    for case, state in (
            ("50b_1k", random_cluster(seed=42, **SMALL)),
            *((f"rf{S}", random_cluster(
                seed=5, num_brokers=200, num_racks=20, num_partitions=4000,
                replication_factor=S)) for S in (1, 8))):
        calls, _ = first_step_calls(state, {}, dev)
        a2, _ = calls["grid_rescore"]
        out[case] = (a2[:6] + a2[7:], calls["score_candidates"])
    return out


def check_budget_accept(label, args, kw, has_cap, timed,
                        name="budget_accept"):
    """K4 against ``budget_accept_plain``, bit for bit → {name: record}."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    m = args[0]
    B = m.capacity.shape[0]
    Cn, NB = args[4].shape
    return {name: record_kernel(
        label, name, SK.budget_accept, SK.budget_accept_plain, args, kw,
        {"percentile_cload": has_cap, "C": Cn, "B": B, "NB": NB,
         "distinct_dst": int(torch.unique(args[2]).numel()),
         "distinct_src": int(torch.unique(args[3]).numel())},
        # each input once: the broker tables, the C rows' ids, vectors and
        # flags; the flags and the two [B, NB] budget tables out
        B * (4 * 4 * (3 if has_cap else 2) + 10) + Cn * (13 + 4 * NB)
        + Cn + 2 * B * NB * 4,
        # the budgets' column sums and tests; per round two prefix tests
        # and the draw-down, ~11 operations a row and dim each
        B * (12 * 3 + 40) + 2 * (2 * 4 + 3) * Cn * NB,
        timed=timed, exact=True)}


def cohort_cases(calls, dev, seed=23):
    """K4's first-step cohort (``calls["budget_accept"]``) made hard for
    its sorts: every row on one destination, every row on one source, its
    first 777 rows and its first row, and the same rows over 10 000
    brokers (the model's broker tables tiled ten times, the ids spread at
    random) → {case: (args, kw)}."""
    args, kw = calls["budget_accept"]
    m, ca, dst, src, vec, elig = args[:6]
    rest = args[6:]
    mode = lambda x: torch.mode(x.cpu()).values.item()  # noqa: E731
    cases = {
        "one_dst": (m, ca, torch.full_like(dst, mode(dst)), src, vec, elig),
        "one_src": (m, ca, dst, torch.full_like(src, mode(src)), vec, elig),
        "c777": (m, ca, dst[:777], src[:777], vec[:777], elig[:777]),
        "c1": (m, ca, dst[:1], src[:1], vec[:1], elig[:1]),
    }
    tile = 10
    B = m.capacity.shape[0] * tile
    big = tile_brokers(m, tile)
    g = torch.Generator().manual_seed(seed)
    cases["b10k"] = (
        big, ca, torch.randint(0, B, dst.shape, generator=g).to(dst),
        torch.randint(0, B, src.shape, generator=g).to(src), vec, elig)
    return {c: (a + rest, kw) for c, a in cases.items()}


def compaction_cases(dev):
    """K7 on tie-rich keys (:func:`synthetic_compaction`): 5 000 keys (1 000
    brokers) kept to 1 024, 777 and 1, and 50 000 keys (10 000 brokers)
    kept to 1 024; a tie must straddle the C-th key → {case: args}."""
    out = {}
    for case, B, C in (("nrow_5k", 1000, 1024), ("nrow_5k_c777", 1000, 777),
                       ("nrow_5k_c1", 1000, 1), ("nrow_50k", 10_000, 1024)):
        args = synthetic_compaction(dev, B=B, C=C)
        key = torch.cat([args[1].reshape(-1), args[3][0]]).cpu()
        key = torch.where(key == 0, torch.zeros_like(key), key)
        kept = torch.sort(key).values
        if not bool(kept[C - 1] == kept[C]):
            raise AssertionError(f"K7 {case}: no tie straddles key {C}")
        out[case] = args
    return out


def check_per_src_top(label, args, kw, timed, has_cap=False,
                      name="per_src_top"):
    """K3 against ``per_src_top_plain`` on ``per_src_top_inputs_plain``'s
    rows, bit for bit, the fused inputs ``sb`` and ``row_best`` among the
    outputs → {name: record}."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    m, lp, lsl, ls, slot, src, vals, B, Q = args
    K, L = slot.shape[0], lp.shape[0]

    def run(*a, **k):
        bl, top, sb = SK.per_src_top(*a, **k)
        return [*bl, *top, sb]

    def row_best(*a, **k):
        rb = torch.empty(K, dtype=torch.float32, device=a[3].device)
        SK.per_src_top(*a, **k, row_best=rb)
        return [rb]

    def plain(m, lp, lsl, ls, slot, src, vals, B, Q, dest_terms=False):
        sb, rb = SK.per_src_top_inputs_plain(m, slot, src, vals, dest_terms)
        bl, top = SK.per_src_top_plain(m, lp, lsl, ls, sb, rb, B, Q)
        return [*bl, *top, sb], [rb]

    rec = record_kernel(
        label, name, run, lambda *a, **k: plain(*a, **k)[0], args, kw,
        {"percentile_cload": has_cap, "L": L, "K": K, "B": B, "Q": Q,
         "dest_terms": kw.get("dest_terms", False),
         "scratch_bytes": SK.per_src_top_scratch_bytes(K, L, B)},
        # each input once: a candidate's lp, score, leader slot and
        # leader's placement word; a row's 8-byte slot, placement word,
        # source term and top destination term, its broker out; a
        # broker's winner's lsl and destination word, its best transfer
        # out; the Q rows and scores out
        L * 16 + K * 24 + B * 24 + Q * B * 8,
        # a key a candidate and a row (~2 operations), a row's best score
        # (2), a broker's Q picks over its rows
        L * 2 + K * 4 + Q * K * 2, timed=timed, exact=True)
    # the rows' best scores, which the step's launch does not write out
    bitwise(f"{label} {name} row_best", row_best(*args, **kw),
            [SK.per_src_top_inputs_plain(m, slot, src, vals, **kw)[1]])
    return {name: rec}


def src_top_cases(args, kw, dev, seed=29):
    """K3's first-step call (``(m, lp, lsl, l_scores, slot, src_term,
    vals, B, Q)``, ``{"dest_terms": ...}``) made hard: its rows and
    candidates spread over 10 000, 20 000 and 45 000 brokers, every row
    on one source broker, every row and candidate scored +inf, Q = 1 and
    Q = 8, tie-rich scores of the incremental form (``dest_terms``) where
    -0.0 and +0.0 tie on one broker in either order, and two cases whose
    keys do not fit in shared memory: 1 024 rows and candidates over
    45 000 brokers, and the rows four times over → {case: (args, kw)}."""
    m, lp, lsl, ls, slot, src, vals, B, Q = args
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randint(0, 1 << 30, s, generator=g).to(dev)  # noqa: E731,E501
    cases = {}
    for tile in (10, 20, 45):
        a = m.assignment
        big = dataclasses.replace(
            m, assignment=torch.where(a >= 0, a + (rand(*a.shape) % tile)
                                      .to(a) * B, a),
            capacity=m.capacity.repeat(tile, 1))
        cases[f"b{tile}k"] = ((big, lp, lsl, ls, slot, src, vals, B * tile,
                               Q), kw)
    a = m.assignment.clone()
    hot = int(torch.mode(a.view(-1)[slot.long()].cpu()).values)
    a.view(-1)[slot.long()] = hot
    cases["one_src"] = ((dataclasses.replace(m, assignment=a), lp, lsl, ls,
                         slot, src, vals, B, Q), kw)
    inf = vals.clone()
    inf[:, 0] = float("inf")
    cases["all_inf"] = ((m, lp, lsl, torch.full_like(ls, float("inf")), slot,
                         src, inf, B, Q), kw)
    cases["q1"] = (args[:8] + (1,), kw)
    cases["q8"] = (args[:8] + (8,), kw)
    # past shared memory: 45 000 brokers with 1 024 rows and candidates (a
    # two-block launch: one leadership block of all 45 000 brokers), and
    # the rows four times over (32 768 rows)
    big = cases["b45k"][0][0]
    n = 1024
    cases["b45k_small"] = ((big, lp[:n], lsl[:n], ls[:n], slot[:n], src[:n],
                            vals[:n], B * 45, Q), kw)
    cases["k32k"] = ((m, lp, lsl, ls, slot.repeat(4), src.repeat(4),
                      vals.repeat(4, 1), B, Q), kw)
    # row scores src + dt in {-0.0, +0.0, ±1}: -0.0 only where both terms
    # are -0.0; the leadership scores in {-0.0, +0.0, 0.5}
    zero = torch.tensor([-0.0, 0.0], device=dev)
    zsrc = zero[rand(src.shape[0]) % 2]
    dt = vals.clone()
    dt[:, 0] = torch.tensor([-0.0, 0.0, -0.0, 1.0, -1.0], device=dev)[
        rand(vals.shape[0]) % 5]
    zls = torch.tensor([-0.0, 0.0, 0.5], device=dev)[rand(ls.shape[0]) % 3]
    best = zsrc + dt[:, 0]
    neg = (best == 0) & torch.signbit(best)
    if not bool(neg.any()) or not bool(((best == 0) & ~neg).any()):
        raise AssertionError("K3 zero_ties: the scores lack a -0.0 / +0.0 tie")
    cases["zero_ties"] = ((m, lp, lsl, zls, slot, zsrc, dt, B, Q),
                          {"dest_terms": True})
    return cases


def check_compact_rows(label, args, kw, has_cap, timed, name="compact_rows"):
    """K7 against ``_compact_rows``, bit for bit → {name: record}."""
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
        plain_kw={}, timed=timed, exact=True)}


def commit_plan(args):
    """What the plain twin of K8 commits from its arguments → (rows
    committed, distinct brokers they touch as source or destination)."""
    acc, take_d, ws_d, wd_d, cs, d0 = (x.cpu() for x in args[1:7])
    cand_src, M_step = args[10].cpu(), args[11]
    take = acc | take_d
    vals, order = torch.sort(torch.where(take, torch.where(
        acc, cs[:, 0], ws_d), float("inf")), stable=True)
    rows = order[:M_step][torch.isfinite(vals[:M_step])]
    dst = torch.where(acc, d0.long(), wd_d)
    touched = torch.cat([cand_src[rows], dst[rows]]).clamp_min(0)
    return int(rows.numel()), int(torch.unique(touched).numel())


def commit_bytes(args, has_cap, n_commit, touched, extra=0):
    """Bytes K8's function must move: every candidate row's 40 bytes, its
    partition's leader slot and load row (the excluded-load column aside:
    a row's gated contribution reaches the column maxima even when it is
    not committed, as a NaN times 0 would), every broker aggregate read
    (an untouched one changes only if it holds -0.0), the touched
    brokers' aggregates written, the M_step output rows, a commit's
    placement entry and mark, and the carry."""
    m = args[0]
    C, W = args[5].shape[0], m.pload.shape[1]
    B, NR = m.capacity.shape
    ncol = NR * (2 if has_cap else 1) + 4
    return (C * (40 + 4 + 4 * (W - 1)) + B * ncol * 4 + touched * ncol * 4
            + args[11] * 16 + n_commit * 6 + 16 * 4 * 2 + 4 * 4 + extra)


def commit_ops(args, has_cap, n_commit):
    """Operations of K8's function: a key a row, the sort of the committed
    keys, a row's gated contributions, a commit's ~12 operations a column,
    an add an aggregate."""
    m = args[0]
    C, B, NR = args[5].shape[0], *m.capacity.shape
    ncol = NR * (2 if has_cap else 1) + 4
    log_n = max(n_commit - 1, 1).bit_length()
    return (4 * C + n_commit * log_n * (log_n + 1) // 2 + C * 2 * ncol
            + n_commit * 12 * ncol + B * ncol)


def check_commit_batch(label, args, kw, has_cap, timed, name="commit_batch"):
    """K8 against ``commit_batch_plain``, bit for bit → {name: record}: the
    returned model, touched marks and count, the output rows written and
    the loop's carry advanced.  The carry is restored before every call (a
    small copy), so each timed call commits as the first did."""
    from cruise_control_tpu_torch.analyzer import commit_kernels as K89

    state0 = args[15].state.clone()

    def outs(fn):
        def run(*a, **k):
            a[15].state.copy_(state0)
            m, tpp, c_step = fn(*a, **k)
            return [*_model_fields(m), tpp, c_step, a[12], a[15].state,
                    a[15].counts]
        return run

    m = args[0]
    C = args[5].shape[0]
    n_commit, touched = commit_plan(args)
    return {name: record_kernel(
        label, name, outs(K89.commit_batch), outs(K89.commit_batch_plain),
        args, kw,
        {"percentile_cload": has_cap, "C": C, "M_step": args[11],
         "B": m.capacity.shape[0], "commits": n_commit,
         "touched_brokers": touched},
        commit_bytes(args, has_cap, n_commit, touched),
        commit_ops(args, has_cap, n_commit),
        plain_kw={}, timed=timed, exact=True)}


def commit_cases(calls, dev, seed=31):
    """K8's first-step call (``calls["commit_batch"]``) made hard: no row
    taken (every merged score +inf; some aggregates -0.0, which the zero
    sums turn into +0.0), every row committed up to M_step = C, tie-rich
    merged scores with -0.0 / +0.0 across the M_step-th, every taken row
    on one destination and on one source, and the rows over 10 000
    brokers (the model's broker tables tiled ten times, the rows' brokers
    spread at random) → {case: (args, kw)}.  The synthetic cases give the
    rows distinct partitions, as the step's disjoint batch has them."""
    args, kw = calls["commit_batch"]
    (m, acc, take_d, ws_d, wd_d, cs, d0, is_move, cand_p, cand_s, cand_src,
     M_step, out, tpp, improving, st) = args
    C = acc.shape[0]
    P = m.assignment.shape[0]
    B = m.capacity.shape[0]
    g = torch.Generator().manual_seed(seed)
    on = lambda x: x.to(dev)  # noqa: E731
    rand = lambda n, hi: on(torch.randint(0, hi, (n,), generator=g))  # noqa: E731,E501
    distinct_p = on(torch.randperm(P, generator=g)[:C]).to(cand_p)
    mode = lambda x: torch.mode(x.cpu()).values.item()  # noqa: E731

    def neg_zero(m):
        # a few brokers' aggregates -0.0 (an add of +0.0 makes them +0.0)
        m = copy.deepcopy(m)
        for f in ("broker_load", "leader_nwin", "pot_nwout", "rcount",
                  "lcount"):
            getattr(m, f)[B // 3::97] = -0.0
        return m

    def case(**over):
        a = dict(zip(("m", "acc", "take_d", "ws_d", "wd_d", "cs", "d0",
                      "is_move", "cand_p", "cand_s", "cand_src", "M_step",
                      "out", "tpp", "improving", "st"), args))
        a.update(over)
        return tuple(a.values()), kw

    none = torch.zeros_like(acc)
    cases = {"no_commit": case(m=neg_zero(m), acc=none, take_d=none)}
    # every row committed: the cohort takes all C rows with finite scores
    full = cs.clone()
    full[:, 0] = -1.0 - on(torch.rand(C, generator=g))
    wide = torch.full((4, max(out.shape[1], C)), -1.0, device=dev)
    cases["all_commit"] = case(
        acc=torch.ones_like(acc), cs=full, cand_p=distinct_p, M_step=C,
        out=wide, st=dataclasses.replace(st, slot_limit=wide.shape[1] - C))
    # tie-rich merged scores, -0.0 / +0.0 among them
    vals = on(torch.tensor([-0.0, 0.0, -1.0, -2.0]))
    tie = cs.clone()
    tie[:, 0] = vals[rand(C, 4)]
    t_acc = rand(C, 5) < 2
    t_take = (rand(C, 5) < 2) & ~t_acc
    cases["ties"] = case(m=neg_zero(m), acc=t_acc, take_d=t_take,
                         ws_d=vals[rand(C, 4)], cs=tie, cand_p=distinct_p)
    # every taken row on one destination, on one source
    taken = (acc | take_d).cpu()
    hot = mode(torch.where(acc, d0.long(), wd_d).cpu()[taken])
    cases["one_dst"] = case(d0=torch.full_like(d0, hot),
                            wd_d=torch.full_like(wd_d, hot))
    cases["one_src"] = case(cand_src=torch.full_like(
        cand_src, mode(cand_src.cpu()[taken])))
    # 10 000 brokers
    tile = 10
    big = tile_brokers(m, tile)
    cases["b10k"] = case(
        m=big, d0=(d0 + rand(C, tile).to(d0) * B),
        wd_d=wd_d + rand(C, tile).to(wd_d) * B,
        cand_src=cand_src + rand(C, tile).to(cand_src) * B)
    # the cases are what they say
    for name, (a, _) in cases.items():
        n, _ = commit_plan(a)
        if (name == "no_commit") != (n == 0) or (
                name == "all_commit" and n != C):
            raise AssertionError(f"K8 {name}: {n} commits")
    merged = torch.where(t_acc | t_take, torch.where(t_acc, tie[:, 0],
                                                     cases["ties"][0][3]),
                         float("inf")).cpu()
    ranked = torch.sort(merged).values
    if not bool(ranked[M_step - 1] == ranked[M_step]) \
            or not bool((merged == 0).any()):
        raise AssertionError("K8 ties: no tie straddles the M_step-th key")
    return cases


def match_forms(args, kw):
    """K5's first-step call in the step's three forms → [(name, args,
    kw)]: from the cohort's rows (as the step calls it), with
    destination and source caps of 2 (the ``track_bars`` branch), and
    from the occupancy tables the cohort's footprint gives."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    acc = kw["acc"]
    used = SK._cohort_footprint(acc, args[1], args[2], args[3], args[5],
                                args[6])
    masked = (args[0].masked_fill(acc[:, None], float("inf")),) + args[1:]
    return [("match_batch", args, kw),
            ("match_batch[track_bars]", args,
             dict(kw, dest_cap=2, src_cap=2)),
            ("match_batch[init_used]", masked,
             dict(kw, acc=None, init_used=used))]


def auction_rounds(args, kw):
    """The rounds after which the plain twin's auction stops changing its
    outputs (take, score, destination) → int."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    A = args[0].shape[1]
    last = kw.get("rounds") or A
    want = SK.match_batch_plain(*args, **kw)
    for r in range(1, last + 1):
        got = SK.match_batch_plain(*args, **dict(kw, rounds=r))
        if all(torch.equal(a, b) for a, b in zip(got, want)):
            return r
    return last


def check_match_batch(label, args, kw, has_cap, timed, name="match_batch"):
    """K5 against ``match_batch_plain``, bit for bit → {name: record}."""
    from cruise_control_tpu_torch.analyzer import step_kernels as SK

    N, A = args[0].shape
    B, P = args[5], args[6]
    acc = kw.get("acc")
    return {name: record_kernel(
        label, name, SK.match_batch, SK.match_batch_plain, args, kw,
        {"percentile_cload": has_cap, "N": N, "A": A, "B": B, "P": P,
         "cohort_rows": 0 if acc is None else int(acc.sum()),
         "dest_cap": kw.get("dest_cap", 1), "src_cap": kw.get("src_cap", 1),
         "rounds_to_fixed_outputs": auction_rounds(args, kw)},
        # the alternates, ids and cohort flags (or the three occupancy
        # tables) in; take, score, destination out
        N * A * 8 + N * 16 + (N if acc is not None else 2 * B + P) + N * 13,
        (kw.get("rounds") or A) * N * 20, timed=timed, exact=True)}


def match_cases(calls, dev, seed=37):
    """K5's first-step call (``calls["match_batch"]``) made hard: every
    score +inf, no cohort (every row bids), tie-rich scores with -0.0 /
    +0.0, every row on one destination and on one source, and the rows
    over 10 000 brokers (destinations and sources spread over ten copies
    of the brokers), with caps of 1 and of 2 (``track_bars``) →
    {case: (args, kw)}."""
    args, kw = calls["match_batch"]
    score, dst, src, rep, tol, B, P = args
    N, A = score.shape
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s, hi: torch.randint(0, hi, s, generator=g).to(dev)  # noqa: E731,E501
    mode = lambda x: torch.mode(x.reshape(-1).cpu()).values.item()  # noqa: E731,E501
    solo = dict(kw, acc=torch.zeros_like(kw["acc"]))
    vals = torch.tensor([-0.0, 0.0, -0.5, -1.0, -2.0], device=dev)
    cases = {
        "all_inf": ((torch.full_like(score, float("inf")),) + args[1:], kw),
        "no_cohort": (args, solo),
        "ties": ((vals[rand(N, A, hi=5)],) + args[1:], solo),
        "one_dst": ((score, torch.full_like(dst, mode(dst))) + args[2:],
                    solo),
        "one_src": ((score, dst, torch.full_like(src, mode(src)))
                    + args[3:], solo),
    }
    tile = 10
    big = (score, dst + rand(N, A, hi=tile).to(dst) * B,
           src + rand(N, hi=tile).to(src) * B, rep, tol, B * tile, P)
    cases["b10k"] = (big, kw)
    cases["b10k_track"] = (big, dict(kw, dest_cap=2, src_cap=2))
    return cases


def check_recompute_aggregates(label, m, has_cap, timed):
    """K9 against ``_recompute_aggregates``, bit for bit → the record, with
    its six launches' device times (``timed``), its gather pass's
    registers, spills and resident blocks, and index_add_ over the slots'
    load rows timed beside it."""
    from cruise_control_tpu_torch.analyzer import commit_kernels as K89
    from cruise_control_tpu_torch.ops import kernels

    P, S = m.assignment.shape
    B, NR = m.capacity.shape
    cols = ("broker_load", "leader_nwin", "pot_nwout", "rcount", "lcount",
            "broker_cload")

    def outs(fn):
        def run(mm):
            r = fn(mm)
            return [getattr(r, f) for f in cols if getattr(r, f) is not None]
        return run

    lib = kernels.load("recompute_aggregates")
    rec = record_kernel(
        label, "recompute_aggregates", outs(K89.recompute_aggregates),
        outs(K89._recompute_aggregates), (m,), {},
        {"percentile_cload": has_cap, "P": P, "S": S, "B": B,
         "top_broker_share": top_broker_share(m.assignment),
         "attrs": kernels.attrs("recompute_aggregates",
                                lib.recompute_aggregates_attrs)},
        # each input once: the placement and leader slots, the leader and
        # follower load rows (and capacity loads); six aggregates out
        P * S * 4 + P * 4 + P * NR * 4 * (4 if has_cap else 2)
        + B * (NR * (2 if has_cap else 1) + 4) * 4,
        # per slot: a column max and a fixed-point product and add a column
        P * S * (NR * (2 if has_cap else 1) + 2) * 3, timed=timed,
        tag="recompute_aggregates_", exact=True)
    if timed:
        rec["device_ms_by_phase"] = device_ms(
            lambda: K89.recompute_aggregates(m), "recompute_aggregates_",
            by_name=True)
    # yardstick: one index_add_ of the slots' load rows (float atomics)
    rows, ids = aggregate_slot_loads(m)
    rec["library_ms"] = cuda_ms(lambda: torch.zeros(
        (B + 1, NR), device=rows.device).index_add_(0, ids, rows))
    emit({"phase": "kernel_library", "case": label,
          "name": "recompute_aggregates", "library_ms": rec["library_ms"],
          "device_ms_by_phase": rec.get("device_ms_by_phase")})
    return rec


def aggregate_slot_loads(m):
    """Every slot's load row ``[P·S, R]`` and its broker (empty slots to a
    dump row B): the input of the one ``index_add_`` timed beside K9."""
    P, S = m.assignment.shape
    B, NR = m.capacity.shape
    ids = torch.where(m.assignment >= 0, m.assignment, B).reshape(-1).long()
    rows = torch.where(
        (torch.arange(S, device=m.assignment.device)[None, :]
         == m.leader_slot[:, None])[:, :, None],
        m.leader_load[:, None, :], m.follower_load[:, None, :]
    ).reshape(-1, NR).contiguous()
    return rows, ids


def top_broker_share(assignment) -> float:
    """The share of the existing replica slots that the busiest broker
    hosts."""
    a = assignment[assignment >= 0].long()
    return float(torch.bincount(a).max()) / max(1, a.numel())


def skew_placement(assignment, hot: int = 0):
    """The placement with broker ``hot`` put into the first slot of every
    partition that does not hold it, but one in four: it then hosts at
    least a quarter of the slots of a three-replica placement — the
    contention case of K9's and K12's per-broker sums."""
    P = assignment.shape[0]
    rows = ((torch.arange(P, device=assignment.device) % 4 != 0)
            & ~(assignment == hot).any(dim=1))
    a = assignment.clone()
    a[rows, 0] = hot
    return a


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


def synthetic_priority(dev, n=3_000_000, S=3, k=8192, seed=17):
    """K11's inputs at the north star's 3 M slots: a [P·S] priority drawn
    mostly from a few values (-inf, -0.0, +0.0 and repair bonuses: many
    ties at the k-th value), a fifth of it normal noise, and the repool
    flag set."""
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK
    from cruise_control_tpu_torch.analyzer import step_state as SS

    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.tensor([-float("inf"), -0.0, 0.0, 1.0, 2.5, 1e5, 1e6],
                        device=dev)
    x = vals[torch.randint(0, vals.numel(), (n,), generator=g, device=dev)]
    x = torch.where(torch.rand(n, generator=g, device=dev) < 0.2,
                    torch.randn(n, generator=g, device=dev), x).contiguous()
    state = torch.zeros(SS.NSTATE, dtype=torch.int32, device=dev)
    state[SS.REPOOL] = 1
    i32 = torch.int32
    return ((x, torch.empty(k, dtype=i32, device=dev),
             torch.empty(k, dtype=i32, device=dev),
             torch.empty(k, dtype=torch.int64, device=dev)),
            {"S": S, "state": state,
             "ws": torch.zeros(PK.top_select_words(k, n), dtype=i32,
                               device=dev)})


def repool_census(state, dev):
    """The device kernels one repool launches (a forced repool on the
    uploaded mid-scale model, under torch.profiler): K10's one and K11's
    three, and no other → the emitted record."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C

    m, ca, pb, carry, _ = repool_args(state, dev)
    first = carry.clone()
    torch.cuda.synchronize()
    # K10 launches on every call, so a window with no CUDA event at all is
    # the profiler's miss, not the repool's: take the window again (once
    # seen on the card after phase 3's other checks, never when repeated)
    for attempt in range(1, 4):
        carry.copy_(first)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            C._repool(m, ca, pb, carry, -1)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    ours = [n for n in names if "pool_tables_" in n or "top_select" in n]
    rec = {"phase": "repool_census", "kernels": len(names),
           "hand_kernels": len(ours), "names": sorted(set(names)),
           "profiler_windows": attempt}
    emit(rec)
    if len(names) != 4 or len(ours) != 4:
        raise AssertionError(f"a repool launched {names}, not K10's one "
                             "and K11's three kernels")
    return rec


def compare_scan_paths(state, dev, cfg_kw=None, phase="scan_paths"):
    """One scan call at ``state``'s first step, stepped eagerly (masked
    steps, chunk by chunk) and through captured chunks — a fresh capture,
    then a replay-only call on the same loop: identical ScanResults, host
    reads within ceil(steps / chunk) + 1 → the emitted record.  ``cfg_kw``
    configures the search (the default path when None)."""
    import math

    import numpy as np

    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.ops.grid import grid_consts

    opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(**(cfg_kw or {})),
                              device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    cfg = C._resolve_batch(opt.config, ctx.num_brokers)
    T = cfg.steps_per_call
    consts = grid_consts(cfg, ca, dev)
    loop = C._StepLoop(m, cfg, ca, consts, K, D, T)
    runs = {}
    for name, kw in (("eager", {"capture": False}),
                     ("captured", {"loop": loop}),
                     ("replayed", {"loop": loop})):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res, _, _ = C._scan_call(m, cfg, ca, consts, K, D, T,
                                 C._cold_tables(m), **kw)
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t)
    ref = runs["eager"][0]
    for name in ("captured", "replayed"):
        res = runs[name][0]
        for f in ("kind", "p", "s", "d", "step_counts"):
            if not np.array_equal(getattr(res, f), getattr(ref, f)):
                raise AssertionError(f"{name} scan call: {f} differs from "
                                     "the eager masked steps")
        for f in ("steps_run", "n_incremental_repool", "repools",
                  "n_overflow", "patch_steps"):
            if res.diag[f] != ref.diag[f] or res.done != ref.done:
                raise AssertionError(f"{name} scan call: {f} differs")
    steps = ref.diag["steps_run"]
    limit = math.ceil(steps / C.STEP_CHUNK) + 1
    rec = {"phase": phase, "steps": steps, "actions": len(ref.kind),
           "n_overflow": ref.diag["n_overflow"],
           "patch_steps": ref.diag["patch_steps"],
           "done": ref.done, "repools": ref.diag["repools"],
           "incremental_repools": ref.diag["n_incremental_repool"],
           "chunk": C.STEP_CHUNK, "host_sync_limit": limit,
           **{f"{n}_s": t for n, (_, t) in runs.items()},
           **{f"{n}_host_syncs": r.diag["host_syncs"]
              for n, (r, _) in runs.items()},
           **{f"{n}_graph_replays": r.diag["graph_replays"]
              for n, (r, _) in runs.items()}}
    emit(rec)
    for name in ("captured", "replayed"):
        if runs[name][0].diag["host_syncs"] > limit:
            raise AssertionError(f"{name} scan call read the card "
                                 f"{runs[name][0].diag['host_syncs']} times "
                                 f"(limit {limit})")
    return rec


def loop_counts(summ):
    """Host reads a scan call and graph replays of a plan's search."""
    return {"host_syncs": summ["host_syncs"],
            "host_syncs_per_call": summ["host_syncs"] / summ["rounds"],
            "graph_replays": summ["graph_replays"],
            "repools": summ["repools"]}


def check_loop_counts(label, summ):
    """Every scan call reads the card at most ceil(steps / chunk) + 1
    times, so a plan at most steps / chunk + 2 · calls times."""
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import STEP_CHUNK

    limit = summ["steps"] / STEP_CHUNK + 2 * summ["rounds"]
    if summ["host_syncs"] > limit or summ["graph_replays"] <= 0 \
            or summ["repools"] <= 0:
        raise AssertionError(f"{label}: {summ['host_syncs']} host reads "
                             f"(limit {limit}), {summ['graph_replays']} "
                             f"graph replays, {summ['repools']} repools")


def acting_launches(launches, summ):
    """Launches that did work, from the device carry: K8 commits only on
    an active step, K10 acts once a repool and K11 three times; the other
    kernels run in full at every launch (a masked tail step included)."""
    return {**launches, "commit_batch": summ["steps"],
            "pool_tables": summ["repools"],
            "top_select": 3 * summ["repools"]}


def run_plan(opt, state):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = opt.optimize(state)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def actions_of(res):
    return [(int(a.action_type), a.partition, a.slot, a.source_broker,
             a.dest_broker, a.dest_slot) for a in res.actions]


def whatif_north_star(dev, N=WHATIF_FUTURES, racks=100, seed=19):
    """K12's inputs at the north star's scale: :func:`north_star_placement`
    (10 000 brokers, 1 000 000 partitions, 3 M slots), capacities drawn
    around a mean utilization of ~0.35, 100 racks, the last 20 brokers dead,
    and N futures: rack losses, single-broker losses, traffic multipliers
    ×1.05 … and hot partitions (1 % of them ×3)."""
    m = north_star_placement(dev)
    P, S = m.assignment.shape
    B = m.capacity.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    # a broker hosts ~P·S / B = 300 slots, ~100 leaders (mean load 2.5)
    # and ~200 followers (1.25): ~500 a resource
    cap = (500.0 / 0.35) * (0.8 + 0.4 * torch.rand(
        (B, 4), generator=g, device=dev))
    rack = (torch.arange(B, device=dev) % racks).to(torch.int32)
    alive0 = torch.ones(B, dtype=torch.bool, device=dev)
    alive0[-20:] = False
    dead = torch.zeros((N, B), dtype=torch.bool, device=dev)
    scale = torch.ones((N, P), device=dev)
    q = N // 4
    for i in range(N):
        if i < q:
            dead[i] = rack == i % racks
        elif i < 2 * q:
            dead[i, (i * 211) % B] = True
        elif i < 3 * q:
            scale[i] = 1.0 + 0.05 * (i - 2 * q + 1)
        else:
            hot = torch.rand(P, generator=g, device=dev) < 0.01
            scale[i, hot] = 3.0
    return (m.assignment, m.leader_slot, m.leader_load.contiguous(),
            m.follower_load.contiguous(), cap.contiguous(), rack, alive0,
            dead, scale)


def whatif_slot_loads(args):
    """Every future's slot loads ``[N·P·S, R]`` and their segment ids into
    ``[N·(B+1)]`` (dead and empty slots to each future's dump row B): the
    input of the one ``index_add_`` timed beside K12."""
    a, ls, ll, fl, cap, _, alive0, dead, scale = args
    N, P = scale.shape
    S = a.shape[1]
    B, R = cap.shape
    dev = a.device
    mask = torch.tensor((1.0, 1.0, 1.0, 0.0), device=dev)
    lscale = 1.0 + (scale[:, :, None] - 1.0) * mask
    is_lead = torch.arange(S, device=dev)[None, :] == ls[:, None]
    rows = torch.where(is_lead[None, :, :, None],
                       (ll[None] * lscale)[:, :, None],
                       (fl[None] * lscale)[:, :, None])
    rows = (rows * (a >= 0)[None, :, :, None]).reshape(-1, R).contiguous()
    alive = alive0[None, :] & ~dead
    bid = a.clamp_min(0).long().reshape(-1)
    ok = (a >= 0).reshape(-1)[None, :] & alive[:, bid]
    ids = torch.where(ok, bid[None, :], B) \
        + (B + 1) * torch.arange(N, device=dev)[:, None]
    return rows, ids.reshape(-1)


def check_whatif_verdict(label, args, plain_reps=10, library=True):
    """K12 against ``verdict_plain`` on the card, bit for bit on all 13
    outputs (floats compared by their bits) → the emitted record, with
    both times, K12's device time, the bound and one ``index_add_`` of the
    slot loads beside it."""
    from cruise_control_tpu_torch.ops import kernels
    from cruise_control_tpu_torch.whatif import verdict_kernels as VK

    got = VK.whatif_verdict(*args)
    torch.cuda.synchronize()
    want = VK.verdict_plain(*args)
    err = 0.0
    for k in VK.KEYS:
        a, b = got[k].cpu(), want[k].cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label} whatif_verdict {k}: {a.dtype} "
                                 f"{tuple(a.shape)} vs plain {b.dtype} "
                                 f"{tuple(b.shape)}")
        if a.is_floating_point():
            err = max(err, float((a - b).abs().max()))
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{label} whatif_verdict: {k} differs from "
                                 f"the plain twin in {int((a != b).sum())} "
                                 "entries")
    a, dead, scale = args[0], args[7], args[8]
    N, P = scale.shape
    S = a.shape[1]
    B, R = args[4].shape
    fn = lambda: VK.whatif_verdict(*args)  # noqa: E731
    phases = device_ms(fn, "whatif_verdict_", by_name=True)
    lib = kernels.load("whatif_verdict")
    rec = {
        "phase": "kernel", "case": label, "name": "whatif_verdict",
        "N": N, "P": P, "S": S, "B": B,
        "attrs": {name: kernels.attrs("whatif_verdict",
                                      lib.whatif_verdict_attrs, i, B)
                  for i, name in enumerate(VERDICT_PHASES)},
        "top_broker_share": top_broker_share(a),
        "dead_base": int((~args[6]).sum()),
        "offline_slots": int(want["movesRequired"].sum()),
        "survivable": int(want["survivable"].sum()),
        "max_abs_err": err, "ms": cuda_ms(fn),
        "device_ms": sum(phases.values()) if phases else None,
        "device_ms_by_phase": phases,
        "plain_ms": cuda_ms(lambda: VK.verdict_plain(*args), reps=plain_reps,
                            warmup=1),
        # each input once: the placement, leader slots and two load rows
        # a partition; capacity, rack and liveness a broker; each future's
        # dead row and multipliers; 82 bytes of verdict a future out.
        # Operations a future: ~20 a partition (its rated load rows) and
        # ~16 a slot (select and mask its row, add it to its broker's and
        # the total, compare)
        **bound(P * S * 4 + P * 4 + 2 * P * R * 4 + B * (R * 4 + 5)
                + N * B + N * P * 4 + N * 82,
                N * (P * 5 * R + P * S * 4 * R)),
        "library_ms": None, "library_note": LIBRARY_NOTES["whatif_verdict"],
    }
    if library:
        rows, ids = whatif_slot_loads(args)
        rec["library_ms"] = cuda_ms(lambda: torch.zeros(
            (N * (B + 1), R), device=a.device).index_add_(0, ids, rows))
        del rows, ids
    emit(rec)
    return rec


def whatif_timing(label, state, n_futures, dev, against_cpu=False):
    """The batched call's parts at one size → the emitted record: the host
    compile of the futures, the upload of the multipliers, the whole
    ``evaluate_batch`` (best of 5) and K12's device time; with
    ``against_cpu`` the engine's raw verdicts on the card must equal its
    verdicts on the CPU (the plain twin), every key, bit for bit."""
    import numpy as np

    from cruise_control_tpu_torch.whatif import artifact as A
    from cruise_control_tpu_torch.whatif import verdict_kernels as VK
    from cruise_control_tpu_torch.whatif.compiler import compile_futures
    from cruise_control_tpu_torch.whatif.engine import (
        evaluate_batch,
        verdict_inputs,
        verdicts,
    )

    futures = A.artifact_futures(state, n_futures)
    compile_s = A._best_of(3, lambda: compile_futures(state, futures))
    batch = compile_futures(state, futures)
    raw = evaluate_batch(state, batch, device=dev)
    wall_s = A._best_of(5, lambda: evaluate_batch(state, batch, device=dev))
    args = verdict_inputs(state, batch, device=dev)
    rows = verdicts(batch, raw)
    rec = {"phase": "whatif_timing", "case": label,
           "futures": len(futures), "batch": batch.padded_size,
           "compile_futures_s": compile_s, "evaluate_batch_s": wall_s,
           "h2d_scale_ms": cuda_ms(
               lambda: torch.from_numpy(batch.scale).to(dev)),
           "h2d_scale_bytes": batch.scale.nbytes,
           "k12_device_ms": device_ms(lambda: VK.whatif_verdict(*args),
                                      "whatif_verdict_"),
           "survivable": sum(v["survivable"] for v in rows),
           "goal_violations": sum(v["goalViolations"] for v in rows)}
    if against_cpu:
        cpu = evaluate_batch(state, batch, device="cpu")
        for k, v in raw.items():
            w = cpu[k]
            same = (v.dtype == w.dtype and v.shape == w.shape
                    and np.array_equal(v.view(np.uint8), w.view(np.uint8)))
            if not same:
                raise AssertionError(f"{label}: evaluate_batch {k} on the "
                                     "card differs from the CPU")
        rec["equal_to_cpu"] = True
    for v in rows:
        if not (np.isfinite(v["dataMoveMB"])
                and np.isfinite(v["maxBrokerUtilization"])):
            raise AssertionError(f"{label}: non-finite verdict {v}")
    emit(rec)
    return rec


def whatif_path(label, kw, dev):
    """The what-if path end to end, as the artifact runs it: the batched
    sweep of ``WHATIF_FUTURES`` futures (``whatif.artifact.measure_batch``:
    compile, one ``evaluate_batch`` a sweep, verdicts) timed against one
    plan search on the same model.  Every kernel counter is zeroed just
    before and read just after → (record, launches)."""
    from cruise_control_tpu_torch.whatif import artifact as A

    calls = [0]
    real = A.evaluate_batch

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    for fn in counters().values():
        fn.launches = 0
    A.evaluate_batch = counted
    try:
        rec = A.measure_batch(num_futures=WHATIF_FUTURES, best_of=3,
                              device=dev, **kw)
    finally:
        A.evaluate_batch = real
    launches = {n: fn.launches for n, fn in counters().items()}
    per_call = launches["whatif_verdict"] / calls[0]
    out = {"phase": f"whatif_{label}", **rec,
           "evaluate_batch_calls": calls[0],
           "k12_launches_per_evaluate_batch": per_call,
           "launches": {n: launches[n] for n in PATHS["whatif"]}}
    emit(out)
    gates = {"singleDispatch": rec["numDispatches"] == 1 and per_call == 1,
             "atLeast64Futures": rec["numFutures"] >= WHATIF_FUTURES,
             "batchRatioUnder2x": rec["ratio"] < 2.0}
    if not all(gates.values()):
        raise AssertionError(f"what-if {label}: batch gates {gates}")
    return out, launches


def whatif_phase(dev):
    """Phase 7 → (K12's records by case, the what-if path's launches)."""
    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.whatif import artifact as A
    from cruise_control_tpu_torch.whatif.compiler import compile_futures
    from cruise_control_tpu_torch.whatif.engine import verdict_inputs
    from cruise_control_tpu_torch.whatif.futures import (
        FutureSpec,
        broker_loss,
        rack_loss,
        traffic_scale,
    )

    small = random_cluster(seed=42, **SMALL)
    mid = random_cluster(**MIDSCALE)
    ragged = random_cluster(seed=5, num_brokers=77, num_racks=7,
                            num_partitions=3001, dead_brokers=3)
    ragged_futures = [
        FutureSpec(name="b10", events=(broker_loss(10),)),
        FutureSpec(name="r2", events=(rack_loss(2),)),
        FutureSpec(name="x1.5", events=(traffic_scale(1.5),))]
    recs = {}
    for label, state, futures in (
            ("50b_1k_x64", small, A.artifact_futures(small, WHATIF_FUTURES)),
            ("midscale_x64", mid, A.artifact_futures(mid, WHATIF_FUTURES)),
            ("midscale_x256", mid,
             A.artifact_futures(mid, WHATIF_MAX_FUTURES)),
            ("ragged", ragged, ragged_futures)):
        args = verdict_inputs(state, compile_futures(state, futures),
                              device=dev)
        recs[label] = check_whatif_verdict(label, args)
    if recs["ragged"]["N"] != 8 or recs["ragged"]["dead_base"] != 3:
        raise AssertionError(f"ragged what-if case is not ragged: "
                             f"{recs['ragged']}")
    # the contention cases: one broker hosting over a quarter of the slots,
    # alive in every future, then dead in every other future
    margs = verdict_inputs(mid, compile_futures(
        mid, A.artifact_futures(mid, WHATIF_FUTURES)), device=dev)
    hot = skew_placement(margs[0])
    dead = margs[7].clone()
    dead[:, 0] = False
    skew = (hot,) + margs[1:7] + (dead,) + margs[8:]
    recs["skew_x64"] = check_whatif_verdict("skew_x64", skew)
    dead = dead.clone()
    dead[::2, 0] = True
    recs["skew_dead_x64"] = check_whatif_verdict(
        "skew_dead_x64", skew[:7] + (dead,) + skew[8:])
    for c in ("skew_x64", "skew_dead_x64"):
        if recs[c]["top_broker_share"] < 0.25:
            raise AssertionError(f"{c}: the hot broker hosts "
                                 f"{recs[c]['top_broker_share']:.3f} of the "
                                 "slots, under a quarter")
    del margs, skew, hot, dead
    recs["north_star_x64"] = check_whatif_verdict(
        "north_star_x64", whatif_north_star(dev), plain_reps=2)
    whatif_timing("50b_1k_x64", small, WHATIF_FUTURES, dev, against_cpu=True)
    whatif_timing("midscale_x64", mid, WHATIF_FUTURES, dev)
    whatif_timing("midscale_x256", mid, WHATIF_MAX_FUTURES, dev)
    whatif_path("50b_1k", dict(seed=42, **SMALL), dev)
    # the what-if path read for launches: the sweep at 1 000 / 20 000
    # (measure_batch's generator runs at its default mean utilization,
    # 0.35, MIDSCALE's)
    mkw = {k: v for k, v in MIDSCALE.items() if k != "mean_utilization"}
    _, launches = whatif_path("1000b_20k", mkw, dev)
    for name in PATHS["whatif"]:
        if launches[name] <= 0:
            raise AssertionError(f"what-if path never launched {name}")
    return recs, launches


# ---- phase 8: the search's off-default paths -------------------------------

def round_inputs(state, cfg_kw, dev):
    """The first score-only round's inputs at ``state``, made as the search
    makes them (``cuda_optimizer._round_scores``): a full repool, then the
    grid form's scores (``_grid_round_scores``: K2/K1 + K6), on the model
    and constants the search uploads → the round's inputs and ``forms``:
    {form: (key_args, layout, pools)}, ``key_args`` the arguments of what
    makes the form's flat key — K13 (a)'s (K1's [K, R] and K6's [L]
    scores), K14's (the model, pools and constants)."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.ops.grid import grid_consts, terms_consts

    opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(**cfg_kw), device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    cfg = opt.config
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    consts, tconsts = grid_consts(cfg, ca, dev), terms_consts(cfg, ca, dev)
    pools = C._build_pools(m, cfg, ca, K, D)
    kp, ks, dp, lp, lsl = pools
    vals, ls, best_i = C._grid_round_scores(m, cfg, ca, pools, consts,
                                            tconsts)
    forms = {"grid": ((vals, ls), {"best_i": best_i, "lp": lp, "lsl": lsl},
                      pools),
             "columnar": ((m, cfg, ca, kp, ks, dp, consts, tconsts),
                          {"S": m.assignment.shape[1]}, pools)}
    torch.cuda.synchronize()
    return dict(m=m, cfg=cfg, ca=ca, K=K, D=D, consts=consts,
                tconsts=tconsts, forms=forms)


#: ~f32 operations of one fused broker cost (csrc/broker_cost.cuh: about
#: 13 a resource, then the count, leadership and network terms)
BROKER_COST_OPS = 85


def score_columnar_ops(scores, K, D, B, S, NR, has_cap):
    """The least f32 operations of K14's function on this run's data.  A
    move cell's source costs depend only on its pool row and its
    destination's old cost only on the broker, so each is counted once (a
    row's new source cost, every broker's old cost); every move cell needs
    its feasibility (the capacity test, 2·NR, the rack and duplicate scan,
    3·S, ~8 flags), a feasible one also the destination's new cost and the
    delta's sums; a leadership transfer needs ~12 operations of
    feasibility, a feasible one its two new costs and ~30 more; every
    candidate's score is negated into the key."""
    n_mv = K * D
    feas_mv = int(torch.isfinite(scores[:n_mv]).sum())
    feas_ld = int(torch.isfinite(scores[n_mv:]).sum())
    return (n_mv * (2 * NR + 3 * S + 8)
            + feas_mv * (BROKER_COST_OPS + (NR if has_cap else 0) + 2)
            + K * (BROKER_COST_OPS + 30) + B * BROKER_COST_OPS
            + (scores.shape[0] - n_mv) * 12
            + feas_ld * (2 * BROKER_COST_OPS + 30)
            + scores.shape[0]), feas_mv, feas_ld


def check_round_kernels(label, r, timed, whole=True):
    """The flat key, K11 on it and K13 (b) after it, in each form of
    ``r["forms"]``, each against its plain twins bit for bit → {name:
    record}: the grid form's key from K13 (a), the columnar form's from
    K14, which negates each score as it stores it (held to
    ``round_keys_plain(score_columnar_plain(...))``, -score bit for bit);
    with ``whole`` the search's round (``_round``) equals ``round_plain``
    bit for bit in both forms.  K13 (a) is timed beside
    ``torch.neg(torch.cat(...))`` (its library yardstick, two calls), K13
    (b) beside ``torch.topk`` of the key."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer import round_kernels as RK
    from cruise_control_tpu_torch.analyzer import pool_kernels as PK

    m, cfg, ca = r["m"], r["cfg"], r["ca"]
    K, D = r["K"], r["D"]
    P, S = m.assignment.shape
    B, NR = m.capacity.shape
    W = m.pload.shape[1]
    has_cap = m.broker_cload is not None
    one = lambda f: lambda *a, **k: [f(*a, **k)]  # noqa: E731
    recs = {}
    for form, (key_args, layout, pools) in r["forms"].items():
        sfx = "" if form == "grid" else "[columnar]"
        kp, ks, dp = pools[:3]
        if form == "columnar":
            key = RK.score_columnar(*key_args)
            N = key.shape[0]
            ops, feas_mv, feas_ld = score_columnar_ops(key, K, D, B, S, NR,
                                                       has_cap)
            # K14: each input once — the pools, every partition's row
            # (slots, origins, must-move flags, leader slot, load row), the
            # broker tables, the constants — and the N keys out
            recs["score_columnar"] = record_kernel(
                label, "score_columnar", one(RK.score_columnar),
                lambda *a: [RK.round_keys_plain(
                    RK.score_columnar_plain(*a[:6]))],
                key_args, {},
                {"percentile_cload": has_cap, "K": K, "D": D, "P": P,
                 "S": S, "N": N, "feasible_moves": feas_mv,
                 "feasible_transfers": feas_ld, "writes": "the flat key"},
                K * 8 + D * 4 + P * (9 * S + 4 + 4 * W)
                + B * (4 * (NR * (3 if has_cap else 2) + 4) + 6) + 4 * 28
                + N * 4, ops,
                plain_kw={}, timed=timed, exact=True)
        else:
            key = RK.round_keys(*key_args)
            N = key.shape[0]
            rec = record_kernel(
                label, "round_pack[keys]", one(RK.round_keys),
                one(RK.round_keys_plain), key_args, {},
                {"percentile_cload": has_cap, "N": N},
                # the scores read once, the key written once; a negation
                # each
                N * 8, N, timed=timed, tag="round_pack_keys_kernel",
                exact=True)
            vals, ls = key_args
            rec["library_two_calls_ms"] = cuda_ms(
                lambda: torch.neg(torch.cat((vals.reshape(-1), ls))))
            rec["library_note"] = ("the grid key is torch.cat then "
                                   "torch.neg, two calls "
                                   "(library_two_calls_ms)")
            emit({"phase": "kernel_library", "case": label,
                  "name": "round_pack[keys]",
                  **{k2: rec[k2] for k2 in ("library_two_calls_ms",
                                            "library_note")}})
            recs["round_pack[keys]"] = rec
        k = min(cfg.topk_per_round, N)
        sel = torch.empty(k, dtype=torch.int32, device=key.device)
        recs.update(check_top_select(label, f"top_select[round]{sfx}",
                                     (key, sel), {}, timed, has_cap))
        PK.top_select(key, sel)
        rec = record_kernel(
            label, f"round_pack{sfx}", one(RK.round_pack),
            one(RK.round_pack_plain), (key, sel, kp, ks, dp), layout,
            {"percentile_cload": has_cap, "N": N, "k": k},
            # the k selected indices and their keys, ~4 ids each (pool
            # row, slot, destination, leadership entry) read once; the
            # packed [5, k] out; ~10 operations each
            k * (4 + 4 + 16) + 5 * k * 4, 10 * k, timed=timed,
            tag="round_pack_kernel", exact=True)
        rec["library_ms"] = cuda_ms(lambda: torch.topk(key, k))
        emit({"phase": "kernel_library", "case": label,
              "name": f"round_pack{sfx}", "library_ms": rec["library_ms"]})
        recs[f"round_pack{sfx}"] = rec
    if whole:
        for scoring in ("grid", "columnar"):
            c = dataclasses.replace(cfg, scoring=scoring)
            got = C._round(m, c, ca, K, D, r["consts"], r["tconsts"])
            torch.cuda.synchronize()
            bitwise(f"{label} round ({scoring})", got,
                    RK.round_plain(m, c, ca, K, D, scoring))
        emit({"phase": "round_whole", "case": label,
              "equal_to_round_plain": ["grid", "columnar"]})
    return recs


def check_corrected(label, state, cfg_kw, dev, timed):
    """K15 against ``_corrected_accept`` on the compacted rows of the
    first step of a corrected-cohort search, bit for bit → the record."""
    from cruise_control_tpu_torch.analyzer import corrected_kernel as K15

    calls, has_cap = first_step_calls(
        state, {"cohort_mode": "corrected", **cfg_kw}, dev)
    args, kw = calls["corrected_accept"]
    m, cfg = args[0], args[1]
    Cn, NB = args[7].shape
    S = m.assignment.shape[1]
    NR = m.capacity.shape[1]
    qual = args[8]
    log_c = max(Cn - 1, 1).bit_length()
    name = "corrected_accept" + ("" if cfg.cohort_stack_tol >= 1.0
                                 else "[stack_tol]")
    rec = record_kernel(
        label, name, lambda *a, **k: [K15.corrected_accept(*a, **k)],
        lambda *a, **k: [K15._corrected_accept(*a, **k)], args, kw,
        {"percentile_cload": has_cap, "C": Cn, "NB": NB,
         "qualified": int(qual.sum()),
         "stack_tol": cfg.cohort_stack_tol},
        # each input once: a row's ids, move vector, flags and snapshot
        # score, its partition's slots and must-move flags and their
        # racks, its two brokers' tables; the accept flags out
        Cn * (4 * NB + 25 + S * 9 + 2 * (4 * (NR * (3 if has_cap else 2)
                                              + 4) + 4)) + Cn,
        # two sorts of C keys, two scans of C·NB, four broker costs (~85
        # operations each) and ~60 more a row
        2 * Cn * log_c * (log_c + 1) // 2 + 2 * 4 * Cn * NB + Cn * 400,
        plain_kw={"snap_score": kw["snap_score"]}, timed=timed,
        exact=True)
    if timed:
        rec["attrs"] = K15.corrected_accept_attrs(
            Cn, NB, m.capacity.shape[0])
    return {name: rec}


def corrected_cases(state, cfg_kw, dev, seed=23):
    """K15's first-step rows of a corrected-cohort search on ``state``
    made hard as :func:`cohort_cases` makes K4's: every row on one
    destination, every row on one source, the first 777 rows and the
    first row, and the same rows over 10 000 brokers (the broker tables
    tiled ten times, the ids spread at random); and the rows repeated 64
    times over the brokers tiled 66 times, so the keys and prefixes leave
    shared memory for the device scratch, the scan runs in chunks and
    the ids (over 2^16) no longer fit a 32-bit key beside the rows' 16
    bits → {case: (args, kw)}."""
    calls, _ = first_step_calls(
        state, {"cohort_mode": "corrected", **cfg_kw}, dev)
    args, kw = calls["corrected_accept"]
    m, cfg, ca, cp, cs_, src, d0, vec, qual, tol = args
    mode = lambda x: torch.mode(x.cpu()).values.item()  # noqa: E731

    def cut(n):
        return ((m, cfg, ca, cp[:n], cs_[:n], src[:n], d0[:n], vec[:n],
                 qual[:n], tol), dict(kw, snap_score=kw["snap_score"][:n]))
    cases = {
        "one_dst": ((m, cfg, ca, cp, cs_, src,
                     torch.full_like(d0, mode(d0)), vec, qual, tol), kw),
        "one_src": ((m, cfg, ca, cp, cs_, torch.full_like(src, mode(src)),
                     d0, vec, qual, tol), kw),
        "c777": cut(777), "c1": cut(1)}
    tile = 10
    B = m.capacity.shape[0] * tile
    g = torch.Generator().manual_seed(seed)
    cases["b10k"] = ((tile_brokers(m, tile), cfg, ca, cp, cs_,
                      torch.randint(0, B, src.shape, generator=g).to(src),
                      torch.randint(0, B, d0.shape, generator=g).to(d0),
                      vec, qual, tol), kw)
    reps, tile = 64, 66
    B = m.capacity.shape[0] * tile
    r = lambda x: x.repeat(reps, *([1] * (x.dim() - 1)))  # noqa: E731
    n = d0.shape[0] * reps
    cases["c64k_wide"] = (
        (tile_brokers(m, tile), cfg, ca, r(cp), r(cs_),
         torch.randint(0, B, (n,), generator=g).to(src),
         torch.randint(0, B, (n,), generator=g).to(d0), r(vec), r(qual),
         tol), dict(kw, snap_score=r(kw["snap_score"])))
    return cases


def check_corrected_case(label, args, kw):
    """K15 against ``_corrected_accept`` on one of :func:`corrected_cases`,
    bit for bit → {name: record}."""
    from cruise_control_tpu_torch.analyzer import corrected_kernel as K15

    got = K15.corrected_accept(*args, **kw)
    torch.cuda.synchronize()
    want = K15._corrected_accept(*args, snap_score=kw["snap_score"])
    name = f"corrected_accept[{label}]"
    bitwise(name, got, want)
    rec = {"phase": "kernel_case", "case": label, "name": name,
           "max_abs_err": 0.0, "bit_equal": True, "C": args[7].shape[0],
           "NB": args[7].shape[1], "B": args[0].capacity.shape[0],
           "qualified": int(args[8].sum()), "accepted": int(want.sum()),
           "distinct_dst": int(torch.unique(args[6]).numel()),
           "distinct_src": int(torch.unique(args[5]).numel())}
    emit(rec)
    return {name: rec}


def north_star_round(dev, seed=13):
    """K14's and K11's inputs at the north star's shapes: a seeded
    10 000-broker, 100-rack, 1 000 000-partition cluster's first round at
    the engine's widths, K·D + P·S = 8 192·1 024 + 3 000 000 candidates."""
    return round_inputs(north_star_state(seed), {}, dev)


def search_path_plan(label, path, opt, state, bar):
    """One off-default path's plan, twice (the first captures what it
    captures); every kernel counter is zeroed just before the second and
    read just after → the emitted record.  Both runs must give identical
    actions, verify and score within ``bar``; every kernel of ``path``
    must have launched, and K13's first entry point (``round_keys``) as
    often as its second in the grid form, never in the columnar form
    (K14 makes that key)."""
    from cruise_control_tpu_torch.analyzer import round_kernels as RK
    from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
    from cruise_control_tpu_torch.analyzer.verifier import (
        verify_result,
        violation_score,
    )

    goals = make_goals()
    r0, s0 = run_plan(opt, state)
    for fn in list(counters().values()) + [RK.round_keys]:
        fn.launches = 0
    r, s = run_plan(opt, state)
    launches = {n: fn.launches for n, fn in counters().items()}
    verify_result(state, r, goals)
    score = violation_score(r.final_state, goals)
    rec = {"phase": f"path_{label}", "path": path, "wallclock_s": s,
           "wallclock_s_first": s0, "violation_score": score,
           "score_bar": bar, "actions": len(r.actions),
           "identical_reruns": actions_of(r0) == actions_of(r),
           "passes": [{k: v for k, v in p.items()
                       if k in ("goal", "rounds", "steps", "accepted",
                                "timing_s", "n_overflow", "patch_steps",
                                "capped_calls")}
                      for p in r.goal_summaries],
           "launches": {n: launches[n] for n in PATHS[path]},
           "round_keys_launches": RK.round_keys.launches}
    emit(rec)
    if not rec["identical_reruns"]:
        raise AssertionError(f"{label}: two plans differ")
    if score > bar:
        raise AssertionError(f"{label}: score {score} > {bar}")
    for name in PATHS[path]:
        if launches[name] <= 0:
            raise AssertionError(f"{label} never launched {name}")
    want = 0 if path == "score_only_columnar" else launches["round_pack"]
    if RK.round_keys.launches != want:
        raise AssertionError(f"{label}: K13 (a) launched "
                             f"{RK.round_keys.launches} times, not {want} "
                             f"(K13 (b): {launches['round_pack']})")
    return rec, launches


# ---- phase 8, the incremental leg: K16, K17, the gated K1 / K6, the cap ---

def patch_step_calls(state, cfg_kw, dev, steps=16):
    """The arguments the first step of an incremental search that patches
    (FRESH = 0) hands K16, K17, the gated K1 (``grid_rescore_carry``), K6
    and K8 (with the marks) — copies taken at each call — from the
    engine's own step loop, stepped eagerly → ({name: [(args, kw), ...]},
    has_cap, step)."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer import step_state as SS
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.ops.grid import grid_consts

    opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(
        incremental_rescore=True, **cfg_kw), device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    names = ("stale_sets", "grid_patch", "grid_rescore_carry",
             "score_candidates", "commit_batch")
    saved = {n: getattr(C, n) for n in names}
    rec = {"step": 0, "calls": None, "patch": False, "done": False}

    def shim(n):
        def f(*a, **k):
            if rec["done"]:
                return saved[n](*a, **k)
            if n == "stale_sets":
                if rec["patch"]:
                    rec["done"] = True
                    return saved[n](*a, **k)
                rec["calls"] = {}
                rec["step"] += 1
            rec["calls"].setdefault(n, []).append(copy.deepcopy((a, k)))
            out = saved[n](*a, **k)
            if n == "stale_sets":
                st = a[7]
                rec["patch"] = (bool(int(st[SS.ACTIVE]))
                                and int(st[SS.FRESH]) == 0)
            return out
        return f

    try:
        for n in names:
            setattr(C, n, shim(n))
        cfg = C._resolve_batch(opt.config, ctx.num_brokers)
        C._scan_call(m, cfg, ca, grid_consts(cfg, ca, dev), K, D, steps,
                     C._cold_tables(m), capture=False)
    finally:
        for n in names:
            setattr(C, n, saved[n])
    if not rec["patch"]:
        raise AssertionError(f"no step of the first {steps} patched")
    return rec["calls"], m.broker_cload is not None, rec["step"]


def check_incremental_kernels(label, state, cfg_kw, dev, timed):
    """K16, K17 and K1 / K6 in their gated, carry-writing forms against
    their plain twins, bit for bit, on the first patching step's inputs →
    {name: record}.  The full-rescore forms run on the same step's inputs
    with the carry's FRESH flag set."""
    from cruise_control_tpu_torch.analyzer import commit_kernels as K89
    from cruise_control_tpu_torch.analyzer import rescore_kernels as RK
    from cruise_control_tpu_torch.analyzer import score_kernel as K6
    from cruise_control_tpu_torch.analyzer import step_state as SS
    from cruise_control_tpu_torch.ops import grid as G

    calls, has_cap, step = patch_step_calls(state, cfg_kw, dev)
    recs = {}
    (a16, kw16), = calls["stale_sets"]
    m, kp, dp, lp, lsl, tb, tpm, st, ridx, cidx, lidx, nstale, _ = a16
    P, S = m.assignment.shape
    B, NR = m.capacity.shape
    K, D, L = kp.shape[0], dp.shape[0], lp.shape[0]
    RB, CB, LB = ridx.shape[0], cidx.shape[0], lidx.shape[0]
    W = m.pload.shape[1]

    def after(fn, idx):
        def run(*a, **kw):
            fn(*a, **kw)
            return [a[i] for i in idx]
        return run

    counts = copy.deepcopy(a16)
    RK.stale_sets_plain(*counts)
    n_row, n_col, n_l = (int(x) for x in counts[11].cpu())
    base = {"percentile_cload": has_cap, "step": step, "K": K, "D": D,
            "L": L, "RB": RB, "CB": CB, "LB": LB, "stale_rows": n_row,
            "stale_cols": n_col, "stale_leads": n_l}
    recs["stale_sets"] = record_kernel(
        label, "stale_sets", after(RK.stale_sets, (7, 8, 9, 10, 11)),
        after(RK.stale_sets_plain, (7, 8, 9, 10, 11)), a16, kw16, base,
        # each input once: the pools (kp, dest_pool, lp, lsl), a leadership
        # entry's leader slot and two assignment words, the marks, the
        # carry; the three lists, counts and carry out
        K * 4 + D * 4 + L * 8 + L * 12 + B + P + 2 * 4 * SS.NSTATE
        + (RB + CB + LB + 3) * 4,
        # a test and a scan step an entry, twice (count, then compact)
        4 * (K + D + L), plain_kw={}, timed=timed, exact=True)

    (a17, kw17), = calls["grid_patch"]
    m17, cfg, ca, kp17, ks17, dp17, packed, cidx17, tb17, dt, bd, st17 = a17
    R = dt.shape[1]
    dp_c = torch.where(cidx17 >= 0, dp17[cidx17.clamp_min(0).long()], -1)
    g_c = G.move_grid_scores(m17, cfg, ca, kp17, ks17, dp_c.to(torch.int32))
    feas = int(torch.isfinite(g_c).sum())
    n_stale = int((cidx17 >= 0).sum())
    src_b = K * 4 * (G._SF + 3 * S + 2)
    recs["grid_patch"] = record_kernel(
        label, "grid_patch", after(RK.grid_patch, (9, 10)),
        after(RK.grid_patch_plain, (9, 10)), a17, kw17,
        dict(base, R=R, feasible_cells=feas, stale_columns=n_stale,
             attrs=RK.grid_patch_attrs(S, has_cap, CB)),
        # each input once: K2's source rows, the list and the destination
        # rows of its stale columns, the constants, the stored (dt, bd)
        # and the pool entries and marks they index; (dt, bd) out
        src_b + CB * 4 + n_stale * 4 * (G._DF + G._DI) + 4 * G._NC
        + 2 * K * R * 8 + D * 4 + B,
        # K1's count over the K · n_stale cells of the stale columns, one
        # test a -1 column, and a compare per merged entry
        G.grid_top_r_ops(K * n_stale, feas, S, n_stale) + (CB - n_stale)
        + 2 * K * (R + n_stale),
        plain_kw={}, timed=timed, exact=True)

    # K1 and K6 on the stale rows / entries (the patch's (b) and (c)), and
    # over the whole pool with the carry's FRESH flag set
    (a1, kw1) = calls["grid_rescore_carry"][1]
    (a6, kw6) = calls["score_candidates"][1]
    full1 = copy.deepcopy(calls["grid_rescore_carry"][0][0])
    full1[10][SS.FRESH] = 1
    rows1 = tuple(a1) + (kw1["rows"], kw1["n_rows"])
    n_r = min(RB, n_row)
    m1, kp1, ks1, dp1 = a1[0], a1[3], a1[4], a1[5]
    stale_k = kw1["rows"][:n_r].long()
    feas_r, feas_k = (int(torch.isfinite(G.move_grid_scores(
        m1, cfg, ca, kp_, ks_, dp1)).sum()) for kp_, ks_ in (
            (kp1[stale_k], ks1[stale_k]), (kp1, ks1)))
    for name, args, nrows, nfeas in (
            ("grid_top_r[rows]", rows1, n_r, feas_r),
            ("grid_top_r[carry_full]", tuple(full1) + (None, None), K,
             feas_k)):
        recs[name] = record_kernel(
            label, name, after(lambda *a: G.grid_rescore_carry(
                *a[:12], rows=a[12], n_rows=a[13]), (8, 9)),
            after(lambda *a: G.grid_rescore_carry_plain(
                *a[:12], rows=a[12], n_rows=a[13]), (8, 9)), args, {},
            dict(base, rows=nrows, feasible_cells=nfeas),
            nrows * 4 * (G._SF + 3 * S + 2 + 1) + D * 4 * (G._DF + G._DI)
            + 4 * G._NC + nrows * R * 8,
            G.grid_top_r_ops(nrows * D, nfeas, S, D), plain_kw={},
            timed=timed, exact=True)
    # the carry form writes the leadership scores only (no feasibility)
    ls, _ = kw6["out"]
    k6 = tuple(a6) + (ls, None, kw6["rows"], kw6["n_rows"], kw6["gate"], 0,
                      kw6["bcost"])
    st6 = kw6["gate"].clone()
    st6[SS.FRESH] = 1
    k6f = tuple(a6) + (ls, None, None, None, st6, 1, kw6["bcost"])
    n_part = int(torch.unique(lp).numel())
    for name, args, n in (("score_candidates[rows]", k6, min(LB, n_l)),
                          ("score_candidates[carry_full]", k6f, L)):
        recs[name] = record_kernel(
            label, name,
            after(lambda *a: K6.score_candidates(
                *a[:9], checked=True, out=(a[9], a[10]), rows=a[11],
                n_rows=a[12], gate=a[13], want=a[14], bcost=a[15]), (9,)),
            after(lambda *a: K6._score_candidates_into(
                *a[:7], a[9], a[10], a[11], a[12], a[13], a[14]), (9,)),
            args, {}, dict(base, N=n),
            # as phase 3's K6 record, for the n candidates scored, with
            # the score out and no feasibility
            n * 16 + min(n, n_part) * (9 * S + 4 + 4 * W)
            + B * (4 * (NR * (3 if has_cap else 2) + 4) + 6 + 4)
            + 4 * (3 * NR + 16) + n * 4,
            n * 230, plain_kw={}, timed=timed, tag="score_candidates_",
            exact=True)

    # K8 with the marks: it clears the step before's from its lists, then
    # marks this step's commits (the twin zeroes the tables and marks)
    (a8, kw8), = calls["commit_batch"]
    args8 = tuple(a8) + (kw8["tb"], kw8["tpm"], kw8["marks"])
    state0 = a8[15].state.clone()

    def commit(fn, **k):
        def run(*a):
            a[15].state.copy_(state0)
            m_, tpp, c_step = fn(*a[:16], tb=a[16], tpm=a[17], **k)
            return [*_model_fields(m_), tpp, c_step, a[12], a[15].state,
                    a[15].counts, a[16], a[17]]
        return run

    n_commit, touched = commit_plan(a8)
    prev = int((kw8["marks"][0] >= 0).sum())
    recs["commit_batch[marks]"] = record_kernel(
        label, "commit_batch[marks]",
        lambda *a: commit(K89.commit_batch, checked=True,
                          marks=a[18])(*a),
        commit(K89.commit_batch_plain), args8, {},
        dict(base, C=a8[5].shape[0], M_step=a8[11], commits=n_commit,
             touched_brokers=touched, marks_cleared=prev),
        # as phase 3's K8 record, and the marks: the lists read and
        # written, a mark a broker or partition set and cleared
        commit_bytes(a8, has_cap, n_commit, touched,
                     2 * 3 * a8[11] * 4 + 3 * (prev + n_commit)),
        commit_ops(a8, has_cap, n_commit),
        plain_kw={}, timed=timed, exact=True)
    return recs


def capped_calls(state, dev, cfg_kw):
    """Scan calls capped at 1, 7 and steps_per_call on one step loop,
    replaying one captured chunk (the same graph object): each runs at
    most its cap, and the uncapped call's first steps → the record."""
    import numpy as np

    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.ops.grid import grid_consts

    opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(**cfg_kw),
                              device=dev)
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    cfg = C._resolve_batch(opt.config, ctx.num_brokers)
    T = cfg.steps_per_call
    consts = grid_consts(cfg, ca, dev)
    loop = C._StepLoop(m, cfg, ca, consts, K, D, T)
    full, _, _ = C._scan_call(m, cfg, ca, consts, K, D, T, C._cold_tables(m),
                              loop)
    graph = loop.chunk.graph
    rec = {"phase": "capped_calls", "config": cfg_kw, "uncapped_steps":
           full.diag["steps_run"], "caps": {}}
    for cap in (1, 7, T):
        res, _, _ = C._scan_call(m, cfg, ca, consts, K, D, T,
                                 C._cold_tables(m), loop, t_cap=cap)
        steps = res.diag["steps_run"]
        n = int(res.step_counts.sum())
        same = (np.array_equal(res.step_counts, full.step_counts[:steps])
                and all(np.array_equal(getattr(res, f),
                                       getattr(full, f)[:n])
                        for f in ("kind", "p", "s", "d")))
        rec["caps"][cap] = {"steps_run": steps, "actions": n,
                            "graph_replays": res.diag["graph_replays"],
                            "prefix_of_uncapped": same}
        if not 0 < steps <= cap or not same:
            raise AssertionError(f"capped call at {cap}: {steps} steps, "
                                 f"prefix of the uncapped call: {same}")
    rec["one_graph"] = loop.chunk.graph is graph
    emit(rec)
    if not rec["one_graph"]:
        raise AssertionError("a capped call captured a new graph")
    return rec


def budgeted_plans(state, T=16, budget=2.0):
    """The plan in calls of ``T`` steps under a time budget, through
    ``optimize``: first one that never runs out — every call once the hard
    goals hold is capped (the probe, then remaining / step rate), runs at
    most its cap, and the plan equals the unbudgeted one — then one of
    ``budget`` seconds in which host time passes after the first capped
    call (a wait) until, after the host recheck that follows, about half
    that call's time is left: the budget then cuts the plan short (its
    next call capped by the step rate, or none), its capped calls run at
    most their caps and its hard goals hold → the record."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
    from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
    from cruise_control_tpu_torch.analyzer.verifier import (
        verify_result,
        violation_score,
    )

    goals = make_goals()
    real = C._scan_call
    calls = []
    #: the timed run's start and, for the cut run, its budget
    clock = {"t0": 0.0, "budget": None, "wait_s": 0.0}

    def spy(*a, t_cap=None, **k):
        t = time.perf_counter()
        out = real(*a, t_cap=t_cap, **k)
        end = time.perf_counter()
        calls.append((t, end, t_cap, int(out[0].diag["steps_run"])))
        if clock["budget"] is not None and t_cap is not None \
                and sum(c[2] is not None for c in calls) == 1:
            if len(calls) < 2:
                raise AssertionError("the hard goals held before the "
                                     "first call")
            # the host recheck that will follow, timed on the call before
            recheck = t - calls[-2][1]
            wait = (clock["t0"] + clock["budget"] - recheck
                    - 0.5 * (end - t) - end)
            if wait <= 0:
                raise AssertionError(f"the budget was spent {-wait} s "
                                     "before the first capped call ended")
            time.sleep(wait)
            clock["wait_s"] = wait
        return out

    def plan(budget, cut):
        opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(
            steps_per_call=T, time_budget_s=budget))
        run_plan(opt, state)
        calls.clear()
        torch.cuda.synchronize()
        clock.update(t0=time.perf_counter(), budget=budget if cut else None,
                     wait_s=0.0)
        r, s = run_plan(opt, state)
        clock["budget"] = None
        verify_result(state, r, goals)
        summ = r.goal_summaries[0]
        capped = [(t - clock["t0"], cap, n) for t, _, cap, n in calls
                  if cap is not None]
        rec = {"time_budget_s": budget, "wallclock_s": s,
               "host_wait_s": clock["wait_s"], "actions": len(r.actions),
               "steps": summ["steps"], "calls": summ["rounds"],
               "capped_calls": summ["capped_calls"],
               "capped": [{"at_s": t, "cap": cap, "steps_run": n}
                          for t, cap, n in capped],
               "hard_goals_hold": C._hard_goals_hold(
                   AnalyzerContext(r.final_state), goals),
               "violation_score": violation_score(r.final_state, goals)}
        if not capped or summ["capped_calls"] != len(capped) \
                or any(not 0 < n <= cap for _, cap, n in capped) \
                or not rec["hard_goals_hold"] or not r.actions:
            raise AssertionError(f"budgeted plan at {budget} s: {rec}")
        return r, rec

    C._scan_call = spy
    try:
        r_free, _ = run_plan(C.CudaGoalOptimizer(
            config=C.CudaSearchConfig(steps_per_call=T)), state)
        r_long, long_rec = plan(600.0, cut=False)
        _, cut_rec = plan(budget, cut=True)
    finally:
        C._scan_call = real
    rec = {"phase": "budgeted_1000b_20k", "steps_per_call": T,
           "never_spent": long_rec, "cut": cut_rec,
           "never_spent_is_unbudgeted": actions_of(r_long)
           == actions_of(r_free),
           "cut_capped_below_T": any(c["cap"] < T
                                     for c in cut_rec["capped"])}
    emit(rec)
    if not rec["never_spent_is_unbudgeted"]:
        raise AssertionError("a budget that never ran out moved the plan")
    if cut_rec["steps"] >= long_rec["steps"]:
        raise AssertionError("the spent budget did not cut the plan short")
    return rec


def incremental_leg(dev, mid, ragged, main_plan):
    """Phase 8's incremental leg → (records by name, the incremental
    plan's launches, its acting launches): K16, K17 and the gated K1 / K6
    against their twins (1 000 / 20 000, percentile loads, ragged), one
    incremental scan call eager against captured, capped calls on one
    captured chunk (default and incremental), the 1 000 / 20 000 plan at
    ``incremental_rescore`` twice (beside the default plan ``main_plan``
    of phase 6) and the budgeted plans (:func:`budgeted_plans`)."""
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaGoalOptimizer,
        CudaSearchConfig,
    )

    recs = {}
    for lbl, state, kw in (
            ("midscale", mid, {}),
            ("midscale_percentile", with_percentile(mid), {}),
            ("ragged", ragged, {"max_source_replicas": 1999,
                                "device_batch_per_step": 8})):
        out = check_incremental_kernels(lbl, state, kw, dev,
                                        timed=lbl == "midscale")
        recs.update({(n if lbl == "midscale" else f"{n}@{lbl}"): v
                     for n, v in out.items()})
    torch.cuda.empty_cache()
    compare_scan_paths(mid, dev, {"incremental_rescore": True},
                       phase="scan_paths_incremental")
    for kw in ({}, {"incremental_rescore": True}):
        capped_calls(mid, dev, kw)

    opt = CudaGoalOptimizer(config=CudaSearchConfig(incremental_rescore=True))
    rec, launches = search_path_plan("incremental_1000b_20k", "incremental",
                                     opt, mid, MIDSCALE_SCORE_BAR)
    summ = rec["passes"][0]
    if summ["patch_steps"] <= 0:
        raise AssertionError("the incremental plan never patched")
    emit({"phase": "incremental_vs_default_1000b_20k",
          "incremental": {k: summ[k] for k in (
              "steps", "rounds", "n_overflow", "patch_steps")}
          | {"actions": rec["actions"], "violation_score":
             rec["violation_score"], "wallclock_s": rec["wallclock_s"],
             "mean_step_ms": summ["timing_s"]["device"] / summ["steps"]
             * 1e3, "device_s": summ["timing_s"]["device"]},
          "default": main_plan})

    budgeted_plans(mid)
    # K16 acts on every active step, K17 on every patching one
    acting = {"stale_sets": summ["steps"], "grid_patch": summ["patch_steps"]}
    return recs, launches, acting


def search_paths_phase(dev, mid, small, g_small, main_launches,
                       main_plan):
    """Phase 8 → (the kernel records by name, each path's launches, K16's
    and K17's acting launches on the incremental plan); ``main_plan`` is
    phase 6's default plan, which the incremental plan is recorded
    beside."""
    from cruise_control_tpu_torch.analyzer import round_kernels as RK
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaGoalOptimizer,
        CudaSearchConfig,
    )
    from cruise_control_tpu_torch.models.generators import random_cluster

    # the default plan (phase 6) ran none of this slice's kernels
    for name in OFF_DEFAULT:
        if main_launches[name] != 0:
            raise AssertionError(f"the default plan launched {name}")
    recs = {}
    r = round_inputs(mid, {}, dev)
    recs.update(check_round_kernels("midscale", r, True))
    L = r["forms"]["grid"][2][3].shape[0]
    if (r["K"], r["D"], L) != MIDSCALE_ROUND:
        raise AssertionError(f"midscale round at K={r['K']}, D={r['D']}, "
                             f"not {MIDSCALE_ROUND}")
    del r
    rp = round_inputs(with_percentile(mid), {}, dev)
    recs.update({f"{n}@percentile": v for n, v in check_round_kernels(
        "midscale_percentile", rp, False, whole=False).items()})
    del rp
    ragged = random_cluster(seed=5, num_brokers=77, num_racks=7,
                            num_partitions=3001, dead_brokers=3)
    rr = round_inputs(ragged, {"max_source_replicas": 1999}, dev)
    recs.update({f"{n}@ragged": v for n, v in check_round_kernels(
        "ragged", rr, False).items()})
    del rr
    ns = north_star_round(dev)
    recs.update({f"{n}@north_star": v for n, v in check_round_kernels(
        "north_star", ns, False, whole=False).items()})
    del ns
    torch.cuda.empty_cache()
    for lbl, state, kw in (
            ("midscale", mid, {}),
            ("midscale", mid, {"cohort_stack_tol": 0.25}),
            ("midscale_percentile", with_percentile(mid), {}),
            ("ragged", ragged, {"max_source_replicas": 1999,
                                "cohort_stack_tol": 0.25})):
        out = check_corrected(lbl, state, kw, dev,
                              timed=lbl == "midscale" and not kw)
        recs.update({(n if lbl == "midscale" else f"{n}@{lbl}"): v
                     for n, v in out.items()})
    # K15 on one destination, one source, 777 and 1 rows, 10 000 brokers
    # and 64 × the rows over 66 × the brokers (device scratch, chunks,
    # 64-bit keys), with percentile loads and the stacking guard on
    for case, (a, kw) in corrected_cases(with_percentile(mid), {
            "cohort_stack_tol": 0.25}, dev).items():
        recs.update(check_corrected_case(case, a, kw))
    wide = recs["corrected_accept[c64k_wide]"]
    if recs["corrected_accept[one_dst]"]["distinct_dst"] != 1 \
            or recs["corrected_accept[b10k]"]["B"] < 10_000 \
            or recs["corrected_accept[c1]"]["C"] != 1 \
            or wide["C"] <= 1 << 15 or wide["B"] < 1 << 16:
        raise AssertionError("K15's skewed cohorts are not skewed")
    inc_recs, inc_launches, inc_acting = incremental_leg(dev, mid, ragged,
                                                         main_plan)
    recs.update(inc_recs)

    # one score-only round at full width, in both forms, then the full
    # score-only plan there (grid form)
    one_round = {}
    for scoring in ("grid", "columnar"):
        opt = CudaGoalOptimizer(config=CudaSearchConfig(
            steps_per_call=0, max_rounds=1, scoring=scoring))
        run_plan(opt, mid)
        RK.round_keys.launches = RK.score_columnar.launches = 0
        res, s = run_plan(opt, mid)
        one_round[scoring] = {"wallclock_s": s, "actions": len(res.actions),
                              "timing_s": res.goal_summaries[0]["timing_s"],
                              "round_keys_launches": RK.round_keys.launches,
                              "score_columnar_launches":
                              RK.score_columnar.launches}
    emit({"phase": "score_only_round_1000b_20k", **one_round})
    # the columnar round's key is K14's: no K13 (a) launch
    if one_round["columnar"]["round_keys_launches"] != 0 \
            or one_round["columnar"]["score_columnar_launches"] < 1 \
            or one_round["grid"]["round_keys_launches"] < 1:
        raise AssertionError(f"K13 (a) / K14 launches a round: {one_round}")

    launches = {}
    for label, path, cfg, state, bar in (
            ("score_only_grid_50b_1k", "score_only_grid",
             dict(steps_per_call=0), small, g_small),
            ("score_only_columnar_50b_1k", "score_only_columnar",
             dict(scoring="columnar"), small, g_small),
            ("score_only_grid_1000b_20k", "score_only_grid",
             dict(steps_per_call=0), mid, MIDSCALE_SCORE_BAR),
            ("polish_1000b_20k", "polish", dict(polish_rounds=4), mid,
             MIDSCALE_SCORE_BAR),
            ("corrected_1000b_20k", "corrected",
             dict(cohort_mode="corrected"), mid, MIDSCALE_SCORE_BAR)):
        opt = CudaGoalOptimizer(config=CudaSearchConfig(**cfg))
        _, counts = search_path_plan(label, path, opt, state, bar)
        launches.setdefault(path, counts)
    if launches["corrected"]["budget_accept"] != 0:
        raise AssertionError("the corrected cohort's plan launched K4")
    launches["incremental"] = inc_launches
    return recs, launches, inc_acting


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
    repool_census(mid, dev)
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
    pk = check_grid_top_r("midscale_percentile",
                          *grid_inputs(with_percentile(mid), {}, dev))
    if not pk["percentile_cload"]:
        raise AssertionError("percentile K1 case ran without capacity loads")
    # K1 and K17 at the slot instances phase 3's clusters (S = 3) skip
    check_slot_instances(dev)
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
    # K2 and K6 bit for bit on empty chosen slots, exclusions, a padded
    # pool, zero capacities, 10 000 brokers, at 50 / 1 000 and at
    # replication factors 1 and 8; K6 also on moves and transfers mixed
    # and in its two carry forms
    calls, _ = first_step_calls(mid, {}, dev)
    extra = {}
    for case, (k2, k6) in {**score_terms_cases(calls, dev),
                           **slot_cases(dev)}.items():
        if k2 is not None:
            extra.update(check_grid_terms(case, k2, False, False,
                                          name=f"grid_terms[{case}]"))
        if k6 is not None:
            extra.update(check_score_candidates(
                case, *k6, False, False, name=f"score_candidates[{case}]"))
    mixed = extra["score_candidates[mixed_kinds]"]
    if not 0 < mixed["moves"] < mixed["N"] \
            or extra["grid_terms[b10k]"]["B"] < 10_000 \
            or extra["score_candidates[rf8]"]["N"] < 1:
        raise AssertionError("K2's and K6's hard cases are not hard")
    # K7 on 50 000 tie-rich keys; K9 at the north star's 3 M slots
    # K4 on one destination, one source, 777 and 1 rows and 10 000
    # brokers; K7 tie-rich at 5 000 keys (C = 1 024, 777, 1) and 50 000
    for case, (a4, kw4) in cohort_cases(calls, dev).items():
        extra.update(check_budget_accept(case, a4, kw4, False, False,
                                         name=f"budget_accept[{case}]"))
    if extra["budget_accept[one_dst]"]["distinct_dst"] != 1 \
            or extra["budget_accept[b10k]"]["B"] < 10_000:
        raise AssertionError("K4's skewed cohorts are not skewed")
    # K10 incremental over every row, at its budget and one above it, on
    # every partition excluded, must-move slots with a dead broker, gated,
    # at 10 000 brokers, replication factors 1 and 8 and the north star
    for case, a in pool_cases(calls["pool_tables"][0], dev).items():
        extra.update(check_pool_case(case, a))
    k10 = {c: extra[f"pool_tables[{c}]"] for c in (
        "incr_all_rows", "incr_at_budget", "incr_over_budget",
        "gated_inactive", "north_star", "rf8")}
    if (k10["incr_all_rows"]["full"], k10["incr_at_budget"]["full"],
            k10["incr_over_budget"]["full"], k10["gated_inactive"]["repool"],
            k10["north_star"]["P"], k10["rf8"]["S"]) != (0, 0, 1, 0,
                                                          1_000_000, 8):
        raise AssertionError(f"K10's hard cases are not what they say: "
                             f"{k10}")
    for case, sargs in compaction_cases(dev).items():
        extra.update(check_compact_rows(case, sargs, {}, False, False,
                                        name=f"compact_rows[{case}]"))
    if extra["compact_rows[nrow_50k]"]["NROW"] < 50_000:
        raise AssertionError("synthetic compaction is below 50 000 keys")
    # K3 over 10 000, 20 000 and 45 000 brokers, on one source broker, all
    # +inf, at Q = 1 and 8, on -0.0 / +0.0 ties and past shared memory
    a3, kw3 = calls["per_src_top"]
    for case, (a, kw) in src_top_cases(a3, kw3, dev).items():
        extra.update(check_per_src_top(case, a, kw, False,
                                       name=f"per_src_top[{case}]"))
    # K8 with nothing, everything and ties committed, on one destination,
    # one source and 10 000 brokers; K5 from no cohort, on ties, one
    # destination, one source and 10 000 brokers (caps 1 and 2)
    for case, (a, kw) in commit_cases(calls, dev).items():
        extra.update(check_commit_batch(case, a, kw, False, False,
                                        name=f"commit_batch[{case}]"))
    for case, (a, kw) in match_cases(calls, dev).items():
        extra.update(check_match_batch(case, a, kw, False, False,
                                       name=f"match_batch[{case}]"))
    if extra["commit_batch[b10k]"]["B"] < 10_000 \
            or extra["match_batch[b10k_track]"]["B"] < 10_000:
        raise AssertionError("the 10 000-broker K5 / K8 cases are smaller")
    # the scratch holds the gathered keys and brokers alone, and more
    # where the leadership's (b45k_small) or the rows' (k32k) keys do not
    # fit in shared memory
    for case, spill in (("midscale", False), ("b45k", False),
                        ("b45k_small", True), ("k32k", True)):
        k3 = (steps["midscale"]["per_src_top"] if case == "midscale"
              else extra[f"per_src_top[{case}]"])
        gathered = k3["K"] * 8 + -(-k3["L"] * 4 // 8) * 8
        if (k3["scratch_bytes"] > gathered) != spill:
            raise AssertionError(f"K3 {case}: scratch of "
                                 f"{k3['scratch_bytes']} bytes")
    m_ns = north_star_placement(dev)
    extra["recompute_aggregates"] = check_recompute_aggregates(
        "north_star_slots", m_ns, True, True)
    # K9 where one broker hosts over a quarter of the slots, at 1 000 and
    # at the north star's 10 000 brokers
    m_skew = calls["recompute_aggregates"][0][0]
    m_skew = dataclasses.replace(m_skew,
                                 assignment=skew_placement(m_skew.assignment))
    m_cap = dataclasses.replace(m_skew, leader_cload=m_skew.leader_load * 1.3,
                                follower_cload=m_skew.follower_load * 0.6)
    m_ns = dataclasses.replace(m_ns,
                               assignment=skew_placement(m_ns.assignment))
    for tag, ms, cap in (("skew", m_skew, False),
                         ("skew_percentile", m_cap, True),
                         ("north_star_skew", m_ns, True)):
        r9 = check_recompute_aggregates(tag, ms, cap, True)
        if r9["top_broker_share"] < 0.25:
            raise AssertionError(f"K9 {tag}: the hot broker hosts "
                                 f"{r9['top_broker_share']:.3f} of the slots")
        extra[f"recompute_aggregates[{tag}]"] = r9
    del m_skew, m_cap, m_ns
    pargs, pkw = synthetic_priority(dev)
    extra.update(check_top_select("north_star_slots", "top_select[3M]",
                                  pargs, pkw, True))
    del pargs, pkw
    extra.update(check_top_select_cases(dev))
    steps["extra"] = extra
    compare_scan_paths(mid, dev)
    del calls
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
           "timing_s": summ["timing_s"], **loop_counts(summ)}
    emit(rec)
    check_loop_counts("50b plan", summ)
    if score > g_score:
        raise AssertionError(f"50b plan score {score} > greedy {g_score}")
    if not rec["identical_reruns"]:
        raise AssertionError("two 50b plans differ")
    for name in PATHS["plan"]:
        if launches_small[name] <= 0:
            raise AssertionError(f"50b plan never launched {name}")

    # ---- the main path: plan at 1 000 brokers / 20 000 partitions -----------
    # the optimizer's first plan at this shape captures the step chunk; the
    # second, the main path measured here, replays it
    r0, s0 = run_plan(opt, mid)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    r, s = run_plan(opt, mid)
    launches = {n: fn.launches for n, fn in counters().items()}
    verify_result(mid, r, goals)
    score = violation_score(r.final_state, goals)
    summ = r.goal_summaries[0]
    if actions_of(r0) != actions_of(r):
        raise AssertionError("two midscale plans differ")
    emit({"phase": "plan_1000b_20k", "wallclock_s": s,
          "wallclock_s_first": s0,
          "timing_s_first": r0.goal_summaries[0]["timing_s"],
          "identical_reruns": True,
          "violation_score": score, "score_bar": MIDSCALE_SCORE_BAR,
          "actions": len(r.actions), "steps": summ["steps"],
          "device_calls": summ["rounds"],
          "mean_step_ms": summ["timing_s"]["device"] / summ["steps"] * 1e3,
          "timing_s": summ["timing_s"], "launches": launches,
          "launches_acting": acting_launches(launches, summ),
          **loop_counts(summ),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    check_loop_counts("midscale plan", summ)
    if score > MIDSCALE_SCORE_BAR:
        raise AssertionError(f"midscale score {score} > {MIDSCALE_SCORE_BAR}")
    if set(launches) != set(KERNELS):
        raise AssertionError(f"counted {sorted(launches)}, built "
                             f"{sorted(KERNELS)}")
    acting = acting_launches(launches, summ)
    for name in PATHS["plan"]:
        n = launches[name]
        if n <= 0 or acting[name] <= 0:
            raise AssertionError(f"main path never launched {name} to act "
                                 f"({n} launches, {acting[name]} acting)")
    got = (score, summ["steps"], len(r.actions))
    if got != MIDSCALE_DEFAULT_PLAN or any(
            launches[n] != MIDSCALE_DEFAULT_K1_K6
            for n in ("grid_top_r", "score_candidates")):
        raise AssertionError(
            f"the default plan moved: (score, steps, actions) {got}, K1 / K6 "
            f"{launches['grid_top_r']} / {launches['score_candidates']} "
            f"launches")
    main_plan = {"violation_score": score, "steps": summ["steps"],
                 "actions": len(r.actions), "wallclock_s": s,
                 "device_s": summ["timing_s"]["device"],
                 "mean_step_ms": summ["timing_s"]["device"]
                 / summ["steps"] * 1e3,
                 "launches": {n: launches[n] for n in (
                     "grid_top_r", "score_candidates")}}

    # ---- the what-if path ---------------------------------------------------
    whatif_recs, whatif_launches = whatif_phase(dev)
    for name in PATHS["whatif"]:
        launches[name] = acting[name] = whatif_launches[name]

    # ---- the search's off-default paths -------------------------------------
    path_recs, path_launches, inc_acting = search_paths_phase(
        dev, mid, small, g_score, launches, main_plan)
    for name in OFF_DEFAULT:
        launches[name] = path_launches[LAUNCH_PATH[name]][name]
        # K13-K15 act at every launch; K16 and K17 return at once on a
        # masked step, and K17 on a fresh one too (the plan's summary)
        acting[name] = inc_acting.get(name, launches[name])
        if acting[name] <= 0:
            raise AssertionError(f"{name} never acted on its path")

    # the kernels line: main-path shapes (mid-scale); errors over every case
    cases = [steps[c] for c in steps] + [
        {"whatif_verdict": r} for r in whatif_recs.values()] + [
        {re.split(r"[\[@]", n)[0]: r} for n, r in path_recs.items()]
    main_rec = {"grid_top_r": k1, **steps["midscale"],
                "whatif_verdict": whatif_recs["midscale_x64"],
                **{n: path_recs[n] for n in OFF_DEFAULT}}
    # every case of a kernel, its variants ("name[...]") included
    errs = {n: max([r[c]["max_abs_err"] for r in cases for c in r
                    if c == n or c.startswith(n + "[")]
                   + ([k1["max_abs_err"], rk["max_abs_err"],
                       pk["max_abs_err"]] if n == "grid_top_r" else []))
            for n in KERNELS}
    line = []
    for name, replaces in KERNELS.items():
        rec = main_rec[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"cruise_control_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_acting": acting[name],
            "max_abs_err": errs[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_note": LIBRARY_NOTES[name],
            "device_ms": rec.get("device_ms"),
            **({"launches_incremental": path_launches["incremental"][name]}
               if name in PATHS["incremental"] else {}),
            **({"library_sort_ms": rec["library_sort_ms"]}
               if "library_sort_ms" in rec else {}),
            **({"attrs": rec["attrs"]} if "attrs" in rec else {}),
        })
    print(nvidia_smi(), flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

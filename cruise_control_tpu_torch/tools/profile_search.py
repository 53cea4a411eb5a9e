"""Profile the port's plan search on the card: where a plan's time goes.

    python3 -m cruise_control_tpu_torch.tools.profile_search [--incremental]

``--incremental`` profiles the search with ``incremental_rescore=True``
(the default path otherwise).  Builds the seeded 1 000-broker / 20 000-partition fixture (seed 12, 20 racks,
mean utilization 0.35), runs one warm-up
plan, then one plan un-profiled and one under a ``torch.profiler`` session (CPU + CUDA
activities) opened through the kernel observatory's one entry point
(``telemetry/kernel_budget.py: profiler_session``), whose Chrome trace
that module's parser reads, and prints one JSON line: the plan's
wall-clock, steps, device-busy time (the kernels' time on the card), the
idle share, the un-profiled plan's actions (count and sha256 of
their fields), violation score, repools, overflows and patch steps,
kernel launches per step, the device time and launches of each hand-written kernel
(``csrc/*.cu``), the step loop's device-to-host reads and captured-chunk
replays (CUDA graph launches) per plan, the kernels that take the most
device time and the host ops that take the most CPU time.  The profiler's own cost inflates the host side,
so the idle share it reports is an upper bound; the un-profiled wall-clock
of the same plan is printed beside it.  Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import tempfile
import time

import torch


#: the mid-scale parity fixture, at the engine's default widths
FIXTURE = dict(seed=12, num_brokers=1000, num_racks=20, num_partitions=20000,
               mean_utilization=0.35)
TOP = 15


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--incremental", action="store_true",
                    help="profile incremental_rescore=True")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_search needs a CUDA card")

    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaGoalOptimizer,
        CudaSearchConfig,
    )
    from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
    from cruise_control_tpu_torch.analyzer.verifier import violation_score
    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.telemetry import kernel_budget as KB

    state = random_cluster(**FIXTURE)
    opt = CudaGoalOptimizer(config=CudaSearchConfig(
        incremental_rescore=args.incremental))
    opt.optimize(state)                                   # warm-up plan
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain = opt.optimize(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with KB.profiler_session(tmp, activities=acts) as prof:
            t = time.perf_counter()
            res = opt.optimize(state)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        parsed = KB.parse_trace(prof.trace_path)
    steps = res.goal_summaries[0]["steps"]

    # the card's kernels from the trace's kernel records (self time; one
    # stream, so their sum is the union of their intervals)
    kern = collections.defaultdict(lambda: [0.0, 0])
    hand = collections.defaultdict(lambda: {"ms": 0.0, "count": 0})
    for row in parsed.rows:
        kern[row.name][0] += row.time_us
        kern[row.name][1] += row.count
        if row.category != "torch":
            hand[row.category]["ms"] += row.time_us * 1e-3
            hand[row.category]["count"] += row.count
    hand = {n: dict(hand[n]) for n in sorted(KB.KERNEL_BUCKETS)}
    busy_s = parsed.total_time_us * 1e-6
    n_kernels = parsed.total_count
    cpu = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            cpu[e.name][0] += e.self_cpu_time_total
            cpu[e.name][1] += 1

    def top(table):
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [{"name": n[:120], "ms": us * 1e-3, "count": c}
                for n, (us, c) in rows]

    summ = plain.goal_summaries[0]
    moves = [(int(a.action_type), a.partition, a.slot, a.source_broker,
              a.dest_broker, a.dest_slot) for a in plain.actions]
    print(json.dumps({
        "phase": "profile_search", "device": torch.cuda.get_device_name(0),
        "fixture": FIXTURE, "incremental_rescore": args.incremental,
        "steps": steps,
        "actions": len(moves),
        "actions_sha256": hashlib.sha256(repr(moves).encode()).hexdigest(),
        "violation_score": violation_score(plain.final_state, make_goals()),
        "plain_wallclock_s": plain_s,
        "plain_timing_s": summ["timing_s"],
        # the step loop's reads of the card (carry reads and prefix
        # fetches), captured-chunk replays and repools, un-profiled plan
        "host_syncs": summ["host_syncs"], "scan_calls": summ["rounds"],
        "graph_replays": summ["graph_replays"], "repools": summ["repools"],
        "n_overflow": summ["n_overflow"], "patch_steps": summ["patch_steps"],
        "profiled_graph_launches": cpu["cudaGraphLaunch"][1],
        "profiled_wallclock_s": wall_s, "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall_s,
        "kernels": n_kernels, "kernels_per_step": n_kernels / max(steps, 1),
        "hand_kernels": hand,
        "top_kernels": top(kern), "top_host_ops": top(cpu),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

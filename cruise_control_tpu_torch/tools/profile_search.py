"""Profile the port's plan search on the card: where a plan's time goes.

    python3 -m cruise_control_tpu_torch.tools.profile_search

Builds the seeded 1 000-broker / 20 000-partition fixture (seed 12, 20 racks,
mean utilization 0.35), runs one warm-up
plan, then one plan under ``torch.profiler`` (CPU + CUDA activities) and
prints one JSON line: the plan's wall-clock, steps, device-busy time (the
union of kernel intervals on the card), the idle share, kernel launches
per step, the device time and launches of each hand-written kernel
(``csrc/*.cu``), the step loop's device-to-host reads and captured-chunk
replays (CUDA graph launches) per plan, the kernels that take the most
device time and the host ops that take the most CPU time.  The profiler's own cost inflates the host side,
so the idle share it reports is an upper bound; the un-profiled wall-clock
of the same plan is printed beside it.  Needs a card.
"""

from __future__ import annotations

import collections
import json
import time
from pathlib import Path

import torch


#: the mid-scale parity fixture, at the engine's default widths
FIXTURE = dict(seed=12, num_brokers=1000, num_racks=20, num_partitions=20000,
               mean_utilization=0.35)
TOP = 15


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_search needs a CUDA card")

    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaGoalOptimizer,
    )
    from cruise_control_tpu_torch.models.generators import random_cluster

    state = random_cluster(**FIXTURE)
    opt = CudaGoalOptimizer()
    opt.optimize(state)                                   # warm-up plan
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain = opt.optimize(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        res = opt.optimize(state)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    steps = res.goal_summaries[0]["steps"]

    kern = collections.defaultdict(lambda: [0.0, 0])
    cpu = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s, d = e.time_range.start, e.time_range.elapsed_us()
            intervals.append((s, s + d))
            kern[e.name][0] += d
            kern[e.name][1] += 1
        else:
            cpu[e.name][0] += e.self_cpu_time_total
            cpu[e.name][1] += 1
    if not intervals:
        # a profiler build that attaches kernels to their host ops only:
        # sum their durations (no overlap on the search's one stream)
        for e in prof.events():
            for k in getattr(e, "kernels", ()):
                intervals.append((0.0, 0.0))
                kern[k.name][0] += k.duration
                kern[k.name][1] += 1
        busy_s = sum(us for us, _ in kern.values()) * 1e-6
    else:
        busy_s = _busy_us(intervals) * 1e-6
    n_kernels = sum(c for _, c in kern.values())

    # the hand-written kernels, by their CUDA function names
    # (csrc/<name>.cu defines <name>_kernel or <name>_<part>_kernel)
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    hand = {}
    for name in sorted(p.stem for p in csrc.glob("*.cu")):
        rows = [v for k, v in kern.items()
                if f"{name}_" in k and "_kernel" in k]
        hand[name] = {"ms": sum(us for us, _ in rows) * 1e-3,
                      "count": sum(c for _, c in rows)}

    def top(table):
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [{"name": n[:120], "ms": us * 1e-3, "count": c}
                for n, (us, c) in rows]

    summ = plain.goal_summaries[0]
    print(json.dumps({
        "phase": "profile_search", "device": torch.cuda.get_device_name(0),
        "fixture": FIXTURE, "steps": steps,
        "plain_wallclock_s": plain_s,
        "plain_timing_s": summ["timing_s"],
        # the step loop's reads of the card (carry reads and prefix
        # fetches), captured-chunk replays and repools, un-profiled plan
        "host_syncs": summ["host_syncs"], "scan_calls": summ["rounds"],
        "graph_replays": summ["graph_replays"], "repools": summ["repools"],
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

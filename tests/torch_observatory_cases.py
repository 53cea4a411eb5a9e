"""Shared cases of the port's device-observatory tests
(``tests/test_torch_{kernel_budget,mesh_budget,device_stats,
observatory_served}.py``): one synthetic timeline written in the
reference's device dialect and in Kineto's, the reference's kernel-budget
fixture (read as data from ``tests/budgets/kernel_budget.json``), and a
live CPU capture of a port plan at that fixture."""

import gzip
import json
import os

from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.telemetry.events import EventJournal

BUDGET_PATH = os.path.join(os.path.dirname(__file__), "budgets",
                           "kernel_budget.json")

#: the engine knobs of the reference's budget fixture
CFG_KEYS = ("steps_per_call", "repool_steps", "device_batch_per_step",
            "max_source_replicas", "max_dest_brokers", "repool_rows_budget")
#: the cluster of the reference's budget fixture
CLUSTER_KEYS = ("seed", "num_brokers", "num_racks", "num_partitions")


def budget_fixture() -> dict:
    with open(BUDGET_PATH) as f:
        return json.load(f)["fixture"]


#: one kernel of each kind, as (reference name, reference HLO category,
#: Kineto name): the reference buckets by HLO name, the port by csrc stem,
#: and each pair lands in the same bucket
KINDS = {
    "topk": ("sort.1", "sort",
             "void (anonymous namespace)::grid_top_r_kernel<1, false>("
             "(anonymous namespace)::Args)"),
    "gather": ("concatenate_gather_fusion.2", "fusion",
               "(anonymous namespace)::compact_rows_kernel("
               "(anonymous namespace)::Args)"),
    "stage": ("reduce-window.5", "reduce-window",
              "(anonymous namespace)::round_pack_keys_kernel(float const*, "
              "int)"),
    "tail": ("add.3", "add",
             "void at::native::vectorized_elementwise_kernel<4, "
             "at::native::FillFunctor<float> >(int)"),
    "collective": ("all-reduce.4", "all-reduce",
                   "ncclDevKernel_AllReduce_Sum_f32_RING_LL("
                   "ncclDevKernelArgsStorage<4096ul>)"),
}
#: the hand kernels' stems of the Kineto names and the reference's bytes
#: and model flops a launch (PyTorch's and NCCL's kernels have no work
#: model: 0 in both)
WORK = {"topk": ("grid_top_r", 4096, 1000), "gather": ("compact_rows", 640,
                                                       64),
        "stage": ("round_pack", 2048, 300)}

#: (device, kind, start µs, duration µs), leaf kernels only (the port's
#: traces have no regions), overlapping and gapped, on two cards
KERNELS = [
    (0, "topk", 0.0, 12.5), (0, "gather", 14.0, 3.5), (0, "tail", 16.0, 1.0),
    (0, "topk", 20.0, 12.5), (0, "stage", 34.0, 2.0),
    (0, "collective", 40.0, 8.0), (1, "stage", 10.0, 0.75),
    (1, "gather", 1.0, 3.5), (1, "tail", 5.5, 2.25),
    (1, "collective", 40.0, 9.0), (1, "topk", 50.0, 12.5),
]
#: (device, direction, start µs, duration µs, bytes): host transfers
COPIES = [(0, "h2d", 33.0, 4.0, 4096), (1, "d2h", 30.0, 2.5, 16384),
          (0, "d2h", 62.0, 1.5, 64)]


def _write(tmp_path, name, trace_events) -> str:
    path = tmp_path / name
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": trace_events}, f)
    return str(path)


def reference_timeline(tmp_path) -> str:
    """The timeline in the reference's TPU device dialect."""
    out = [{"ph": "M", "pid": 100 + d, "name": "process_name",
            "args": {"name": f"/device:GPU:{d}"}} for d in (0, 1)]
    for d, kind, ts, dur in KERNELS:
        name, cat, _ = KINDS[kind]
        _stem, nbytes, flops = WORK.get(kind, (None, 0, 0))
        out.append({"ph": "X", "pid": 100 + d, "tid": 1, "name": name,
                    "ts": ts, "dur": dur,
                    "args": {"hlo_category": cat,
                             "device_duration_ps": dur * 1e6,
                             "bytes_accessed": nbytes,
                             "model_flops": flops}})
    for d, direction, ts, dur, nbytes in COPIES:
        out.append({"ph": "X", "pid": 100 + d, "tid": 2,
                    "name": "MemcpyH2D" if direction == "h2d"
                    else "MemcpyD2H", "ts": ts, "dur": dur,
                    "args": {"bytes": nbytes}})
    return _write(tmp_path, "reference.trace.json.gz", out)


def kineto_timeline(tmp_path) -> str:
    """The same timeline as torch.profiler exports it from a card."""
    out = [{"ph": "M", "pid": d, "name": "process_name",
            "args": {"name": "python3"}} for d in (0, 1)]
    for d, kind, ts, dur in KERNELS:
        out.append({"ph": "X", "cat": "kernel", "pid": d, "tid": 7,
                    "name": KINDS[kind][2], "ts": ts, "dur": dur,
                    "args": {"device": d, "stream": 7, "correlation": 1}})
    for d, direction, ts, dur, nbytes in COPIES:
        out.append({"ph": "X", "cat": "gpu_memcpy", "pid": d, "tid": 7,
                    "name": "Memcpy HtoD (Pageable -> Device)"
                    if direction == "h2d" else
                    "Memcpy DtoH (Device -> Pageable)", "ts": ts,
                    "dur": dur, "args": {"device": d, "stream": 7,
                                         "bytes": nbytes}})
    # the host's runtime calls and the session's span are not the card's
    out.append({"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 1,
                "name": "cudaLaunchKernel", "ts": 0.0, "dur": 70.0,
                "args": {}})
    out.append({"ph": "X", "cat": "Trace", "pid": "Spans",
                "tid": "PyTorch Profiler", "name": "PyTorch Profiler (0)",
                "ts": -5.0, "dur": 80.0, "args": {}})
    return _write(tmp_path, "kineto.pt.trace.json.gz", out)


def kineto_work() -> dict:
    """The work ledger's table for the Kineto timeline: each hand
    kernel's launches with the reference's bytes and flops a launch."""
    out = {}
    for _d, kind, _ts, _dur in KERNELS:
        if kind in WORK:
            stem, nbytes, flops = WORK[kind]
            row = out.setdefault(stem, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += nbytes
            row[2] += flops
    return out


_LIVE = {}


def live_capture():
    """Arm → plan → parse ONCE a session on the reference's budget
    fixture, on the CPU, with the mesh observatory attached; every live
    test reads the same artifacts and journal."""
    if _LIVE:
        return _LIVE
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.telemetry import kernel_budget as kb
    from cruise_control_tpu_torch.telemetry import mesh_budget as mb

    fx = budget_fixture()
    results = []
    real_scan_call = C._scan_call

    def spy(*a, **k):
        out = real_scan_call(*a, **k)
        results.append(out[0])
        return out

    journal = EventJournal(enabled=True)
    prev = events.JOURNAL
    events.JOURNAL = journal
    kb.CAPTURE.reset()
    mb.MESH.reset()
    mb.MESH.attach(kb.CAPTURE)
    C._scan_call = spy
    try:
        opt = C.CudaGoalOptimizer(
            config=C.CudaSearchConfig(**{k: fx[k] for k in CFG_KEYS}),
            device="cpu")
        armed = kb.arm(scans=fx["scans"], reason="test")
        result = opt.optimize(random_cluster(
            **{k: fx[k] for k in CLUSTER_KEYS}))
        parsed = kb.parse_pending(max_parses=4)
    finally:
        C._scan_call = real_scan_call
        events.JOURNAL = prev
    _LIVE.update(
        armed=armed, artifact=kb.latest(), mesh=mb.latest(), parsed=parsed,
        result=result, journal=journal.recent(), state=kb.CAPTURE.state(),
        scans=results[:fx["scans"]], fixture=fx)
    # the observatories are process-wide: the next test file in this
    # process starts from no capture
    kb.CAPTURE.reset()
    mb.MESH.reset()
    return _LIVE


def profiler_records(journal):
    """The journal's profiler.* records, as kind and payload."""
    return [(e["kind"], e["payload"]) for e in journal
            if e["kind"].startswith("profiler.")]

"""The port's build / capture / live-buffer observatory
(``telemetry/device_stats.py``) and its per-executable cost
(``telemetry/device_cost.py``): the retrace detector over step-loop keys,
kernel builds and loads counted as compiles with the build cache's
counters, the live-buffer gauges under the reference's names feeding the
SLO objective, the cost of a captured chunk from its launches' work, the
card's bandwidth, the ``/metrics`` families and the flight recorder's
merge — each beside the reference's behaviour where they share it."""

import ctypes.util
import json
from pathlib import Path

import pytest

from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.telemetry import (
    device_cost,
    device_stats,
    kernel_budget,
    mesh_budget,
)
from cruise_control_tpu_torch.telemetry.device_cost import DeviceCostMonitor
from cruise_control_tpu_torch.telemetry.device_stats import (
    DeviceStatsMonitor,
)
from cruise_control_tpu_torch.utils.metrics import MetricRegistry
from test_artifact_schemas import SCHEMAS, validate


def test_retrace_detector_counts_distinct_loop_keys():
    from cruise_control_tpu.telemetry.device_stats import (
        DeviceStatsMonitor as RefMonitor,
    )

    port, ref = DeviceStatsMonitor(retrace_threshold=2), RefMonitor(
        retrace_threshold=2)
    for key in ("k1", "k1", "k2", "k3", "k4", "k2"):
        for mon in (port, ref):
            mon.record_compile("analyzer.scan_fn", 0.25, (key,))
    assert port.per_function() == ref.per_function()
    assert port.per_function()["analyzer.scan_fn"] == {
        "compiles": 6, "compileSec": 1.5, "distinctShapes": 4,
        "retraces": 3}
    assert port.totals() == {"jit.compiles": 6.0, "jit.compile.seconds": 1.5,
                             "jit.retraces": 3.0}
    port.configure(enabled=False)
    port.record_compile("analyzer.scan_fn", 1.0, ("k9",))
    assert port.per_function()["analyzer.scan_fn"]["compiles"] == 6


def test_kernel_loads_count_as_compiles_and_cache_hits(monkeypatch):
    """A library found built is a persistent-cache hit; one the process
    built is a miss, its nvcc seconds charged to its first load."""
    libm = ctypes.util.find_library("m") or "libm.so.6"
    mon = DeviceStatsMonitor()
    monkeypatch.setattr(device_stats, "MONITOR", mon)
    monkeypatch.setattr(kernels, "build",
                        lambda names: {n: Path(libm) for n in names})
    try:
        kernels.load("probe_found")
        kernels._built_s["probe_built"] = 2.5
        kernels.load("probe_built")
        kernels.load("probe_built")          # loaded: no second compile
    finally:
        for n in ("probe_found", "probe_built"):
            kernels._loaded.pop(n, None)
            kernels._built_s.pop(n, None)
    per = mon.per_function()
    assert per["ops.kernels.probe_found"]["compiles"] == 1
    assert per["ops.kernels.probe_built"]["compiles"] == 1
    assert per["ops.kernels.probe_built"]["compileSec"] >= 2.5
    assert (mon.persistent_cache_hits, mon.persistent_cache_misses) == (1, 1)


def test_live_buffer_gauges_feed_the_slo_objective():
    """The gauges carry the reference's names, so the copied SLO objective
    ``memory.live.buffer.mb`` has data (0 MB without a card)."""
    from cruise_control_tpu_torch.telemetry.slo import evaluate_slos

    registry = MetricRegistry()
    DeviceStatsMonitor().install_gauges(registry)
    snap = registry.snapshot()
    assert {"jax.live.buffers", "jax.live.buffer.bytes"} <= set(
        snap["gauges"])
    report = evaluate_slos([], snap, now=0.0)
    row = next(r for r in report.rows if r.name == "memory.live.buffer.mb")
    assert row.measured is not None and row.ok is True
    empty = evaluate_slos([], MetricRegistry().snapshot(), now=0.0)
    assert next(r for r in empty.rows
                if r.name == "memory.live.buffer.mb").measured is None


def test_device_cost_of_a_chunk_from_its_work():
    mon = DeviceCostMonitor()
    work = {"grid_top_r": [16, 16 * 4096.0, 16 * 500.0],
            "commit_batch": [16, 16 * 256.0, 16 * 40.0]}
    sig = ("cpu", 40, 3, 8)
    mon.note_compile("analyzer.scan_fn", sig, device_cost.work_source(
        work, arg_bytes=1 << 20, output_bytes=4096, temp_bytes=0))
    assert mon.known("analyzer.scan_fn", sig) and mon.pending() == 1
    mon.note_call("analyzer.scan_fn", 60)
    assert mon.capture_pending(max_captures=4) == 1
    entry = mon.summary(detail=True)["functions"]["analyzer.scan_fn"]
    assert entry["bytesAccessed"] == 16 * (4096 + 256)
    assert entry["flops"] == 16 * 540
    assert (entry["argBytes"], entry["outputBytes"], entry["calls"]) == (
        1 << 20, 4096, 60)
    assert entry["perExecutable"][0]["signature"] == repr(sig)
    assert mon.hbm_utilization() == pytest.approx(
        16 * 4352 * 1.0 / (3350.0 * 1e9))
    fams = {f[0] for f in mon.families()}
    assert {"cc_device_flops", "cc_device_bytes_accessed",
            "cc_device_hbm_arg_bytes", "cc_device_call_rate_per_s",
            "cc_device_hbm_utilization_estimate"} <= fams
    # a failing source is counted, never raised
    mon.note_compile("whatif.verdict_fn", ("x",), lambda: 1 / 0)
    assert mon.capture_pending() == 0 and mon.capture_failures == 1


def test_rounds_and_whatif_calls_are_costed_and_ledgered(monkeypatch):
    """The score-only round and the what-if call are executables too:
    each call counted, its first call of a shape queued for a cost
    capture, and their reads through the transfer ledger."""
    from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
    from cruise_control_tpu_torch.models.generators import random_cluster
    from cruise_control_tpu_torch.whatif import compile_futures
    from cruise_control_tpu_torch.whatif.engine import evaluate_batch
    from cruise_control_tpu_torch.whatif.futures import likely_futures

    cost, mesh = DeviceCostMonitor(), mesh_budget.MeshObservatory()
    monkeypatch.setattr(device_cost, "MONITOR", cost)
    monkeypatch.setattr(mesh_budget, "MESH", mesh)
    state = random_cluster(seed=4, num_brokers=8, num_racks=4,
                           num_partitions=40)
    result = C.CudaGoalOptimizer(config=C.CudaSearchConfig(
        steps_per_call=0, max_rounds=3), device="cpu").optimize(state)
    rounds = result.goal_summaries[0]["rounds"]
    batch = compile_futures(state, likely_futures(state, k=4))
    evaluate_batch(state, batch, device="cpu")
    evaluate_batch(state, batch, device="cpu")
    per = cost.per_function()
    assert per[C.ROUND_FN]["calls"] == rounds >= 1
    assert per["whatif.verdict_fn"]["calls"] == 2
    # one shape each: one queued capture each
    assert cost.pending() == 2 and cost.capture_pending(4) == 2
    ledger = mesh.ledger.snapshot()
    assert ledger["analyzer.round_fetch"]["d2h_count"] == rounds
    assert ledger["whatif.verdict_fetch"]["d2h_count"] == 2 * 13
    assert ledger["analyzer.constraints_upload"]["h2d_count"] == 1


def test_the_cards_bandwidth_is_the_default():
    from cruise_control_tpu_torch.config.cruise_control_config import (
        CruiseControlConfig,
    )

    assert DeviceCostMonitor().hbm_gbps == 3350.0
    assert CruiseControlConfig().get_double(
        "telemetry.device.cost.hbm.gbps") == 3350.0
    assert kernel_budget.HBM_BYTES_PER_S == 3350.0 * 1e9


def _artifact_with_transfers():
    art = {"by_bucket": {"grid_topk": {"count_per_unit": 2.0,
                                       "us_per_unit": 30.0,
                                       "mb_per_unit": 0.01}},
           "hbm_utilization_of_busy": 0.125,
           "devices": {"busy_ms": {"/device:GPU:0": 0.03}, "skew": 1.0}}
    mesh = {"collectives": {"by_op": {}},
            "transfers": {"trace": {"d2h": {"bytes": 64, "time_ms": 0.01}},
                          "ledger": {"by_fn": {"analyzer.scan_fetch": {
                              "h2d_count": 0, "h2d_bytes": 0, "h2d_ms": 0.0,
                              "d2h_count": 1, "d2h_bytes": 64,
                              "d2h_ms": 0.02}}}},
            "wall": {"host_gap_ms": 0.5}}
    return art, mesh


def test_metrics_render_the_device_families(monkeypatch):
    from cruise_control_tpu_torch.telemetry.exposition import (
        render_prometheus,
    )
    from cruise_control_tpu_torch.telemetry.tracing import Telemetry

    stats, cost = DeviceStatsMonitor(), DeviceCostMonitor()
    capture = kernel_budget.CaptureManager()
    mesh = mesh_budget.MeshObservatory()
    for mod, name, obj in ((device_stats, "MONITOR", stats),
                           (device_cost, "MONITOR", cost),
                           (kernel_budget, "CAPTURE", capture),
                           (mesh_budget, "MESH", mesh)):
        monkeypatch.setattr(mod, name, obj)
    stats.record_compile("analyzer.scan_fn", 0.5, ("k",))
    stats.note_persistent_get(hit=True)
    cost.note_compile("analyzer.scan_fn", ("k",), device_cost.work_source(
        {"grid_top_r": [1, 10.0, 2.0]}))
    cost.capture_pending()
    capture._latest, mesh._latest = _artifact_with_transfers()
    body = render_prometheus(MetricRegistry(), Telemetry(enabled=True))
    for line in ('cc_jit_compile_total{fn="analyzer.scan_fn"} 1',
                 'cc_jit_compile_total{fn="all"} 1',
                 "cc_jit_persistent_cache_hits_total 1",
                 'cc_device_bytes_accessed{fn="analyzer.scan_fn"} 10',
                 'cc_kernel_busy_ms{category="grid_topk"} 0.03',
                 "cc_kernel_hbm_utilization_measured 0.125",
                 'cc_shard_busy_ms{device="/device:GPU:0"} 0.03',
                 'cc_transfer_bytes{direction="d2h",'
                 'fn="analyzer.scan_fetch"} 64',
                 "cc_mesh_host_gap_ms 0.5"):
        assert line in body, line
    assert "# HELP cc_jit_compile_total Kernel library builds" in body


def test_flight_recorder_merges_the_observatories():
    from cruise_control_tpu_torch.telemetry.recorder import FlightRecorder

    stats, cost = DeviceStatsMonitor(), DeviceCostMonitor()
    capture = kernel_budget.CaptureManager()
    mesh = mesh_budget.MeshObservatory()
    capture._latest, mesh._latest = _artifact_with_transfers()

    def device_summary():
        out = stats.summary()
        out["deviceCost"] = cost.summary(detail=True)
        return out

    rec = FlightRecorder(MetricRegistry(), interval_s=60.0, retention=8,
                         device_stats_source=device_summary,
                         kernel_budget_source=capture.summary,
                         mesh_budget_source=mesh.summary,
                         extra_sources=[stats.totals])
    art = rec.artifact()
    validate(json.loads(json.dumps(art)),
             SCHEMAS["cc-tpu-flight-recorder/1"])
    assert art["deviceStats"]["deviceCost"]["hbmGbps"] == 3350.0
    assert art["kernelBudget"]["latest"]["hbm_utilization_of_busy"] == 0.125
    assert art["kernelBudget"]["state"] == "IDLE"
    assert art["meshBudget"]["latest"]["wall"]["host_gap_ms"] == 0.5

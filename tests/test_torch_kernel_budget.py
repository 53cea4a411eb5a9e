"""The port's kernel observatory (``telemetry/kernel_budget.py``) held to
the reference's: the pure functions give the same outputs on the same
inputs; one synthetic timeline written in the reference's device dialect
and in Kineto's parses to the same buckets, per-unit numbers and devices;
a live CPU capture of a port plan at the reference's budget fixture
(``tests/budgets/kernel_budget.json``, read as data) is schema-valid,
reconciles and journals deterministically; the search trace directory
traces without keying the step loop; one profiler session a process; a
scenario's journal under capture is bit-stable."""

import json
import os

import numpy as np
import pytest

import cruise_control_tpu.telemetry.kernel_budget as ref_kb
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.models.generators import random_cluster
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.telemetry import kernel_budget as kb
from test_artifact_schemas import SCHEMAS, validate
from torch_observatory_cases import (
    kineto_timeline,
    kineto_work,
    live_capture,
    profiler_records,
    reference_timeline,
)

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "cruise_control_tpu_torch", "csrc")


@pytest.fixture(autouse=True)
def _no_capture_left():
    """The observatories are process-wide: each test leaves no capture
    behind for the next test file in the process."""
    from cruise_control_tpu_torch.telemetry import mesh_budget

    yield
    kb.CAPTURE.reset()
    mesh_budget.MESH.reset()


def _intervals(rng, n):
    s = rng.integers(0, 100, n).astype(float) / 4
    return [(float(a), float(a + d)) for a, d in
            zip(s, rng.integers(-2, 30, n).astype(float) / 4)]


def test_interval_functions_match_the_reference():
    rng = np.random.default_rng(11)
    for n in (0, 1, 5, 40):
        a, b = _intervals(rng, n), _intervals(rng, n + 3)
        assert kb.merge_intervals(a) == ref_kb.merge_intervals(a)
        ma, mb = kb.merge_intervals(a), kb.merge_intervals(b)
        assert kb.overlap_us(ma, mb) == ref_kb.overlap_us(ma, mb)


def test_classify_collective_matches_the_reference():
    names = ["all-reduce.12", "all-gather-start.3", "all-gather-done.3",
             "reduce-scatter", "collective-permute.1", "all-to-all.9",
             "fusion.3", "all-reduce-fusion.2", "ALL-REDUCE.4", "sort.1",
             "grid_top_r_kernel", ""]
    assert [kb.classify_collective(n) for n in names] == \
        [ref_kb.classify_collective(n) for n in names]


def test_compare_budget_matches_the_reference():
    fx = {"seed": 7, "scans": 2}
    art = {"unit": "scan-call", "per_unit": {"kernels": 120.0},
           "fixture": fx,
           "by_bucket": {"grid_topk": {"count_per_unit": 30.0},
                         "auction": {"count_per_unit": 11.0}}}
    budgets = [
        {"total_kernels_per_unit": 120, "by_bucket": {
            "grid_topk": {"count_per_unit": 30}}},
        {"total_kernels_per_unit": 100, "tolerance_pct": 5, "by_bucket": {
            "grid_topk": {"count_per_unit": 20},
            "auction": {"count_per_unit": 10},
            "scan_loop": {"count_per_unit": 1}}},
        {"total_kernels_per_unit": 1, "fixture": {"seed": 8}},
    ]
    for budget in budgets:
        assert kb.compare_budget(art, budget) == \
            ref_kb.compare_budget(art, budget)
    assert kb.compare_budget(art, budgets[0]) == []


def test_synthetic_timeline_parses_alike_in_both_dialects(tmp_path):
    """The reference's TPU device track and Kineto's kernel records of
    the same timeline: the same rows by bucket, per-unit numbers and
    per-device busy (to 1e-9); the floors differ only by the chips'
    roofline constants."""
    ref = ref_kb.parse_trace(reference_timeline(tmp_path))
    port = kb.parse_trace(kineto_timeline(tmp_path), work=kineto_work())
    assert (ref.dialect, port.dialect) == ("device", "device")
    for attr in ("total_time_us", "total_bytes", "total_flops",
                 "total_count"):
        assert getattr(port, attr) == pytest.approx(getattr(ref, attr),
                                                    abs=1e-9), attr
    assert port.device_busy_us.keys() == ref.device_busy_us.keys()
    for k, v in ref.device_busy_us.items():
        assert port.device_busy_us[k] == pytest.approx(v, abs=1e-9)
    assert port.skew() == pytest.approx(ref.skew(), abs=1e-9)
    a_ref = ref_kb.build_artifact(ref, units=2, backend="x", now=0.0)
    a_port = kb.build_artifact(port, units=2, backend="x", now=0.0,
                               chip="card")
    assert a_port["by_bucket"] == a_ref["by_bucket"]
    assert a_port["devices"] == a_ref["devices"]
    for key in ("kernels", "device_busy_ms", "bytes_mb", "model_gflops"):
        assert a_port["per_unit"][key] == a_ref["per_unit"][key], key
    ref_hw, port_hw = a_ref["hw"], a_port["hw"]
    assert port_hw["hbm_bytes_per_s"] == kernels.HBM_BYTES_PER_S == 3.35e12
    assert port_hw["peak_f32_flops"] == kernels.PEAK_F32_FLOPS == 67e12
    bytes_per_unit = port.total_bytes / 2
    assert a_port["per_unit"]["hbm_floor_ms"] == round(
        bytes_per_unit / port_hw["hbm_bytes_per_s"] * 1e3, 4)
    assert a_ref["per_unit"]["hbm_floor_ms"] == round(
        bytes_per_unit / ref_hw["hbm_bytes_per_s"] * 1e3, 4)
    validate(json.loads(json.dumps(a_port)), SCHEMAS[kb.SCHEMA])
    # the hand kernels' rows carry their work models' bytes
    rows = {r.category: r for r in port.rows}
    assert rows["grid_top_r"].bytes == 3 * 4096
    assert rows["compact_rows"].flops == 2 * 64
    # the ledger's launches match the trace's records one for one
    assert a_port["dropped_records"] == {}


def test_host_dialect_self_time_lanes_and_buckets(tmp_path):
    """The CPU dialect: nested host ops give their parents self time
    only, each host thread is a lane, and ops bucket by name alone."""
    import gzip

    def op(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "cpu_op", "pid": 9, "tid": tid,
                "name": name, "ts": ts, "dur": dur, "args": {}}

    path = tmp_path / "host.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": [
            op("aten::matmul", 0.0, 100.0), op("aten::mm", 10.0, 60.0),
            op("aten::sort", 120.0, 30.0), op("aten::gather", 160.0, 10.0),
            op("aten::topk", 0.0, 40.0, tid=2),
            {"ph": "X", "cat": "cuda_runtime", "pid": 9, "tid": 1,
             "name": "cudaLaunchKernel", "ts": 0.0, "dur": 5.0}]}, f)
    parsed = kb.parse_trace(str(path))
    assert parsed.dialect == "host-thunk"
    rows = {r.name: r for r in parsed.rows}
    assert rows["aten::matmul"].time_us == pytest.approx(40.0)
    assert rows["aten::mm"].time_us == pytest.approx(60.0)
    assert {n: r.bucket for n, r in rows.items()} == {
        "aten::matmul": "long_tail", "aten::mm": "long_tail",
        "aten::sort": "grid_topk", "aten::topk": "grid_topk",
        "aten::gather": "move_vec_build"}
    assert parsed.device_busy_us == pytest.approx(
        {"cpu-lane-0": 140.0, "cpu-lane-1": 40.0})


def test_classify_bucket_covers_every_hand_kernel():
    stems = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    assert sorted(kb.KERNEL_BUCKETS) == stems
    assert set(kb.KERNEL_BUCKETS.values()) <= set(kb.BUCKETS)
    for name, stem in (
            ("void grid_top_r_kernel<8, true>(float const*)", "grid_top_r"),
            ("grid_terms_rows_kernel<3, false>", "grid_terms"),
            ("round_pack_keys_kernel(float const*)", "round_pack"),
            ("recompute_aggregates_scatter_kernel", "recompute_aggregates"),
            ("whatif_verdict_sort_count_kernel", "whatif_verdict"),
            ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
            ("void at::native::radixSortKVInPlace<float>()", None)):
        assert kb.kernel_stem(name) == stem, name
        want = kb.KERNEL_BUCKETS[stem] if stem else "long_tail"
        assert kb.classify_bucket(name, stem or "torch") == want


def test_live_capture_is_schema_valid_and_reconciles():
    live = live_capture()
    art, fx = live["artifact"], live["fixture"]
    assert live["armed"]["state"] == "ARMED" and live["parsed"] == 1
    validate(json.loads(json.dumps(art)), SCHEMAS[kb.SCHEMA])
    assert (art["source"], art["unit"], art["units"], art["dialect"]) == (
        "live-capture", "scan-call", fx["scans"], "host-thunk")
    assert art["capture"]["scansTraced"] == fx["scans"]
    assert art["hw"]["chip"] == "cpu"
    # the CPU launches no hand kernel: no record can be missing
    assert art["dropped_records"] == {}
    populated = [b for b, v in art["by_bucket"].items()
                 if v["count_per_unit"] > 0]
    assert len(populated) >= 3 and art["per_unit"]["device_busy_ms"] > 0
    # THE reconciliation invariant: bucket self-times partition busy
    bucket_ms = sum(v["us_per_unit"] for v in art["by_bucket"].values())
    assert bucket_ms / 1e3 == pytest.approx(
        art["per_unit"]["device_busy_ms"], rel=1e-3)
    assert sum(v["share_of_busy"] for v in art["by_bucket"].values()) == \
        pytest.approx(1.0, abs=1e-2)
    busy = sum(art["devices"]["busy_ms"].values())
    assert busy / fx["scans"] == pytest.approx(
        art["per_unit"]["device_busy_ms"], rel=1e-3)


def test_live_capture_journals_deterministically():
    """The capture's records name no path and no time: a second capture
    after a reset journals the same payloads, and the plan is the one an
    unarmed search makes."""
    live = live_capture()
    recs = profiler_records(live["journal"])
    kinds = [k for k, _ in recs]
    assert kinds == ["profiler.capture.start", "profiler.capture.end",
                     "profiler.mesh.parsed"]
    fx = live["fixture"]
    assert recs[0][1] == {"captureId": "capture-1", "scans": fx["scans"],
                          "reason": "test"}
    assert recs[1][1] == {"captureId": "capture-1",
                          "scansTraced": fx["scans"],
                          "stopReason": "scans-complete"}
    plain = C.CudaGoalOptimizer(
        config=C.CudaSearchConfig(**{k: fx[k] for k in (
            "steps_per_call", "repool_steps", "device_batch_per_step",
            "max_source_replicas", "max_dest_brokers",
            "repool_rows_budget")}), device="cpu").optimize(random_cluster(
                **{k: fx[k] for k in ("seed", "num_brokers", "num_racks",
                                      "num_partitions")}))
    assert [a.__dict__ for a in plain.actions] == \
        [a.__dict__ for a in live["result"].actions]


def test_work_ledger_records_exclusively_and_adds_replays():
    ledger = kernels.WorkLedger()
    outer = ledger.open()
    ledger.note("grid_top_r", 100, 10)
    with ledger.recording(exclusive=True) as chunk:
        ledger.note("grid_top_r", 7, 1)
        ledger.note("grid_top_r", 7, 1)
        ledger.note("commit_batch", 3, 2)
    assert outer == {"grid_top_r": [1, 100, 10]}
    assert chunk == {"grid_top_r": [2, 14, 2], "commit_batch": [1, 3, 2]}
    ledger.add(chunk, times=3)
    assert outer == {"grid_top_r": [7, 142, 16], "commit_batch": [3, 9, 6]}
    ledger.close(outer)
    assert ledger.active == []
    # a wrapper's note evaluates its work model only while one records
    calls = []
    kernels.note_work("pool_tables", lambda: calls.append(1) or (1, 1))
    assert calls == []
    with kernels.WORK.recording() as rec:
        kernels.note_work("pool_tables", lambda: calls.append(1) or (2, 3))
    assert calls == [1] and rec == {"pool_tables": [1, 2, 3]}


def test_profiler_trace_dir_is_not_a_loop_key(tmp_path):
    """The trace directory is telemetry, not search state: a search with
    it set runs on the step loop the search without it kept."""
    kb.CAPTURE.reset()
    state = random_cluster(seed=3, num_brokers=8, num_racks=4,
                           num_partitions=40)
    cfg = dict(steps_per_call=4, max_source_replicas=64,
               max_dest_brokers=8)
    C._LOOPS.clear()
    C.CudaGoalOptimizer(config=C.CudaSearchConfig(**cfg),
                        device="cpu").optimize(state)
    key, loop = C._LOOPS["cpu"]
    C.CudaGoalOptimizer(config=C.CudaSearchConfig(
        **cfg, profiler_trace_dir=str(tmp_path / "legacy")),
        device="cpu").optimize(state)
    assert C._LOOPS["cpu"][0] == key and C._LOOPS["cpu"][1] is loop
    assert kb.parse_pending(max_parses=4) == 1
    assert kb.latest()["source"] == "legacy-trace-dir"
    kb.CAPTURE.reset()


def test_one_profiler_session_a_process():
    """A second session is refused: a nested profiler_session raises, and
    an armed capture under a running session gives up its trace (said in
    its state) while the plan it rode goes on."""
    kb.CAPTURE.reset()
    state = random_cluster(seed=3, num_brokers=6, num_racks=3,
                           num_partitions=20)
    opt = C.CudaGoalOptimizer(config=C.CudaSearchConfig(steps_per_call=4),
                              device="cpu")
    with kb.profiler_session():
        with pytest.raises(RuntimeError, match="already running"):
            with kb.profiler_session():
                pass
        kb.arm(scans=1, reason="test")
        result = opt.optimize(state)
    st = kb.CAPTURE.state()
    assert result.actions and st["state"] == "IDLE"
    assert st["refusals"] == 1 and "already running" in st["lastError"]
    assert st["pendingParses"] == 0
    kb.CAPTURE.reset()


def test_scenario_capture_is_fingerprint_stable():
    """A scenario on engine "cuda" that arms the observatory journals
    deterministic profiler.capture.* records (virtual clock, sim-capture-N
    ids): two runs fingerprint bit-identically, the capture in both."""
    from cruise_control_tpu_torch.sim import ScenarioSpec, run_scenario
    from cruise_control_tpu_torch.sim.timeline import (
        Timeline,
        hot_partition_skew,
    )

    def spec():
        return ScenarioSpec(
            name="kernel_capture_probe",
            description="deterministic capture under a warm heal",
            timeline=Timeline([hot_partition_skew(
                2 * 60_000, factor=12.0, partitions=[0, 1, 2, 3])]),
            self_healing={"goal_violation": True},
            engine="cuda",
            kernel_capture_scans=1,
            duration_ms=10 * 60_000,
        )

    a = run_scenario(spec(), device="cpu")
    b = run_scenario(spec(), device="cpu")
    kinds = [e["kind"] for e in a.journal]
    assert "profiler.capture.start" in kinds
    assert "profiler.capture.end" in kinds
    start = next(e for e in a.journal
                 if e["kind"] == "profiler.capture.start")
    assert start["payload"]["captureId"] == "sim-capture-1"
    assert a.fingerprint() == b.fingerprint()

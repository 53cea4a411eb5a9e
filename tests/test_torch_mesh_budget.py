"""The port's mesh observatory (``telemetry/mesh_budget.py``) held to the
reference's: the pure functions give the same outputs on the same inputs;
one synthetic timeline in the reference's device dialect and in Kineto's
gives the same exact wall partition, transfers and collectives; a live CPU
capture of a port plan partitions its window exactly and its transfer
ledger names the scan's fetches with their bytes; the replication audit
and the sanctioned transfer entry points."""

import json

import numpy as np
import pytest
import torch

import cruise_control_tpu.telemetry.mesh_budget as ref_mb
from cruise_control_tpu_torch.telemetry import mesh_budget as mb
from test_artifact_schemas import SCHEMAS, validate
from torch_observatory_cases import (
    kineto_timeline,
    live_capture,
    reference_timeline,
)


def test_classify_transfer_matches_the_reference():
    names = ["MemcpyH2D", "TransferToDevice", "BufferFromHostBuffer.3",
             "copy-to-device", "infeed.1", "MemcpyD2H", "TransferFromDevice",
             "CopyRawToHost", "ToLiteral", "outfeed", "copy.12", "fusion.4",
             "Memcpy HtoD (Pageable -> Device)", ""]
    assert [mb.classify_transfer(n) for n in names] == \
        [ref_mb.classify_transfer(n) for n in names]


def test_kineto_classifiers():
    assert mb.kineto_transfer("Memcpy HtoD (Pageable -> Device)") == "h2d"
    assert mb.kineto_transfer("Memcpy DtoH (Device -> Pinned)") == "d2h"
    assert mb.kineto_transfer("Memcpy DtoD (Device -> Device)") is None
    assert mb.kineto_collective(
        "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    ) == "all-gather"
    assert mb.kineto_collective("ncclKernel_ReduceScatter_Sum_f32") == \
        "reduce-scatter"
    assert mb.kineto_collective("all-reduce.3") == "all-reduce"
    assert mb.kineto_collective("grid_top_r_kernel(float const*)") is None


def test_sweep_matches_the_reference():
    rng = np.random.default_rng(5)
    classes = ("busy", "transfer", "collective")
    for n in (0, 1, 7, 60):
        starts = rng.integers(-20, 400, n) / 4
        classed = [(float(s), float(s + d), classes[c]) for s, d, c in zip(
            starts, rng.integers(0, 80, n) / 4, rng.integers(0, 3, n))]
        window = (0.0, 100.0 + n)
        got, want = mb._sweep(window, classed), ref_mb._sweep(window,
                                                               classed)
        assert got.__dict__ == want.__dict__
        assert got.busy_us + got.collective_us + got.transfer_us \
            + got.gap_us == pytest.approx(got.wall_us, abs=1e-9)


def test_transfer_ledger_delta_matches_the_reference():
    row = {"h2d_count": 2, "h2d_bytes": 64, "h2d_us": 1.5,
           "d2h_count": 5, "d2h_bytes": 400, "d2h_us": 3.0}
    now = {"a": dict(row), "b": dict(row, d2h_count=6, d2h_bytes=480),
           "c": dict(row, h2d_count=1)}
    for base in (None, {}, {"a": dict(row), "b": dict(row)},
                 {"c": dict(row, h2d_count=0, d2h_count=0)}):
        assert mb.TransferLedger.delta(now, base) == \
            ref_mb.TransferLedger.delta(now, base)


def test_compare_mesh_budget_matches_the_reference():
    art = {"unit": "scan-call", "units": 2,
           "collectives": {"by_op": {"all-reduce": {"count_per_unit": 3.0},
                                     "all-gather": {"count_per_unit": 1.0}}},
           "transfers": {"trace": {"d2h": {"count_per_unit": 12.0}},
                         "ledger": {"by_fn": {
                             "analyzer.scan_fetch": {"d2h_count": 4},
                             "analyzer.new_site": {"h2d_count": 1}}}}}
    budgets = [{}, {"collective_ops": {"all-reduce": 2},
                    "transfer_trace": {"d2h": 11},
                    "ledger_fns": {"analyzer.scan_fetch": {
                        "d2h_count_per_unit": 1}}},
               {"tolerance_pct": 400, "collective_ops": {"all-reduce": 2,
                                                         "all-gather": 1},
                "transfer_trace": {"d2h": 11},
                "ledger_fns": {"analyzer.scan_fetch": {
                    "d2h_count_per_unit": 2},
                    "analyzer.new_site": {"h2d_count_per_unit": 1}}}]
    for budget in budgets:
        assert mb.compare_mesh_budget(art, budget) == \
            ref_mb.compare_mesh_budget(art, budget)


def test_synthetic_timeline_partitions_alike_in_both_dialects(tmp_path):
    ref = ref_mb.parse_mesh_trace(reference_timeline(tmp_path))
    port = mb.parse_mesh_trace(kineto_timeline(tmp_path))
    assert (ref.dialect, port.dialect) == ("device", "device")
    assert port.window_us == pytest.approx(ref.window_us, abs=1e-9)
    assert port.devices.keys() == ref.devices.keys()
    for label, d in ref.devices.items():
        for key, v in d.__dict__.items():
            assert getattr(port.devices[label], key) == pytest.approx(
                v, abs=1e-9), (label, key)
        p = port.devices[label]
        assert p.busy_us + p.collective_us + p.transfer_us + p.gap_us == \
            pytest.approx(p.wall_us, abs=1e-9)
    assert port.transfers == ref.transfers
    assert {k: (v["count"], v["time_us"]) for k, v in
            port.collectives.items()} == {
        k: (v["count"], v["time_us"]) for k, v in ref.collectives.items()}
    a_port = mb.build_mesh_artifact(port, units=1, backend="x", now=0.0)
    a_ref = ref_mb.build_mesh_artifact(ref, units=1, backend="x", now=0.0)
    assert a_port["wall"] == a_ref["wall"]
    assert a_port["devices"] == a_ref["devices"]
    validate(json.loads(json.dumps(a_port)), SCHEMAS[mb.SCHEMA])


def test_live_capture_partitions_its_window_and_names_the_fetches():
    """The mesh artifact of the live capture: schema-valid, busy + gap ==
    wall exactly on each lane, and the transfer ledger's window — the
    traced scan calls — holds their packed fetches, byte for byte."""
    live = live_capture()
    art, fx = live["mesh"], live["fixture"]
    validate(json.loads(json.dumps(art)), SCHEMAS[mb.SCHEMA])
    assert art["dialect"] == "host-thunk" and art["units"] == fx["scans"]
    assert art["wall"]["reconciliation_pct"] == pytest.approx(100.0,
                                                              abs=1e-6)
    for d in art["devices"]["per_device"].values():
        assert d["busy_ms"] + d["collective_ms"] + d["transfer_ms"] \
            + d["gap_ms"] == pytest.approx(d["wall_ms"], abs=1e-3)
    by_fn = art["transfers"]["ledger"]["by_fn"]
    # a call's packed fetch: its commits' four rows and its steps' four
    # meta rows, f32
    want = sum((4 * int(r.step_counts.sum()) + 4 * len(r.step_counts)) * 4
               for r in live["scans"])
    assert by_fn["analyzer.scan_fetch"]["d2h_count"] == fx["scans"]
    assert by_fn["analyzer.scan_fetch"]["d2h_bytes"] == want
    assert by_fn["analyzer.scan_carry"]["d2h_count"] == sum(
        r.diag["host_syncs"] - 1 for r in live["scans"])
    assert art["collectives"]["by_op"] == {}
    assert art["replication"]["replicated_bytes"] == 0


def test_audit_replication_counts_each_storage_once():
    keep = torch.zeros(1000, dtype=torch.float32)
    view = keep[:10]
    audit = mb.audit_replication(max_arrays=1 << 20, device_type="cpu")
    validate(audit, SCHEMAS[mb.SCHEMA]["properties"]["replication"])
    assert audit["arrays"] >= 2 and not audit["truncated"]
    assert audit["single_device_bytes"] == audit["stored_bytes"] >= 4000
    assert audit["logical_bytes"] >= 4000 + 40
    assert audit["replicated_bytes"] == audit["sharded_bytes"] == 0
    small = mb.audit_replication(max_arrays=1, device_type="cpu")
    assert small["arrays"] == 1 and small["truncated"]
    # without a card, the card's audit walks nothing
    if not torch.cuda.is_available():
        assert mb.audit_replication()["arrays"] == 0
    del keep, view


def test_ledger_window_closes_with_the_trace(tmp_path):
    """The artifact's ledger holds what was read between the trace's
    start and finish, not what the search read after it stopped (the
    parse runs later, on the SLO tick)."""
    from cruise_control_tpu_torch.telemetry import events
    from cruise_control_tpu_torch.telemetry.events import EventJournal

    obs = mb.MeshObservatory()
    obs.ledger.note("d2h", "analyzer.scan_fetch", 100)
    obs.on_trace_start({"id": "capture-1"})
    obs.ledger.note("d2h", "analyzer.scan_fetch", 64)
    obs.on_trace_finish({"id": "capture-1"})
    obs.ledger.note("d2h", "analyzer.scan_fetch", 4096)
    prev, events.JOURNAL = events.JOURNAL, EventJournal(enabled=True)
    try:
        obs.on_parse(kineto_timeline(tmp_path),
                     {"id": "capture-1", "reason": "api",
                      "scansRequested": 1, "scansTraced": 1})
        parsed = [e for e in events.JOURNAL.recent()
                  if e["kind"] == "profiler.mesh.parsed"]
    finally:
        events.JOURNAL = prev
    row = obs.latest()["transfers"]["ledger"]["by_fn"]["analyzer.scan_fetch"]
    assert (row["d2h_count"], row["d2h_bytes"]) == (1, 64)
    assert parsed[0]["payload"] == {"captureId": "capture-1",
                                    "dialect": "device", "units": 1,
                                    "collectiveOps": ["all-reduce"]}


def test_sanctioned_entry_points_note_the_ledger():
    ledger = mb.TransferLedger()
    up = ledger.device_put(np.arange(6, dtype=np.float32), "cpu", fn="up")
    got = ledger.fetch(torch.arange(4, dtype=torch.int32), fn="down")
    ledger.note("d2h", "down", 8, 0.5)
    assert isinstance(up, torch.Tensor) and up.tolist() == list(range(6))
    assert isinstance(got, np.ndarray) and got.tolist() == [0, 1, 2, 3]
    snap = ledger.snapshot()
    assert (snap["up"]["h2d_count"], snap["up"]["h2d_bytes"]) == (1, 24)
    assert (snap["down"]["d2h_count"], snap["down"]["d2h_bytes"]) == (2, 24)
    assert snap["down"]["d2h_us"] >= 0.5e6
    ledger.enabled = False
    ledger.fetch(torch.zeros(3), fn="down")
    assert ledger.snapshot() == snap

"""The device observatories on the port's served path, as an operator
drives them: ``GET /profile/kernels`` and ``/profile/mesh`` answer 404
before the first capture, 202 to an arm and while it is in flight, 200
with a schema-valid artifact once the SLO tick (pumped here) parsed a
rebalance's capture, and 503 while disabled — as the reference's do;
``?audit=true`` runs the replication audit; ``GET /metrics`` renders the
device families; a trace short of its launches' kernel records says
so; and bootstrap no longer refuses the five keys that enable them
(ROADMAP A10)."""

import json
import urllib.error
import urllib.request

import pytest

from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.server.http_server import (
    CruiseControlHttpServer,
)
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.telemetry import kernel_budget as kb
from cruise_control_tpu_torch.telemetry import mesh_budget as mb
from cruise_control_tpu_torch.telemetry.events import EventJournal
from cruise_control_tpu_torch.tools.served_stack import full_stack
from test_artifact_schemas import SCHEMAS, validate
from torch_bootstrap_cases import PORT, SMALL, booted


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            raw = resp.read()
            return resp.status, (json.loads(raw or b"{}") if not
                                 url.endswith("/metrics") else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _rebalance(url):
    req = urllib.request.Request(
        f"{url}/rebalance?dryrun=true&get_response_timeout_s=120",
        method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=150) as resp:
        assert resp.status == 200


@pytest.fixture(scope="module")
def served():
    """The port's served stack on the CPU (the reference harness's skewed
    4-broker cluster), the mesh observatory attached, a fresh journal."""
    kb.CAPTURE.reset()
    mb.MESH.reset()
    mb.MESH.attach(kb.CAPTURE)
    cc, _backend, _reporter = full_stack(device="cpu")
    server = CruiseControlHttpServer(cc, port=0, access_log=False)
    server.start()
    prev, events.JOURNAL = events.JOURNAL, EventJournal(enabled=True)
    try:
        yield server
    finally:
        events.JOURNAL = prev
        server.stop()
        kb.CAPTURE.reset()
        mb.MESH.reset()


def test_kernels_ladder_404_202_200(served):
    url = served.url
    status, body = _get(f"{url}/profile/kernels")
    assert status == 404 and "arm=true" in body["errorMessage"]
    status, body = _get(f"{url}/profile/kernels?arm=true&scans=1")
    assert status == 202 and body["capture"]["state"] == "ARMED"
    status, body = _get(f"{url}/profile/kernels")
    assert status == 202 and body["capture"]["state"] == "ARMED"
    _rebalance(url)
    status, body = _get(f"{url}/profile/kernels")
    assert status == 202 and body["capture"]["pendingParses"] == 1
    # production pumps this from the SLO tick; tests pump directly
    assert kb.parse_pending(max_parses=4) == 1
    status, art = _get(f"{url}/profile/kernels")
    assert status == 200
    validate(art, SCHEMAS[kb.SCHEMA])
    assert art["capture"]["reason"] == "http" and art["units"] == 1
    bucket_ms = sum(v["us_per_unit"] for v in art["by_bucket"].values())
    assert bucket_ms / 1e3 == pytest.approx(
        art["per_unit"]["device_busy_ms"], rel=1e-3)


def test_mesh_ladder_and_audit(served):
    url = served.url
    kb.CAPTURE.reset()
    mb.MESH.reset()
    status, body = _get(f"{url}/profile/mesh")
    assert status == 404 and "arm=true" in body["errorMessage"]
    status, body = _get(f"{url}/profile/mesh?arm=true&scans=1")
    assert status == 202 and body["mesh"]["capture"]["state"] == "ARMED"
    _rebalance(url)
    assert kb.parse_pending(max_parses=4) == 1
    status, art = _get(f"{url}/profile/mesh")
    assert status == 200
    validate(art, SCHEMAS[mb.SCHEMA])
    assert art["wall"]["reconciliation_pct"] == pytest.approx(100.0,
                                                              abs=1e-6)
    assert art["transfers"]["ledger"]["by_fn"]["analyzer.scan_fetch"][
        "d2h_count"] == 1
    status, audit = _get(f"{url}/profile/mesh?audit=true")
    assert status == 200
    validate(audit, SCHEMAS[mb.SCHEMA]["properties"]["replication"])
    assert any(e["kind"] == "profiler.mesh.audit"
               for e in events.JOURNAL.recent())


def test_metrics_render_the_device_families(served):
    status, text = _get(f"{served.url}/metrics")
    assert status == 200
    for family in ("cc_jit_compile_total", "cc_jit_persistent_cache_hits",
                   "cc_kernel_busy_ms", "cc_kernel_count",
                   "cc_kernel_hbm_utilization_measured", "cc_shard_busy_ms",
                   "cc_transfer_bytes", "cc_mesh_host_gap_ms"):
        assert f"# TYPE {family}" in text, family
    assert 'fn="analyzer.scan_fetch"' in text


def test_observatories_answer_503_when_disabled(served):
    url = served.url
    kb.configure(enabled=False)
    try:
        for endpoint in ("profile/kernels", "profile/mesh"):
            status, body = _get(f"{url}/{endpoint}?arm=true")
            assert status == 503, endpoint
            assert "telemetry.kernel.enabled" in body["errorMessage"]
    finally:
        kb.configure(enabled=True)
    mb.configure(enabled=False)
    try:
        status, body = _get(f"{url}/profile/mesh")
        assert status == 503
        assert "telemetry.mesh.enabled" in body["errorMessage"]
    finally:
        mb.configure(enabled=True)


def test_a_trace_short_of_its_launches_reports_the_drop(served,
                                                      monkeypatch):
    """A trace that lacks kernel records of the launches the work ledger
    counted in its window says so, on the artifact, the capture state and
    ``/metrics`` (CUPTI has dropped records on the card, ROADMAP §C).
    Here each scan call notes one K1 launch that leaves no record."""
    url = served.url
    kb.CAPTURE.reset()
    mb.MESH.reset()
    real_scan_call = C._scan_call

    def unrecorded(*a, **k):
        out = real_scan_call(*a, **k)
        kernels.note_work("grid_top_r", lambda: (4096, 1000))
        return out
    monkeypatch.setattr(C, "_scan_call", unrecorded)
    assert _get(f"{url}/profile/kernels?arm=true&scans=1")[0] == 202
    _rebalance(url)
    assert kb.parse_pending(max_parses=4) == 1
    status, art = _get(f"{url}/profile/kernels")
    assert status == 200
    validate(art, SCHEMAS[kb.SCHEMA])
    assert art["dropped_records"] == {"grid_top_r": 1}
    assert kb.CAPTURE.state()["droppedRecords"] == 1
    status, text = _get(f"{url}/metrics")
    assert "cc_kernel_dropped_records_total 1.0" in text


def test_bootstrap_wires_the_five_keys(tmp_path):
    """The four toggles (on by default now) and the search trace
    directory build the app; its SLO tick pumps the cost captures and the
    parses, and its live-buffer objective has data."""
    props = {**SMALL, "telemetry.device.stats.enabled": "true",
             "telemetry.device.cost.enabled": "true",
             "telemetry.kernel.enabled": "true",
             "telemetry.mesh.enabled": "true",
             "tpu.search.profiler.trace.dir": str(tmp_path / "trace")}
    with booted(PORT, props) as app:
        cfg = app.cruise_control.cuda_config
        assert cfg.profiler_trace_dir == str(tmp_path / "trace")
        report = app.slo_engine.evaluate()
        row = next(r for r in report.rows
                   if r.name == "memory.live.buffer.mb")
        assert row.measured is not None
        assert kb.CAPTURE.enabled and mb.MESH.enabled

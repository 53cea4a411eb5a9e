"""The port's standalone server (``bootstrap.build_app`` and ``python -m
cruise_control_tpu_torch``) against the reference's
(``tests/test_security_bootstrap.py``).

The booted app serves REST and its dashboard (``GET /ui`` answered 500
before the port had ``server/ui.html``); ``load_properties`` and the
capacity and cluster-configs side files work as the reference's; a
non-default value of a key whose module or mode is not ported yet is
refused, naming its ROADMAP item, before any thread starts; without a card the entry point exits with the
device error before it binds its port.  Then the slice against the
reference: both packages' ``build_app`` on the same properties, the same
metric windows fed into both, the monitors' models equal (placement
exactly, loads within 1e-6 relative), both ``POST /rebalance`` dry-run
plans verified, the port's violation score within the parity bar of the
reference's (max(2, 5 %) above it), and ``POST /whatif``'s integer and
bool verdicts equal."""

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.client.cccli import CruiseControlClient
from cruise_control_tpu_torch.config.cruise_control_config import (
    ConfigException,
)

from torch_bootstrap_cases import (
    PKGS,
    PORT,
    REF,
    SMALL,
    booted,
    feed,
    module,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bootstrap_serves_rest_and_ui():
    with booted(PORT, SMALL) as app:
        app.server.start()
        feed(app)
        base = app.server.url
        state = json.load(urllib.request.urlopen(f"{base}/state"))
        assert state["MonitorState"]["state"] == "RUNNING"
        with urllib.request.urlopen(
                base.replace("/kafkacruisecontrol", "/ui")) as resp:
            assert resp.status == 200
            ui = resp.read().decode()
        assert "<title>cruise-control</title>" in ui
        assert "<option>cuda</option>" in ui and "<option>tpu" not in ui
        proposals = json.load(
            urllib.request.urlopen(f"{base}/proposals?json=true"))
        assert proposals["engine"] == "cuda" and "proposals" in proposals


def test_load_properties(tmp_path):
    from cruise_control_tpu_torch.bootstrap import load_properties

    f = tmp_path / "cc.properties"
    f.write_text("# comment\n! other comment\n\nwebserver.http.port=1234\n"
                 "default.goals=A,B\n")
    assert load_properties(str(f)) == {"webserver.http.port": "1234",
                                       "default.goals": "A,B"}


def test_bootstrap_reads_capacity_and_cluster_configs_files(tmp_path):
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType
    from cruise_control_tpu_torch.monitor.capacity import (
        BrokerCapacityConfigFileResolver,
    )

    cap = tmp_path / "capacity.json"
    cap.write_text(json.dumps({"brokerCapacities": [
        {"brokerId": -1, "capacity": {
            "DISK": 1e9, "CPU": 1e9, "NW_IN": 1e9, "NW_OUT": 1e9}}]}))
    cl = tmp_path / "clusterConfigs.json"
    cl.write_text(json.dumps({"replication.factor": 3}))
    with booted(PORT, {"capacity.config.file": str(cap),
                       "cluster.configs.file": str(cl)}) as app:
        assert isinstance(app.cruise_control.load_monitor.capacity_resolver,
                          BrokerCapacityConfigFileResolver)
        topic = app.detector_manager.detectors[AnomalyType.TOPIC_ANOMALY]
        assert topic.finder.target_rf == 3


@pytest.mark.parametrize("item,refused", [
    ("A10", {"telemetry.device.stats.enabled": "true",
             "telemetry.device.cost.enabled": "true",
             "telemetry.kernel.enabled": "true",
             "telemetry.mesh.enabled": "true",
             "cuda.search.profiler.trace.dir": "trace"}),
    # A9 is ported: its key now builds the app and wires the scheduler
    ("A9", {"whatif.proactive.enabled": "true"}),
    ("A4", {"cuda.search.pipeline.depth": "0"}),
    ("A11", {"cuda.mesh.devices": "2", "cuda.search.shard.tables": "false",
             "cuda.search.shard.donate": "false"}),
])
def test_unported_keys_are_refused_before_anything_starts(item, refused):
    from cruise_control_tpu_torch.bootstrap import build_app
    from cruise_control_tpu_torch.config.cruise_control_config import (
        CruiseControlConfig,
    )
    from cruise_control_tpu_torch.whatif.proactive import ProactiveScheduler

    if item == "A9":
        with booted(PORT, {**SMALL, **refused}) as app:
            sched = app.proactive_scheduler
            assert isinstance(sched, ProactiveScheduler)
            assert sched.cc is app.cruise_control
            assert sched.state_summary()["running"]
            assert (sched.period_ms, sched.horizon_ms, sched.threshold,
                    sched.cooldown_ms) == (86_400_000, 3_600_000, 1.1,
                                           1_800_000)
            assert sched._sample_fn == \
                app.cruise_control.load_monitor.observed_total_ingress
        assert not sched.state_summary()["running"]
        return
    threads = threading.active_count()
    for key, value in refused.items():
        with pytest.raises(ConfigException,
                           match=f"{key}.*ROADMAP {item}"):
            build_app(CruiseControlConfig({**SMALL, key: value}), port=0,
                      device="cpu")
        assert threading.active_count() <= threads, key


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the server would start")
def test_main_without_card_exits_with_the_device_error(tmp_path):
    """The entry point, as a user starts it, on a machine with no card:
    the device error, a non-zero exit, and no listener — it is handed a
    port this test holds, and fails with the device error, not on the
    bind."""
    props = tmp_path / "cc.properties"
    props.write_text("simulation.num.brokers=6\n"
                     "simulation.num.partitions=24\n")
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        port = held.getsockname()[1]
        out = subprocess.run(
            [sys.executable, "-m", PORT, str(props), str(port)], cwd=REPO,
            capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "Address already in use" not in out.stderr
    assert "listening on" not in out.stdout


def _model(state) -> dict:
    return {n: np.asarray(getattr(state, n)) for n in (
        "assignment", "leader_slot", "partition_topic", "broker_rack",
        "broker_state", "replica_offline", "leader_load", "follower_load",
        "broker_capacity")}


def _scalars(verdict: dict) -> dict:
    """A verdict's integer and bool fields (and its future's name)."""
    return {k: v for k, v in verdict.items()
            if k == "future" or isinstance(v, (bool, int))}


def test_slice_against_the_reference():
    props = {"simulation.num.brokers": 12, "simulation.num.partitions": 120,
             "metric.sampling.interval.ms": 1000,
             "partition.metrics.window.ms": 1000,
             "use.tpu.optimizer": "true"}
    got = {}
    for pkg in PKGS:
        with booted(pkg, props) as app:
            cc = app.cruise_control
            plans = []
            run = cc.rebalance

            def spy(*a, _run=run, **kw):
                plans.append(_run(*a, **kw))
                return plans[-1]

            cc.rebalance = spy
            feed(app)
            app.server.start()
            client = CruiseControlClient(app.server.url, timeout_s=600)
            body = client.post("rebalance", dryrun="true")
            whatif = client.post("whatif")
            state = cc.load_monitor.cluster_model()
            verifier = module(pkg, "analyzer.verifier")
            goals = module(pkg, "analyzer.goal_optimizer").make_goals(
                constraint=cc.constraint)
            (plan,) = plans
            verifier.verify_result(state, plan, goals)
            got[pkg] = {"model": _model(state), "engine": body["engine"],
                        "score": body["violationScoreAfter"],
                        "plan_score": plan.violation_score_after,
                        "verdicts": [_scalars(v) for v in whatif["verdicts"]]}
    ref, port = got[REF], got[PORT]
    assert (ref["engine"], port["engine"]) == ("tpu", "cuda")
    for name, want in ref["model"].items():
        have = port["model"][name]
        if want.dtype.kind == "f":
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(have, want, err_msg=name)
    assert port["score"] == port["plan_score"]
    assert port["score"] <= ref["score"] + max(2, 0.05 * ref["score"]), (
        port["score"], ref["score"])
    assert port["verdicts"] and port["verdicts"] == ref["verdicts"]

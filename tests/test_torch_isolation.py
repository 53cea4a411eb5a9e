"""The port stands alone: importing it (every module of it) and resolving
every class path its config registry defaults to pulls in neither
JAX/Flax nor any module of the JAX reference package, and its entry
points never fall back to the CPU when a card was asked for."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import cruise_control_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
from cruise_control_tpu_torch.config.cruise_control_config import (
    DEFAULT_CONFIG_DEF, ConfigType, resolve_class)
classes = []
for key in DEFAULT_CONFIG_DEF.keys().values():
    paths = ([key.default] if key.type is ConfigType.CLASS
             else key.default.split(",") if key.type is ConfigType.LIST
             and isinstance(key.default, str)
             and key.default.startswith("cruise_control") else [])
    for path in paths:
        if path:
            cls = resolve_class(path)
            classes.append(cls.__module__ + "." + cls.__name__)
bad = sorted(
    n for n in sys.modules
    if n.split(".")[0] in ("jax", "jaxlib", "flax", "cruise_control_tpu")
)
print(json.dumps({"modules": mods, "classes": classes, "bad": bad}))
"""


def test_import_pulls_in_no_jax_and_no_reference():
    # -I: no PYTHONPATH and no user site, so nothing on the caller's
    # path (a sitecustomize importing jax, say) leaks into the probe
    out = subprocess.run(
        [sys.executable, "-I", "-c", _PROBE, REPO], cwd=REPO,
        capture_output=True, text=True, timeout=300, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    # the probe really walked the package, the repool, step-loop,
    # what-if, score-only round, corrected-cohort and incremental-rescore
    # modules, the served path's, the replanner's, the detector's, the
    # simulator's and the proactive scheduler's included
    for mod in ("analyzer.cuda_optimizer", "ops.grid", "analyzer.pool_kernels",
                "analyzer.step_graph", "analyzer.step_state", "whatif.engine",
                "whatif.verdict_kernels", "analyzer.round_kernels",
                "analyzer.corrected_kernel", "analyzer.rescore_kernels",
                "facade", "server.http_server", "executor.executor",
                "monitor.load_monitor", "telemetry.tracing",
                "tools.served_stack", "replan.planner", "detector.manager",
                "detector.detectors", "bootstrap", "__main__",
                "config.cruise_control_config", "kafka.backend",
                "monitor.fetcher", "telemetry.recorder", "telemetry.slo",
                "telemetry.host_profile", "sim", "sim.simulator",
                "sim.scenarios", "sim.soak", "sim.__main__",
                "whatif.proactive"):
        assert f"cruise_control_tpu_torch.{mod}" in res["modules"], mod
    # every class path the registry defaults to resolved into the port
    assert len(res["classes"]) >= 6, res["classes"]
    assert all(c.startswith("cruise_control_tpu_torch.")
               for c in res["classes"]), res["classes"]


def test_default_device_without_card_raises(monkeypatch):
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaGoalOptimizer,
    )
    from cruise_control_tpu_torch.models.convert import (
        cluster_state_from_numpy,
        device_model_from_numpy,
    )
    from cruise_control_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CudaGoalOptimizer()
    # the carriers from numpy default to the card too
    for carry in (cluster_state_from_numpy, device_model_from_numpy):
        with pytest.raises(RuntimeError, match="cuda"):
            carry({})
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    assert CudaGoalOptimizer(device="cpu").device.type == "cpu"

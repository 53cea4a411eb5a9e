"""The port's long-horizon soak on the CPU, held to the reference: the
smoke soak's gates are green, its journal reproduces the committed
``SOAK_r12.json`` smoke fingerprint, and its artifact validates against
the reference's ``cc-tpu-soak/1`` schema (the engine named ``cuda``).
Also: the day's spec is the reference's at its scale, the on-card rule
of the engine-failure ladder, and the entry points that default to the
card and raise without one."""

import copy
import dataclasses
import json
import pathlib

import pytest
import torch

from cruise_control_tpu.sim import soak as ref_soak
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.sim import make_scenario, run_scenario
from cruise_control_tpu_torch.sim import __main__ as sim_cli
from cruise_control_tpu_torch.sim import soak
from test_artifact_schemas import SCHEMAS, validate

REPO = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = json.loads((REPO / "SOAK_r12.json").read_text())

_cache = {}


def smoke_result():
    if "smoke" not in _cache:
        _cache["smoke"] = soak.run_soak(soak.smoke_spec(), device="cpu")
    return _cache["smoke"]


def port_soak_schema():
    """The reference's soak schema with the one substitution the port
    needs: the engine it names is ``cuda`` (or ``greedy``), not ``tpu``."""
    schema = copy.deepcopy(SCHEMAS["cc-tpu-soak/1"])
    schema["properties"]["scale"]["properties"]["engine"] = {
        "enum": ["cuda", "greedy"]}
    return schema


def test_smoke_soak_all_gates_green():
    art = json.loads(json.dumps(soak.make_soak_artifact(smoke_result())))
    assert art["allOk"] is True, art["gates"]
    for gate, v in art["gates"].items():
        if gate != "distinctFaultClasses":
            assert v is True, f"{gate}: {v}"
    assert art["heals"]["outcome"] == "HEALED"
    assert art["heals"]["unhealedTypes"] == []
    assert art["slo"]["summary"]["allOk"] is True


def test_smoke_soak_fingerprint_equals_the_committed_one():
    r = smoke_result()
    assert r.spec.seed == COMMITTED["smoke"]["seed"]
    assert r.fingerprint() == COMMITTED["smoke"]["journalFingerprint"]


def test_smoke_soak_artifact_validates_against_the_reference_schema():
    art = json.loads(json.dumps(soak.make_soak_artifact(smoke_result())))
    validate(art, port_soak_schema())
    validate(art["slo"], SCHEMAS["cc-tpu-slo/1"])
    assert art["scale"]["engine"] == "greedy"
    day = dict(art, scale={**art["scale"], "engine": "cuda"})
    validate(day, port_soak_schema())
    with pytest.raises(AssertionError):
        validate(dict(art, scale={**art["scale"], "engine": "tpu"}),
                 port_soak_schema())


def test_committed_day_artifact_gates():
    """``PORT_SOAK_r19.json``: the production day at 1 024 brokers on the
    card, every gate green — re-validated from the committed artifact
    alone (``python -m cruise_control_tpu_torch.sim.soak --soak soak_day
    --with-smoke --artifact PORT_SOAK_r19.json`` on a card)."""
    art = json.loads((REPO / "PORT_SOAK_r19.json").read_text())
    validate(art, port_soak_schema())
    validate(art["slo"], SCHEMAS["cc-tpu-slo/1"])
    assert (art["name"], art["seed"], art["allOk"]) == ("soak_day", 12, True)
    assert art["scale"] == {"brokers": 1024, "partitions": 4096,
                            "racks": 16, "replicationFactor": 2,
                            "engine": "cuda"}
    assert art["horizon"]["durationVirtualMs"] == 24 * 60 * soak.MIN_MS
    assert art["schedule"] == COMMITTED["schedule"]
    for gate, v in art["gates"].items():
        if gate != "distinctFaultClasses":
            assert v is True, f"the committed day fails {gate}"
    assert art["heals"]["outcome"] in ("HEALED", "NO_ANOMALY")
    assert art["heals"]["unhealedTypes"] == []
    assert art["heals"]["replans"]["warm"] > art["heals"]["replans"]["cold"]
    assert art["slo"]["summary"]["breached"] == 0
    assert art["smoke"]["journalFingerprint"] == \
        COMMITTED["smoke"]["journalFingerprint"]
    assert art["smoke"]["allOk"] is True


def test_leak_gate_reads_no_card_memory_on_the_cpu():
    samples = smoke_result().observer.samples
    assert len(samples) >= 4
    assert all(s["liveArrays"] == 0 and s["liveBufferMb"] == 0.0
               for s in samples)
    assert soak.SoakSpec().max_live_buffer_mb == 2048.0
    assert soak.SoakSpec().max_live_buffer_slope_mb_per_hour == 64.0


def test_day_spec_is_the_reference_day_on_the_cuda_engine():
    day, ref = soak.day_spec(seed=12), ref_soak.day_spec(seed=12)
    assert (day.num_brokers, day.num_racks, day.num_partitions,
            day.num_topics, day.replication_factor, day.engine) == \
        (1024, 16, 4096, 8, 2, "cuda")
    assert dataclasses.asdict(day) == {**dataclasses.asdict(ref),
                                       "engine": "cuda"}
    port, reference = (soak.build_scenario_spec(day),
                       ref_soak.build_scenario_spec(ref))
    assert [(e.kind, e.at_ms, dict(e.args)) for e in port.timeline.events] \
        == [(e.kind, e.at_ms, dict(e.args))
            for e in reference.timeline.events]
    assert port.replan_enabled and port.replan_heal and port.checkpoint
    assert port.serve_http and port.engine == "cuda"


def test_on_card_rule_of_the_engine_failure_ladder(monkeypatch):
    """On the card the facade never degrades: with ``_on_card`` forced
    true the scripted failure surfaces as a failed fix naming it, with no
    degradation record and no greedy plan, which is the outcome the CLI
    expects there; the off-card heal breaks that rule."""
    name = "engine_failure_degrades_to_greedy"
    outcome, why, check = sim_cli.ON_CARD[name]
    off = run_scenario(make_scenario(name), device="cpu")
    assert off.heal_outcome() == "HEALED" and check(off)
    monkeypatch.setattr(CruiseControl, "_on_card", lambda self: True)
    on = run_scenario(make_scenario(name), device="cpu")
    assert on.heal_outcome() == outcome == "FIX_FAILED"
    assert check(on) == []
    assert "never degrades" in why


def test_sim_cli_runs_on_the_cpu(capsys):
    assert sim_cli.main(["--scenario", "rack_loss", "--device", "cpu"]) == 0
    assert "rack_loss: HEALED" in capsys.readouterr().out


def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch):
    from cruise_control_tpu_torch.whatif import __main__ as whatif_cli
    from cruise_control_tpu_torch.whatif.artifact import measure_proactive

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run_scenario(make_scenario("rack_loss")),
                 lambda: soak.run_soak(soak.smoke_spec()),
                 lambda: sim_cli.main(["--scenario", "rack_loss"]),
                 lambda: soak.main(["--soak", "soak_smoke"]),
                 lambda: measure_proactive(),
                 lambda: whatif_cli.main([])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()

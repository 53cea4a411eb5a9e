"""The port's scenario simulator on the CPU, held to the reference: each
smoke scenario reaches the reference's outcome, passes the reference's
journal checks and reproduces the committed ``SCENARIOS_r16.json``
fingerprint bit for bit; the engine-failure ladder heals off the card as
the reference's does; the kernel observatory is refused until ported."""

import pytest

from cruise_control_tpu_torch.sim import SMOKE_SCENARIOS, make_scenario
from cruise_control_tpu_torch.sim import run_scenario
from cruise_control_tpu_torch.sim.simulator import ScenarioSpec
from cruise_control_tpu_torch.sim.timeline import Timeline, disk_failure
from cruise_control_tpu_torch.telemetry import events
from torch_sim_cases import (
    COMMITTED,
    fingerprint_as_reference,
    held_to_reference,
    port_result,
)

MIN = 60_000


@pytest.mark.parametrize("name", SMOKE_SCENARIOS)
def test_smoke_scenario_matches_the_reference(name):
    held_to_reference(name)


def test_engine_failure_degrades_to_greedy_off_the_card():
    """On the cuda engine's plain twins the ladder is the reference's: the
    scripted cuda failure costs one degradation record and every plan is
    served by greedy; the journal is the reference's once the failed
    engine's name reads "tpu"."""
    name = "engine_failure_degrades_to_greedy"
    r = port_result(name)
    assert r.heal_outcome() == "HEALED"
    (deg,) = r.events_of("analyzer.engine_degraded")
    assert deg["payload"]["engine"] == "cuda"
    assert deg["payload"]["fallback"] == "greedy"
    assert "RESOURCE_EXHAUSTED" in deg["payload"]["error"]
    ends = [e["payload"]["engine"] for e in r.events_of("optimize.end")]
    assert ends and all(e == "greedy" for e in ends)
    assert not r.events_of("optimize.failed")
    assert r.fixes_started("GOAL_VIOLATION")
    assert r.actions_executed() > 0
    assert not r.events_of("analyzer.engine_recovered")
    assert r.fingerprint() != COMMITTED[name]["journalFingerprint"]
    assert fingerprint_as_reference(r) == \
        COMMITTED[name]["journalFingerprint"]


def test_kernel_capture_is_refused_naming_a10():
    spec = ScenarioSpec(
        name="capture", description="one disk failure",
        timeline=Timeline([disk_failure(2 * MIN, broker=1)]),
        num_brokers=4, num_racks=2, num_partitions=12,
        duration_ms=4 * MIN, kernel_capture_scans=1,
    )
    journal = events.JOURNAL
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        run_scenario(spec, device="cpu")
    # refused before anything started: no scenario journal was swapped in
    # and the timeline's event is still due
    assert events.JOURNAL is journal
    assert [e.kind for e in spec.timeline.pop_due(spec.duration_ms)] == \
        ["disk_failure"]
    assert all(make_scenario(n).kernel_capture_scans == 0
               for n in SMOKE_SCENARIOS)

"""Deterministic fault-injection simulator (SURVEY.md §4, RandomCluster
tradition): scripted fault timelines driven through the REAL monitor →
detector → analyzer → executor loop on a virtual clock, asserted against
the event journal.  See docs/ARCHITECTURE.md "Fault-injection simulator"
and ``python -m cruise_control_tpu_torch.sim --help``."""

from cruise_control_tpu_torch.sim.artifact import (
    SCHEMA,
    make_artifact,
    make_slo_artifact,
    scenario_summary,
)
from cruise_control_tpu_torch.sim.backend import ScriptedClusterBackend
from cruise_control_tpu_torch.sim.fault_schedule import (
    FaultScheduleConfig,
    generate_timeline,
    schedule_summary,
)
from cruise_control_tpu_torch.sim.scenarios import (
    SCENARIOS,
    SMOKE_SCENARIOS,
    make_scenario,
)
from cruise_control_tpu_torch.sim.soak import (
    SOAKS,
    SoakResult,
    SoakSpec,
    make_soak_artifact,
    run_soak,
    smoke_spec,
)
from cruise_control_tpu_torch.sim.simulator import (
    ScenarioResult,
    ScenarioSpec,
    journal_fingerprint,
    run_scenario,
)
from cruise_control_tpu_torch.sim.timeline import Timeline, TimelineEvent
from cruise_control_tpu_torch.sim.workload import ScenarioWorkload

__all__ = [
    "SCHEMA",
    "SCENARIOS",
    "SMOKE_SCENARIOS",
    "SOAKS",
    "FaultScheduleConfig",
    "ScenarioResult",
    "ScenarioSpec",
    "ScenarioWorkload",
    "ScriptedClusterBackend",
    "SoakResult",
    "SoakSpec",
    "Timeline",
    "TimelineEvent",
    "generate_timeline",
    "journal_fingerprint",
    "make_artifact",
    "make_scenario",
    "make_slo_artifact",
    "make_soak_artifact",
    "run_scenario",
    "run_soak",
    "scenario_summary",
    "schedule_summary",
    "smoke_spec",
]

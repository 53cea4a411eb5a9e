"""The ``cc-tpu-scenarios/1`` artifact — per-scenario heal outcomes —
plus the scenario-mode ``cc-tpu-slo/1`` gate table.

One JSON document summarizing a scenario-suite run: for every scenario, the
heal outcome, virtual detection latency, the faults injected, per-type
anomaly decisions, and what the executor actually did — every field derived
from the run's event journal (the same ground truth the test suite asserts
on).  The checked-in contract lives in ``tests/schemas/artifacts.schema.json``
(closed records — field drift fails CI), and the committed instance is
``SCENARIOS_r12.json``.  :func:`make_slo_artifact` collapses one scenario's
journal into the SLO observatory's gate table — the artifact shape the
long-horizon soak (ROADMAP item 5) will gate on.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.sim.simulator import ScenarioResult

SCHEMA = "cc-tpu-scenarios/1"


def make_slo_artifact(result: ScenarioResult,
                      objectives: Optional[dict] = None) -> dict:
    """One scenario's journal → the ``cc-tpu-slo/1`` gate table."""
    report = result.slo_report(objectives=objectives)
    return report.to_artifact(extra={
        "scenario": {
            "name": result.spec.name,
            "seed": result.spec.seed,
            "durationVirtualMs": result.duration_virtual_ms,
        },
    })


def scenario_summary(result: ScenarioResult) -> dict:
    """One scenario's journal collapsed into the artifact record."""
    anomalies: Dict[str, Dict[str, int]] = {}
    for p in result.anomalies():
        by_action = anomalies.setdefault(p.get("anomalyType", "?"), {})
        action = p.get("action", "?")
        by_action[action] = by_action.get(action, 0) + 1
    return {
        "name": result.spec.name,
        "description": result.spec.description,
        "seed": result.spec.seed,
        "durationVirtualMs": result.duration_virtual_ms,
        "ticks": result.ticks,
        "faults": [
            {"kind": p.get("fault", "?"), "virtualMs": p.get("virtualMs")}
            for p in result.faults()
        ],
        "healOutcome": result.heal_outcome(),
        "detectionLatencyMs": result.detection_latency_ms(),
        "anomalies": anomalies,
        "fixesStarted": len(result.fixes_started()),
        "executions": len(result.executions()),
        "actionsExecuted": result.actions_executed(),
        "deadTasks": result.dead_tasks(),
        "journalEvents": len(result.journal),
        "journalFingerprint": result.fingerprint(),
    }


def make_artifact(results: Sequence[ScenarioResult],
                  now: Optional[float] = None) -> dict:
    now = time.time() if now is None else now
    scenarios: List[dict] = [scenario_summary(r) for r in results]
    outcomes: Dict[str, int] = {}
    for s in scenarios:
        outcomes[s["healOutcome"]] = outcomes.get(s["healOutcome"], 0) + 1
    return {
        "schema": SCHEMA,
        "generated_unix": round(now, 3),
        "scenarios": scenarios,
        "summary": {
            "numScenarios": len(scenarios),
            "outcomes": outcomes,
            "totalActionsExecuted": sum(
                s["actionsExecuted"] for s in scenarios
            ),
            "totalDeadTasks": sum(s["deadTasks"] for s in scenarios),
        },
    }

"""``python -m cruise_control_tpu_torch.sim`` — run scripted fault scenarios and
emit the ``cc-tpu-scenarios/1`` artifact.

    python -m cruise_control_tpu_torch.sim --list
    python -m cruise_control_tpu_torch.sim --scenario rack_loss --seed 7
    python -m cruise_control_tpu_torch.sim --artifact SCENARIOS_r09.json

Without ``--scenario`` the full registry runs.  Exit code is 1 when any
scenario ends in FIX_FAILED or UNHEALED (regression signal for CI cron),
except a scenario listed in :data:`ON_CARD` whose on-card outcome holds.

The engines run on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain twins).  On the card the facade never degrades a failed
cuda plan to the CPU's greedy engine, so a scripted engine failure
surfaces as a failed fix there instead of a greedy heal.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from cruise_control_tpu_torch.sim.artifact import make_artifact
from cruise_control_tpu_torch.sim.scenarios import SCENARIOS, make_scenario
from cruise_control_tpu_torch.sim.simulator import run_scenario


def _failure_surfaces(result) -> list:
    """What breaks the on-card rule for ``engine_failure_degrades_to_
    greedy``: the scripted failure must surface as a failed fix naming
    it, with no degradation record and no plan served by greedy."""
    errors = []
    failed = [p for p in result.anomalies(action="FIX_FAILED")
              if "scripted TPU engine failure" in str(p.get("error"))]
    if not failed:
        errors.append("no FIX_FAILED decision names the scripted failure")
    if result.events_of("analyzer.engine_degraded"):
        errors.append("an analyzer.engine_degraded record")
    greedy = [e for e in result.events_of("optimize.end")
              if e.get("payload", {}).get("engine") == "greedy"]
    if greedy:
        errors.append(f"{len(greedy)} plan(s) served by greedy")
    return errors


#: scenarios whose outcome on the card differs from the reference's, with
#: the outcome, the reason and the check that must hold there instead
ON_CARD = {
    "engine_failure_degrades_to_greedy": (
        "FIX_FAILED",
        "on the card the facade never degrades a failed cuda plan to the "
        "CPU's greedy engine, so the scripted engine failure surfaces as "
        "a failed fix",
        _failure_surfaces,
    ),
}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cruise_control_tpu_torch.sim",
        description="Deterministic fault-injection scenario runner",
    )
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME",
                    help="scenario to run (repeatable; default: all)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override every scenario's seed")
    ap.add_argument("--artifact", metavar="PATH", default=None,
                    help="write the cc-tpu-scenarios/1 artifact here")
    ap.add_argument("--json", action="store_true",
                    help="print the artifact JSON to stdout")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--device", default="cuda",
                    help="the card the engines run on (default "
                         "%(default)s; 'cpu' runs the kernels' plain twins)")
    args = ap.parse_args(argv)

    if args.list:
        for name in SCENARIOS:
            print(f"{name}: {SCENARIOS[name]().description}")
        return 0

    names = args.scenario or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"unknown scenario(s): {unknown}; --list shows the registry",
              file=sys.stderr)
        return 2

    on_card = torch.device(args.device).type == "cuda"
    results = []
    expected, broken = set(), []
    for name in names:
        spec = make_scenario(name, seed=args.seed)
        result = run_scenario(spec, device=args.device)
        results.append(result)
        print(
            f"{name}: {result.heal_outcome()} "
            f"(detection {result.detection_latency_ms()} ms virtual, "
            f"{result.actions_executed()} actions, "
            f"{result.dead_tasks()} dead tasks, "
            f"{len(result.journal)} journal events)"
        )
        if on_card and name in ON_CARD:
            outcome, why, check = ON_CARD[name]
            errors = check(result)
            if result.heal_outcome() == outcome and not errors:
                expected.add(name)
                print(f"  {outcome} is expected on the card: {why}")
            else:
                broken.append(name)
                print(f"  on-card rule broken: {errors}", file=sys.stderr)

    artifact = make_artifact(results)
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"artifact written: {args.artifact}")
    if args.json:
        print(json.dumps(artifact, indent=1, sort_keys=True))
    bad = [s["name"] for s in artifact["scenarios"]
           if s["healOutcome"] in ("FIX_FAILED", "UNHEALED")
           and s["name"] not in expected] + broken
    if bad:
        print(f"unhealed scenario(s): {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

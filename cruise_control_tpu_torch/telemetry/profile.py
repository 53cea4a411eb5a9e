"""Phase-tree aggregation over completed spans + the benchmark artifact.

Turns the tracer's flat ``{path: [count, total_s]}`` table into the
per-phase breakdown the benchmarks commit (the evidence VERDICT r5 found
missing: a perf regression must be diagnosable from the committed JSON
alone).  ``self_s`` is the time a phase spent OUTSIDE its traced children
— the "untracked" residual that hides host-side walks and transfer stalls.

Artifact schema (``SCHEMA``):

    {
      "schema": "cc-tpu-phase-profile/1",
      "generated_unix": <float>,
      "phases": {
        "<path>": {"count": N, "total_s": T, "self_s": S},
        ...
      },
      ...extra keys the caller merges in (fixture, totals, scores)
    }

Paths are '/'-joined span ancestries (``facade.rebalance/analyzer.scan``),
so the tree structure is recoverable without nesting.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

from cruise_control_tpu_torch.telemetry.tracing import TELEMETRY, Telemetry

SCHEMA = "cc-tpu-phase-profile/1"


def phase_tree(tel: Optional[Telemetry] = None) -> Dict[str, dict]:
    """{path: {count, total_s, self_s}} over everything traced so far.

    Deterministic: keys are sorted, values derive purely from the
    accumulated (count, total) pairs — two identical span sequences yield
    identical trees (modulo the measured durations themselves).
    """
    agg = (tel or TELEMETRY).aggregates()
    # child time rolls up to the DIRECT parent only (each level's self_s
    # already excludes its own children)
    child_total: Dict[str, float] = {}
    for path, (_, total) in agg.items():
        parent, _, _ = path.rpartition("/")
        if parent:
            child_total[parent] = child_total.get(parent, 0.0) + total
    return {
        path: {
            "count": int(count),
            "total_s": round(total, 6),
            "self_s": round(max(total - child_total.get(path, 0.0), 0.0), 6),
        }
        for path, (count, total) in sorted(agg.items())
    }


def phase_breakdown(tel: Optional[Telemetry] = None) -> Dict[str, float]:
    """Flat ``{path: total_s}`` — the compact form benches inline."""
    return {
        path: ent["total_s"] for path, ent in phase_tree(tel).items()
    }


def make_artifact(extra: Optional[dict] = None,
                  tel: Optional[Telemetry] = None) -> dict:
    out = {
        "schema": SCHEMA,
        "generated_unix": round(time.time(), 3),
        "phases": phase_tree(tel),
    }
    if extra:
        out.update(extra)
    return out


def write_artifact(path: str, extra: Optional[dict] = None,
                   tel: Optional[Telemetry] = None) -> dict:
    """Write the phase-profile JSON artifact; returns what was written."""
    art = make_artifact(extra, tel)
    with open(path, "w") as f:
        json.dump(art, f, indent=1, sort_keys=False)
        f.write("\n")
    return art

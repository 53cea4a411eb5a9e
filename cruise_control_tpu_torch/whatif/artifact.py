"""The ``cc-tpu-whatif/1`` artifact — the subsystem's two headline
claims, measured and gated.

**Batch**: N ≥ 64 futures — every rack loss, every broker loss, a ladder
of traffic multipliers, maintenance pairs — compiled against the
50-broker/1000-partition bench fixture and evaluated in ONE batched
kernel call; the wall cost must stay under 2× a single plan search of
the port's :class:`CudaGoalOptimizer` on the same model
(``batchRatioUnder2x``).  That ratio is the whole point of the batched
verdict kernel: an operator buys a complete survivability sweep for less
than two plan searches.

**Proactive**: the ``proactive_beats_reactive_peak`` scenario run twice
— forecast-driven proactive control ON, then its reactive twin (same
seed, same timeline, proactive off).  The proactive run must end with
zero detector anomalies and zero reactive fixes (the rebalance landed
before the breach), and its heal p99 must beat the reactive twin's
(``proactiveBeatsReactiveHealP99``).

The artifact's contract is the reference's (``tests/schemas/
artifacts.schema.json``); the port's proactive leg reproduces the
reference's committed ``WHATIF_r16.json`` block field for field.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from cruise_control_tpu_torch.whatif.compiler import compile_futures
from cruise_control_tpu_torch.whatif.engine import evaluate_batch, verdicts
from cruise_control_tpu_torch.whatif.futures import (
    FutureSpec,
    likely_futures,
    maintenance,
    traffic_scale,
)

SCHEMA = "cc-tpu-whatif/1"

#: the acceptance floor on the batched sweep
MIN_FUTURES = 64

#: batched sweep wall must stay under this multiple of one plan search
RATIO_GATE = 2.0

#: traffic multipliers appended past the likely-futures set to fill the
#: batch deterministically (the likely set tops out at R racks +
#: B brokers + 2 growth steps)
_EXTRA_FACTORS = (1.1, 1.2, 1.25, 1.3, 1.4, 1.6, 1.75, 1.8, 2.2, 2.5,
                  2.75, 3.0)


def artifact_futures(state, n: int = MIN_FUTURES) -> List[FutureSpec]:
    """A deterministic ``n``-future sweep over ``state``: the model's
    likely futures (every rack loss, every broker loss, growth steps),
    then extra traffic multipliers, then rolling maintenance pairs."""
    futures = list(likely_futures(state, k=n))
    for f in _EXTRA_FACTORS:
        if len(futures) >= n:
            break
        futures.append(FutureSpec(
            name=f"traffic-x{f:g}", events=(traffic_scale(f),),
        ))
    b = 0
    num_brokers = int(state.num_brokers)
    while len(futures) < n:
        futures.append(FutureSpec(
            name=f"maintenance-{b}-{(b + 1) % num_brokers}",
            events=(maintenance(b, (b + 1) % num_brokers),),
        ))
        b = (b + 2) % num_brokers
    return futures[:n]


def _best_of(n: int, fn) -> float:
    best = np.inf
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_batch(num_futures: int = MIN_FUTURES, best_of: int = 3,
                  seed: int = 42, num_brokers: int = 50,
                  num_racks: int = 10, num_partitions: int = 1000,
                  device="cuda") -> dict:
    """The batched-sweep measurement: ``num_futures`` futures against the
    bench fixture, ONE :func:`evaluate_batch` call, timed best-of against
    a single warm plan search of :class:`CudaGoalOptimizer` on the same
    model, both on ``device``."""
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
        CudaGoalOptimizer,
    )
    from cruise_control_tpu_torch.models.generators import random_cluster

    state = random_cluster(
        seed=seed, num_brokers=num_brokers, num_racks=num_racks,
        num_partitions=num_partitions,
    )
    futures = artifact_futures(state, num_futures)
    batch = compile_futures(state, futures)
    raw = evaluate_batch(state, batch, device=device)      # warm-up
    batched_s = _best_of(best_of, lambda: evaluate_batch(state, batch,
                                                         device=device))

    opt = CudaGoalOptimizer(device=device)
    opt.optimize(state)                         # warm-up: builds, captures
    plan_s = _best_of(best_of, lambda: opt.optimize(state))

    rows = verdicts(batch, raw)
    survivable = sum(1 for v in rows if v["survivable"])
    return {
        "numFutures": len(futures),
        "batchSize": batch.padded_size,
        "numDispatches": 1,
        "scale": {
            "brokers": num_brokers,
            "partitions": num_partitions,
            "racks": num_racks,
        },
        "batchedWallS": round(batched_s, 4),
        "singlePlanWallS": round(plan_s, 4),
        "ratio": round(batched_s / plan_s, 4),
        "perFutureWallMs": round(batched_s / len(futures) * 1000.0, 4),
        "verdicts": {
            "survivable": survivable,
            "unsurvivable": len(rows) - survivable,
            "goalViolations": sum(v["goalViolations"] for v in rows),
        },
    }


def _scenario_side(result, mitigation_ms) -> dict:
    """One twin's journal collapsed into the artifact record.
    ``mitigation_ms`` is the side's first-mitigation virtual time: the
    proactive trigger for the proactive run, the first started fix for
    the reactive one."""
    pcts = result.heal_latency_percentiles()
    return {
        "outcome": result.heal_outcome(),
        "anomalies": len(result.anomalies()),
        "fixesStarted": len(result.fixes_started()),
        "healP99Ms": int(pcts.get(99, 0)),
        "mitigationVirtualMs": (
            None if mitigation_ms is None else int(mitigation_ms)
        ),
        "journalFingerprint": result.fingerprint(),
    }


def measure_proactive(scenario: str = "proactive_beats_reactive_peak",
                      device="cuda"):
    """Run the scenario with proactive control ON and its reactive twin
    (identical spec, proactive off) — the forecast's time-lead is the
    only variable.  Both run their engines on ``device``."""
    from cruise_control_tpu_torch.sim import make_scenario, run_scenario

    spec = make_scenario(scenario)
    pro = run_scenario(spec, device=device)
    rea = run_scenario(dataclasses.replace(
        spec, name=f"{scenario}__reactive_twin", proactive_enabled=False,
    ), device=device)
    trig = pro.events_of("proactive.trigger")
    fixes = rea.fixes_started()
    pro_side = _scenario_side(
        pro, trig[0]["ts"] * 1000.0 if trig else None,
    )
    rea_side = _scenario_side(
        rea, fixes[0]["timeMs"] if fixes else None,
    )
    lead = None
    if (pro_side["mitigationVirtualMs"] is not None
            and rea_side["mitigationVirtualMs"] is not None):
        lead = (rea_side["mitigationVirtualMs"]
                - pro_side["mitigationVirtualMs"])
    return {
        "scenario": scenario,
        "proactive": pro_side,
        "reactive": rea_side,
        "leadVirtualMs": lead,
    }


def make_artifact(batch: dict, proactive: dict,
                  now: Optional[float] = None) -> dict:
    """Assemble the gated artifact from the two measurements."""
    now = time.time() if now is None else now
    pro, rea = proactive["proactive"], proactive["reactive"]
    gates = {
        "singleDispatch": batch["numDispatches"] == 1,
        "atLeast64Futures": batch["numFutures"] >= MIN_FUTURES,
        "batchRatioUnder2x": batch["ratio"] < RATIO_GATE,
        "proactiveNoBreach": (
            pro["anomalies"] == 0 and pro["fixesStarted"] == 0
        ),
        "proactiveBeatsReactiveHealP99": (
            pro["healP99Ms"] < rea["healP99Ms"]
            and rea["healP99Ms"] > 0
        ),
    }
    return {
        "schema": SCHEMA,
        "generated_unix": round(now, 3),
        "batch": batch,
        "proactive": proactive,
        "gates": gates,
        "allOk": all(gates.values()),
    }

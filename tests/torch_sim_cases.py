"""Shared set-up of the port's simulator tests: the port's scenario runs
on the CPU (each run once per worker), held to the reference's expected
outcomes, its journal checks (``tests/test_scenarios.py``) and the
fingerprints of the reference's committed ``SCENARIOS_r16.json``."""

import json
import pathlib

from cruise_control_tpu_torch.sim import (
    SCENARIOS,
    SMOKE_SCENARIOS,
    make_scenario,
    run_scenario,
)
from cruise_control_tpu_torch.sim.simulator import journal_fingerprint
from test_scenarios import CHECKS, EXPECTED_OUTCOMES

REPO = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = {
    s["name"]: s
    for s in json.loads((REPO / "SCENARIOS_r16.json").read_text())[
        "scenarios"]
}

#: scenarios whose journal no run reproduces, the reference's included:
#: concurrent clients reach the server in no fixed order, so the order
#: of their records (and the trace ids they draw) changes run to run
#: (the simulator's "concurrent storms opt out of fingerprints")
UNORDERED = ("request_storm_sheds_with_retry_after",)

_cache = {}


def port_result(name):
    """The port's run of a registered scenario on the CPU (once)."""
    if name not in _cache:
        _cache[name] = run_scenario(make_scenario(name), device="cpu")
    return _cache[name]


def as_reference(journal):
    """The journal with the port's engine name read as the reference's:
    the engine-degradation record names the engine that failed, "cuda"
    here and "tpu" there.  No other field differs."""
    out = []
    for rec in journal:
        p = rec.get("payload")
        if isinstance(p, dict) and p.get("engine") == "cuda":
            rec = {**rec, "payload": {**p, "engine": "tpu"}}
        out.append(rec)
    return out


def submissions_first(journal):
    """The journal with each ``http.task_submitted`` record before the
    first record of its task.  The server journals a submission on the
    request's thread right after it hands the task to its worker, whose
    first record may land before it when the host is busy (the
    reference's journal races the same way); the committed journals have
    the submission first."""
    out = list(journal)
    for rec in journal:
        if rec["kind"] != "http.task_submitted":
            continue
        first = next(i for i, r in enumerate(out)
                     if r.get("taskId") == rec.get("taskId"))
        out.remove(rec)
        out.insert(first, rec)
    return out


def held_to_reference(name):
    """Run ``name`` on the port, hold it to the reference's outcome and
    checks and, where the journal is ordered, to the committed
    fingerprint."""
    r = port_result(name)
    assert r.heal_outcome() == EXPECTED_OUTCOMES[name], (
        f"{name}: journal says {r.heal_outcome()}, expected "
        f"{EXPECTED_OUTCOMES[name]}")
    CHECKS[name](r)
    if name not in UNORDERED:
        assert journal_fingerprint(submissions_first(r.journal)) == \
            COMMITTED[name]["journalFingerprint"], name
    return r


def fingerprint_as_reference(result):
    return journal_fingerprint(as_reference(result.journal))


#: the registry's other scenarios (the reference marks them slow; the
#: port runs each in about a second on the CPU), in two halves so that no
#: test file holds 13 tests or more
MATRIX = sorted(set(SCENARIOS) - set(SMOKE_SCENARIOS)
                - {"engine_failure_degrades_to_greedy"})
MATRIX_FIRST = MATRIX[:len(MATRIX) // 2]
MATRIX_SECOND = MATRIX[len(MATRIX) // 2:]

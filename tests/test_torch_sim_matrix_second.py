"""The second half of the scenario registry beyond the smoke set, on the
port's simulator on the CPU: the reference's outcome and journal checks,
and the committed ``SCENARIOS_r16.json`` fingerprint (except for the
request storm, whose record order no run reproduces)."""

import pytest

from cruise_control_tpu_torch.sim import SCENARIOS, SMOKE_SCENARIOS
from cruise_control_tpu_torch.sim.simulator import journal_fingerprint
from torch_sim_cases import (
    COMMITTED,
    MATRIX,
    MATRIX_FIRST,
    MATRIX_SECOND,
    UNORDERED,
    held_to_reference,
    port_result,
    submissions_first,
)


def test_the_matrix_covers_the_registry():
    assert MATRIX_FIRST + MATRIX_SECOND == MATRIX
    assert len(MATRIX) + len(SMOKE_SCENARIOS) + 1 == len(SCENARIOS)
    assert set(UNORDERED) <= set(MATRIX_SECOND)


def test_a_task_journaled_before_its_submission_reads_as_committed():
    """The one race in an ordered journal: the worker's first record
    ahead of the request thread's ``http.task_submitted``."""
    name = "crash_mid_request_recovers_front_door"
    journal = list(port_result(name).journal)
    i = next(k for k, r in enumerate(journal)
             if r["kind"] == "http.task_submitted")
    assert journal[i + 1]["taskId"] == journal[i]["taskId"]
    raced = journal[:i] + [journal[i + 1], journal[i]] + journal[i + 2:]
    want = COMMITTED[name]["journalFingerprint"]
    assert journal_fingerprint(raced) != want
    assert journal_fingerprint(submissions_first(raced)) == want
    assert submissions_first(journal) == journal


@pytest.mark.parametrize("name", MATRIX_SECOND)
def test_scenario_matches_the_reference(name):
    held_to_reference(name)

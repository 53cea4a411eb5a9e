"""The first half of the scenario registry beyond the smoke set, on the
port's simulator on the CPU: the reference's outcome and journal checks,
and the committed ``SCENARIOS_r16.json`` fingerprint."""

import pytest

from torch_sim_cases import MATRIX_FIRST, held_to_reference


@pytest.mark.parametrize("name", MATRIX_FIRST)
def test_scenario_matches_the_reference(name):
    held_to_reference(name)

"""The port's anomaly detector manager against the reference's
(``tests/test_detector.py::TestManagerEndToEnd``): each scenario — a
goal-violation, broker-failure, maintenance-event or disk-failure
self-heal, the fix cooldown and its recovery claim, a broken detector,
the detection interval — runs on the reference's stack and on the port's
(greedy engine, CPU), makes the reference test's assertions on both, and
the port's anomalies, journal and final placement equal the reference's."""

import pytest

from torch_detector_cases import MANAGER, on_both


@pytest.mark.parametrize("name", list(MANAGER))
def test_manager_scenario_matches_reference(name, tmp_path):
    ref, port = on_both(MANAGER[name], tmp_path)
    assert port == ref

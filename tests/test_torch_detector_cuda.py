"""Self-healing on the port's cuda engine (its default; the kernels'
plain twins on the CPU): each self-healing scenario of the detector
mirrors runs once more with the facade planning on ``"cuda"``; the
reference test's assertions hold (the failed broker or disk is empty, the
replication factor raised, the leaders spread), and every plan a fix made
passes ``verify_result`` on its model, full-stack plans on the cuda
engine, each within the parity tolerance of the reference's plan at the
same place of the same scenario on its ``"tpu"`` engine.  A broker
removal from a cluster already balanced raises the soft goals' score on
every engine (the delayed maintenance event's): such a plan must keep
every hard goal and stay within the parity tolerance of the reference's
removal.  And ``POST /admin``'s self-healing toggle over real loopback HTTP
with a detector attached (``tests/test_server.py::
test_admin_self_healing_toggle``)."""

import pytest

from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
from cruise_control_tpu_torch.analyzer.verifier import verify_result
from cruise_control_tpu_torch.client.cccli import CruiseControlClient
from cruise_control_tpu_torch.detector import make_detector_manager
from cruise_control_tpu_torch.server import CruiseControlHttpServer
from cruise_control_tpu_torch.tools.served_stack import full_stack

from torch_detector_cases import ALL, SELF_HEAL, on_engine


@pytest.mark.parametrize("name", SELF_HEAL)
def test_self_heal_on_the_cuda_engine(name, tmp_path):
    _, plans = on_engine(ALL[name], tmp_path)
    _, ref_plans = on_engine(ALL[name], tmp_path, "cruise_control_tpu", "tpu")
    assert [p[0] for p in plans] == [p[0] for p in ref_plans]
    if name != "rf_fix_raises_replication_factor":  # plans no search
        assert [p for p in plans if p[4].execution is not None]
    for (op, state, goals, options, result), ref in zip(plans, ref_plans):
        if goals is None:
            assert result.engine == "cuda" and ref[4].engine == "tpu"
        assert within_parity(result.violation_score_after,
                             ref[4].violation_score_after), op
        goals = make_goals(goals)
        if result.violation_score_after <= result.violation_score_before:
            verify_result(state, result, goals, options)
            continue
        assert options.brokers_to_remove, f"{op} made the goals worse"
        final = AnalyzerContext(result.final_state, options)
        assert all(g.violations(final) == 0 for g in goals if g.is_hard)


def within_parity(score: int, ref_score: int) -> bool:
    return score <= ref_score + max(2, 0.05 * ref_score)


def test_admin_self_healing_toggle():
    cc, backend, _ = full_stack(device="cpu")
    srv = CruiseControlHttpServer(cc, port=0)
    srv.start()
    try:
        make_detector_manager(cc, backend=backend)
        c = CruiseControlClient(srv.url)
        body = c.post("admin", enable_self_healing_for="goal_violation")
        assert body["selfHealingEnabledChanged"] == {"GOAL_VIOLATION": True}
        st = c.get("state")
        assert st["AnomalyDetectorState"]["selfHealingEnabled"][
            "GOAL_VIOLATION"] is True
    finally:
        srv.stop()

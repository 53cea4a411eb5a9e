"""The port's lock-order graph: the committed ``cc-tpu-lock-graph/1``
artifact ``PORT_LOCK_GRAPH_r21.json`` against what the port's cclint
derives from the live tree, and against the acquisition orders the
port's runtime witness sees while its stack plans with the cuda engine
(on the CPU: the kernels' plain twins, the same locks).

Regenerate with ``python -m cruise_control_tpu_torch.devtools.lint
--lock-graph PORT_LOCK_GRAPH_r21.json cruise_control_tpu_torch``."""

import json

from cruise_control_tpu_torch.devtools.lint.driver import run_lint
from cruise_control_tpu_torch.devtools.lint.rules_lockorder import (
    SCHEMA,
    build_lock_graph,
)
from cruise_control_tpu_torch.utils import locks
from cruise_control_tpu_torch.utils.locks import (
    ContentionRegistry,
    InstrumentedLock,
)
from test_artifact_schemas import SCHEMAS, validate
from torch_cclint_cases import (  # noqa: F401  (the module cache fixture)
    PORT,
    REPO,
    _module_cache,
)

ARTIFACT = REPO / "PORT_LOCK_GRAPH_r21.json"


def test_committed_lock_graph_matches_schema_and_live_tree():
    committed = json.loads(ARTIFACT.read_text())
    validate(committed, SCHEMAS[SCHEMA], ARTIFACT.name)
    live = build_lock_graph(
        run_lint(paths=[str(PORT)], rules=["lock-order"]).project)
    assert committed["locks"] == live["locks"], (
        "the named-lock vocabulary drifted — regenerate "
        "PORT_LOCK_GRAPH_r21.json")
    assert ([(e["from"], e["to"]) for e in committed["edges"]]
            == [(e["from"], e["to"]) for e in live["edges"]]), (
        "the acquisition-order edge set drifted — regenerate the "
        "committed artifact and review the new ordering")
    assert committed["cycles"] == [] and live["cycles"] == []
    # the port's own locks: the device and the kept step loops, taken
    # under the facade's single flight
    edges = {(e["from"], e["to"]) for e in committed["edges"]}
    assert {("proposal.single_flight", "device"),
            ("device", "device.step_loops")} <= edges
    for e in committed["edges"]:
        assert e["witness"] and all(h["line"] >= 1 for h in e["witness"])


def test_the_ports_witness_records_nested_acquisitions():
    reg = ContentionRegistry()
    outer = InstrumentedLock("w.device", registry=reg)
    inner = InstrumentedLock("w.loops", registry=reg)
    with outer:  # off: nothing recorded
        with inner:
            pass
    assert reg.order_witness()["edges"] == []
    reg.enable_order_witness()
    for _ in range(2):
        with outer:
            with inner:
                pass
    assert reg.order_witness()["edges"] == [
        {"from": "w.device", "to": "w.loops", "count": 2}]


def test_runtime_witnessed_orders_are_static_edges():
    """Every acquisition order between named locks that the port's stack
    shows — proposals, a rebalance and a maintenance scenario, all on
    the cuda engine — is an edge of the committed static graph."""
    from cruise_control_tpu_torch.sim import make_scenario, run_scenario
    from cruise_control_tpu_torch.tools.served_stack import full_stack

    committed = json.loads(ARTIFACT.read_text())
    vocab = set(committed["locks"])
    static_edges = {(e["from"], e["to"]) for e in committed["edges"]}
    locks.CONTENTION.reset()
    locks.CONTENTION.enable_order_witness()
    try:
        cc, _backend, _reporter = full_stack(engine="cuda", device="cpu")
        cc.get_proposals()
        cc.rebalance(dryrun=False)
        run_scenario(make_scenario("add_broker_rebalance"), device="cpu")
        w = locks.CONTENTION.order_witness()
    finally:
        locks.CONTENTION.reset()
    assert w["dropped"] == 0
    checkable = {(e["from"], e["to"]) for e in w["edges"]
                 if e["from"] in vocab and e["to"] in vocab
                 and e["from"] != e["to"]}
    # non-vacuous: the engine's locks under the facade's
    assert {("proposal.single_flight", "device"),
            ("device", "device.step_loops")} <= checkable
    missing = sorted(checkable - static_edges)
    assert missing == [], (
        f"runtime acquisition order(s) {missing} are not edges of "
        "PORT_LOCK_GRAPH_r21.json — a blind spot of the static analysis, "
        "or a stale artifact")

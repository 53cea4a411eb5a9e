"""The port's facade routed through the delta replanner
(``tests/test_replan.py``, second half), against the reference's facade:
the budget breach falls back to the cold path bit for bit, replan
decisions are journaled and the warm plan serves the cache, a zero delta
re-validates the previous plan without an engine call, and a warm failure
falls back to one cold attempt.  On the greedy engine the port's plans and
journals equal the reference's.  Then the same route on the cuda engine
(CPU twins): a warm replan rides the carry and equals the carry-less warm
plan, and the threads that plan (a request, a self-healing fix, a what-if)
take the engine's device lock in one order only."""

import threading

from cruise_control_tpu.analyzer.goal_optimizer import (
    GoalOptimizer as RefGoalOptimizer,
)
from cruise_control_tpu.replan import DeltaReplanner as RefReplanner
from cruise_control_tpu.replan import ReplanConfig as RefReplanConfig
from cruise_control_tpu.telemetry import events as ref_events
from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
    CudaGoalOptimizer,
)
from cruise_control_tpu_torch.analyzer.goal_optimizer import (
    GoalOptimizer,
    make_goals,
)
from cruise_control_tpu_torch.analyzer.verifier import verify_result
from cruise_control_tpu_torch.detector import AnomalyType
from cruise_control_tpu_torch.replan import DeltaReplanner, ReplanConfig
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.tools.served_stack import (
    DETECTION_INTERVAL_MS,
    full_stack,
)
from cruise_control_tpu_torch.utils.locks import CONTENTION

from harness import WINDOW
from harness import full_stack as ref_full_stack

REF = (ref_full_stack, RefReplanner, RefReplanConfig, ref_events)
PORT = (lambda **kw: full_stack(engine="greedy", device="cpu", **kw),
        DeltaReplanner, ReplanConfig, events)


def roll_windows(cc, reporter, start_window: int, n: int = 2):
    for k in range(start_window, start_window + n):
        reporter.report(time_ms=k * WINDOW + 500)
        cc.load_monitor.run_sampling_iteration((k + 1) * WINDOW)


def drift_broker(reporter, broker: int, factor: float, limit=None):
    w = reporter.workload
    parts = [p for p, reps in w.assignment.items() if broker in reps]
    for p in parts[:limit]:
        w.bytes_in[p] *= factor
        w.bytes_out[p] *= factor


def acts(result):
    return [(int(a.action_type), a.partition, a.slot, a.source_broker,
             a.dest_broker, a.dest_slot) for a in result.actions]


def replan_journal(ev):
    """The replan events' payloads, less their wall-clock durations."""
    return [{k: v for k, v in e["payload"].items() if k != "durationS"}
            | {"kind": e["kind"]}
            for e in ev.JOURNAL.recent() if e["kind"].startswith("replan.")]


def journaled(ev, fn):
    """``fn()`` and its replan events, on a fresh journal: the module's
    own may hold another test's events or ring size."""
    prev, ev.JOURNAL = ev.JOURNAL, ev.EventJournal(enabled=True)
    try:
        out = fn()
        return out, replan_journal(ev)
    finally:
        ev.JOURNAL = prev


def test_budget_breach_falls_back_cold_bit_identically():
    def scenario(stack, Replanner, Config, _):
        def build():
            cc, _, reporter = stack(num_partitions=24, num_brokers=4)
            return cc, reporter

        cc1, r1 = build()
        cc1.replanner = Replanner(
            cc1.load_monitor, Config(dirty_partition_budget_ratio=0.0001))
        cc2, r2 = build()
        for cc, reporter in ((cc1, r1), (cc2, r2)):
            cc.get_proposals(ignore_cache=True)
            drift_broker(reporter, 0, 3.0)
            roll_windows(cc, reporter, 3)
        p1 = cc1.get_proposals(ignore_cache=True)
        p2 = cc2.get_proposals(ignore_cache=True)
        assert cc1.replanner.last_mode == "cold"
        assert "dirty-budget-exceeded" in cc1.replanner.last_reason
        assert acts(p1) == acts(p2)
        assert [pr.to_json() for pr in p1.proposals] == [
            pr.to_json() for pr in p2.proposals]
        return acts(p1), [pr.to_json() for pr in p1.proposals]

    assert scenario(*PORT) == scenario(*REF)


def test_facade_replan_journals_warm_and_serves_cache():
    def scenario(stack, Replanner, Config, ev):
        cc, _, reporter = stack(num_partitions=24, num_brokers=4)
        cc.replanner = Replanner(cc.load_monitor, Config())

        def run():
            cc.get_proposals(ignore_cache=True)
            drift_broker(reporter, 0, 2.5, limit=3)
            roll_windows(cc, reporter, 3)
            assert not cc.proposal_cache_fresh()
            return cc.get_proposals(ignore_cache=True)

        result, journal = journaled(ev, run)
        end = [e for e in journal if e["kind"] == "replan.end"][-1]
        assert end["mode"] == "warm" and end["deltaModel"] is True
        assert end["dirtyPartitions"] > 0
        assert cc.replanner.warm_plans == 1
        assert cc.proposal_cache_fresh()
        _, meta = cc.serve_proposals()
        assert meta["cached"] is True and meta["stale"] is False
        return acts(result), journal

    assert scenario(*PORT) == scenario(*REF)


def test_zero_delta_short_circuit_serves_previous_plan():
    def scenario(stack, Replanner, Config, ev):
        cc, _, reporter = stack(num_partitions=24, num_brokers=4)
        cc.replanner = Replanner(cc.load_monitor, Config())
        first = cc.get_proposals(ignore_cache=True)
        roll_windows(cc, reporter, 3)  # stable workload: zero delta
        second, journal = journaled(
            ev, lambda: cc.get_proposals(ignore_cache=True))
        assert second is first  # the very same result object — no search
        (end,) = [e for e in journal if e["kind"] == "replan.end"]
        assert end["mode"] == "warm" and end.get("shortCircuit") is True
        assert cc.replanner.snapshot.generation == \
            cc.load_monitor.model_generation()
        cc.replanner.config.full_verify = True
        roll_windows(cc, reporter, 5)
        third = cc.get_proposals(ignore_cache=True)
        assert third is not second
        return journal, acts(third)

    assert scenario(*PORT) == scenario(*REF)


def test_facade_warm_failure_falls_back_cold(monkeypatch):
    def scenario(stack, Replanner, Config, ev, Optimizer):
        cc, _, reporter = stack(num_partitions=24, num_brokers=4)
        cc.replanner = Replanner(cc.load_monitor, Config())
        cc.get_proposals(ignore_cache=True)
        drift_broker(reporter, 1, 2.5, limit=3)
        roll_windows(cc, reporter, 3)
        real = Optimizer.optimize
        calls = {"warm": 0}

        def boom(self, state, options=None, warm_start=None, carry=None):
            if warm_start is not None:
                calls["warm"] += 1
                raise RuntimeError("scripted warm failure")
            return real(self, state, options)

        monkeypatch.setattr(Optimizer, "optimize", boom)
        res, journal = journaled(
            ev, lambda: cc.get_proposals(ignore_cache=True))
        assert calls["warm"] == 1 and res is not None
        assert cc.replanner.last_mode == "cold"
        assert cc.replanner.last_reason == "warm-failed"
        assert "replan.warm_failed" in [e["kind"] for e in journal]
        assert cc.replanner.snapshot is not None  # committed by fallback
        return acts(res), journal

    assert scenario(*PORT, GoalOptimizer) == scenario(*REF, RefGoalOptimizer)


def test_cuda_facade_replans_warm_riding_the_carry():
    """The cuda engine behind the replanner: the cold plan leaves a valid
    carry with tables, the warm plan rides the carried tables, verifies, and equals a carry-less warm search from the
    same warm start."""
    cc, _, reporter = full_stack(device="cpu", replan=ReplanConfig())
    rp = cc.replanner
    first = cc.get_proposals(ignore_cache=True)
    assert first.engine == "cuda" and rp.last_mode == "cold"
    assert rp.carry.valid and rp.carry.tables is not None
    drift_broker(reporter, 0, 2.5, limit=3)
    roll_windows(cc, reporter, 3)
    state, delta, _ = rp.build_model()
    ws, reason = rp.warm_start_for(state, delta)
    assert reason == "warm"
    plain = CudaGoalOptimizer(constraint=cc.constraint, device="cpu"
                              ).optimize(state, warm_start=ws)
    (warm, journal) = journaled(
        events, lambda: cc.get_proposals(ignore_cache=True))
    assert rp.last_mode == "warm" and warm.engine == "cuda"
    assert "replan.warm_failed" not in [e["kind"] for e in journal]
    end = [e for e in journal if e["kind"] == "replan.end"][-1]
    assert end["tableCarry"] is True and end["engine"] == "cuda"
    search = warm.goal_summaries[0]
    assert search["warm"]["table_carry"]
    assert search["warm"]["dirty_rows"] == int(delta.n_dirty_partitions)
    assert acts(warm) == acts(plain)
    verify_result(state, warm, make_goals(constraint=cc.constraint))


def test_threads_take_the_device_lock_in_one_order():
    """A self-healing fix through the replanner, proposal refreshes and
    direct plans on three threads, with the lock-order witness on: every
    edge into the engine's device lock runs one way, none out of it."""
    cc, backend, reporter = full_stack(
        device="cpu", replan=ReplanConfig(), replan_heals=True,
        detector=(AnomalyType.GOAL_VIOLATION,))
    cc.get_proposals(ignore_cache=True)
    state = cc.load_monitor.cluster_model()
    CONTENTION.enable_order_witness()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # surfaced below
            errors.append(e)

    try:
        threads = [
            threading.Thread(target=run, args=(lambda: [
                cc.anomaly_detector.run_detection_cycle(
                    now_ms=k * DETECTION_INTERVAL_MS) for k in range(2)],)),
            threading.Thread(target=run, args=(lambda: [
                cc.get_proposals(ignore_cache=True) for _ in range(2)],)),
            threading.Thread(target=run, args=(lambda: [
                CudaGoalOptimizer(device="cpu").optimize(state)
                for _ in range(2)],)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        edges = {(e["from"], e["to"])
                 for e in CONTENTION.order_witness()["edges"]}
    finally:
        CONTENTION.disable_order_witness()
    assert not errors, errors
    assert ("proposal.single_flight", "device") in edges
    assert not [e for e in edges if e[0] == "device"], edges
    assert not [(a, b) for a, b in edges if (b, a) in edges], edges

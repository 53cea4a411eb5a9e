"""The port's facade on the cuda engine (its default engine, run on the
CPU through the kernels' plain twins).

Every plan passes ``verify_result`` against the facade's own model, and its
violation score is within the parity tolerance of the reference facade's
plan on ``engine="tpu"`` over the same cluster: no more than
max(2, 5 %) above it.  Also here: the step loop outlives the per-request
optimizer (two requests of one shape share one loop, another shape gets
its own), the device lock serializes card work across threads, the
degradation ladder names the engine ``"cuda"`` and never degrades a plan
for the card to the CPU, and ``engine="tpu"`` is an unknown engine in the
port."""

import functools
import threading

import pytest

from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
from cruise_control_tpu_torch.analyzer.goal_optimizer import make_goals
from cruise_control_tpu_torch.analyzer.verifier import verify_result
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

port_stack = functools.partial(full_stack, device="cpu")


def within_parity(score: int, ref_score: int) -> bool:
    return score <= ref_score + max(2, 0.05 * ref_score)


def check_against_reference(op, options=None, **stack_kw):
    """Run ``op(cc)`` on the port's cuda facade and on the reference's tpu
    facade; verify the port's plan on its facade's model and hold its
    score to the reference's.  Returns the port's (result, backend)."""
    ref_cc, _, _ = ref_full_stack(engine="tpu", **stack_kw)
    want = op(ref_cc)
    cc, backend, _ = port_stack(**stack_kw)
    state = cc.load_monitor.cluster_model()
    got = op(cc)
    assert got.engine == "cuda" and want.engine == "tpu"
    verify_result(state, got, make_goals(constraint=cc.constraint), options)
    assert within_parity(got.violation_score_after,
                         want.violation_score_after), (
        got.violation_score_after, want.violation_score_after)
    return got, backend


def test_rebalance_dryrun_verifies_within_parity():
    result, _ = check_against_reference(lambda c: c.rebalance(dryrun=True))
    assert result.proposals and result.execution is None


def test_fix_offline_replicas_evacuates_within_parity():
    result, backend = check_against_reference(
        lambda c: c.fix_offline_replicas(dryrun=False), failed_brokers={2})
    assert result.execution is not None
    for p, st in backend.partitions.items():
        assert 2 not in st.replicas, f"partition {p} still on dead broker"


def test_remove_brokers_evacuates_within_parity():
    result, backend = check_against_reference(
        lambda c: c.remove_brokers([3], dryrun=False),
        options=OptimizationOptions(brokers_to_remove={3}))
    assert result.execution.succeeded
    for p, st in backend.partitions.items():
        assert 3 not in st.replicas, f"partition {p} still on broker 3"


def test_execute_applies_the_plan_to_the_backend():
    cc, backend, _ = port_stack()
    result = cc.rebalance(dryrun=False)
    assert result.engine == "cuda"
    assert result.execution is not None and result.execution.succeeded
    for prop in result.proposals:
        st = backend.partitions[prop.partition]
        assert set(st.replicas) == set(prop.new_replicas)
        assert st.leader == prop.new_leader


def test_requests_of_one_shape_share_one_step_loop(monkeypatch):
    """The facade builds a fresh optimizer for every request; the step
    loop (static buffers; on the card the captured chunk) is kept, one a
    device, so a second request of one shape steps on the first one's
    loop and plans the same, and another shape gets its own in its
    place."""
    built = []
    orig = C._StepLoop.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(C, "_LOOPS", {})
    monkeypatch.setattr(C._StepLoop, "__init__", spy)
    cc, _, _ = port_stack()
    r1 = cc.get_proposals()
    r2 = cc.get_proposals(ignore_cache=True)
    assert len(built) == 1 and C._LOOPS["cpu"][1] is built[0]
    other, _, _ = port_stack(num_partitions=30)
    other.get_proposals()
    assert len(built) == 2 and list(C._LOOPS) == ["cpu"]
    assert C._LOOPS["cpu"][1] is built[1]
    assert r2.goal_summaries[0]["graph_captures"] == 0
    assert [a.__dict__ for a in r1.actions] == [a.__dict__ for a in r2.actions]


def test_device_lock_serializes_card_work_across_threads():
    """A what-if batch fired while a plan runs waits for the plan (and the
    reverse): the engines take the device lock themselves, so the two
    never hold the card at once, and the plan is the one a lone request
    makes."""
    cc, _, _ = port_stack()
    alone = cc.rebalance(dryrun=True)
    inside, overlap = [], []
    from cruise_control_tpu_torch.whatif import engine as W

    # the work inside each engine's lock
    orig_opt, orig_eval = C.CudaGoalOptimizer._optimize, W.whatif_verdict

    def watched(fn):
        def run(*a, **kw):
            if inside:
                overlap.append(fn.__name__)
            inside.append(fn.__name__)
            try:
                return fn(*a, **kw)
            finally:
                inside.pop()
        return run

    C.CudaGoalOptimizer._optimize = watched(orig_opt)
    W.whatif_verdict = watched(orig_eval)
    try:
        out = {}
        plans = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, cc.rebalance(dryrun=True))) for i in range(2)]
        whatifs = [threading.Thread(target=lambda: cc.whatif(use_cache=False))
                   for _ in range(2)]
        for t in plans + whatifs:
            t.start()
        for t in plans + whatifs:
            t.join(60)
    finally:
        C.CudaGoalOptimizer._optimize = orig_opt
        W.whatif_verdict = orig_eval
    assert len(out) == 2 and not overlap
    for r in out.values():
        assert [a.__dict__ for a in r.actions] == \
            [a.__dict__ for a in alone.actions]


def test_degradation_ladder_names_the_cuda_engine():
    from cruise_control_tpu_torch.analyzer.degradation import (
        EngineDegradation,
    )

    prev = events.JOURNAL
    events.JOURNAL = events.EventJournal(enabled=True)
    cc, _, _ = port_stack()
    cc.engine_degradation = EngineDegradation(cooldown_s=60.0)

    def boom(self, *a, **kw):
        raise RuntimeError("CUDA out of memory")

    orig = C.CudaGoalOptimizer.optimize
    C.CudaGoalOptimizer.optimize = boom
    try:
        result = cc.rebalance(dryrun=True)
        (deg,) = events.JOURNAL.recent(kind="analyzer.engine_degraded")
    finally:
        C.CudaGoalOptimizer.optimize = orig
        events.JOURNAL = prev
    assert result.engine == "greedy"
    assert deg["payload"]["engine"] == "cuda"
    assert deg["payload"]["fallback"] == "greedy"


def test_degradation_ladder_never_degrades_a_plan_for_the_card():
    """On the card a failed cuda plan surfaces: the ladder's greedy rung
    would plan on the CPU, which hides a kernel or card failure."""
    from cruise_control_tpu_torch.analyzer.degradation import (
        EngineDegradation,
    )

    prev = events.JOURNAL
    events.JOURNAL = events.EventJournal(enabled=True)
    cc, _, _ = port_stack()
    cc.device = "cuda"
    cc.engine_degradation = EngineDegradation(cooldown_s=60.0)
    make = cc._make_engine

    class FailsOnTheCard:
        def optimize(self, *a, **kw):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    cc._make_engine = lambda engine, constraint=None: (
        FailsOnTheCard() if (engine or cc.default_engine) == "cuda"
        else make(engine, constraint))
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            cc.rebalance(dryrun=True)
        degraded = events.JOURNAL.recent(kind="analyzer.engine_degraded")
        failed = events.JOURNAL.recent(kind="optimize.failed")
    finally:
        events.JOURNAL = prev
    assert not degraded and len(failed) == 1
    assert not cc.engine_degradation.active()


def test_tpu_is_an_unknown_engine():
    cc, _, _ = port_stack()
    with pytest.raises(ValueError, match="unknown analyzer engine 'tpu'"):
        cc.rebalance(dryrun=True, engine="tpu")

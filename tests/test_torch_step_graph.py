"""The step loop in chunks of masked steps, on the CPU.

A scan call runs its steps in chunks (``analyzer/step_graph.py``; on the
card each chunk is a replayed CUDA graph) and reads the device carry once
a chunk; a step past the end of the loop commits nothing.  So the chunk
size must not change what a call returns: at N = 1, 3 and 16 steps a
chunk the ``ScanResult`` (actions, per-step counts, done flag, steps run,
repools and incremental repools) is the same, on a call that converges
inside a chunk (after a zero-commit step on stale pools forces a repool),
one that crosses several repools with the incremental diet on, and one
that ends on the slot budget.  The host reads the carry
ceil(steps / N) times and fetches the output once.  A whole plan is the
same at N = 1 and 16."""

import math

import numpy as np
import pytest

from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext
from cruise_control_tpu_torch.models import generators as gen

#: (config, steps a call) → a call that converges inside a chunk, one that
#: crosses repools (the selection keeps 16 rows, so the slot budget of
#: repool_steps · 64 leaves room for several repools), one that ends on the
#: slot budget
SCENARIOS = {
    "converges": (dict(repool_steps=128, device_batch_per_step=32), 64),
    "repools": (dict(repool_steps=4, device_batch_per_step=64,
                     selection_rows=16, repool_rows_budget=100), 40),
    "slot_budget": (dict(repool_steps=6, device_batch_per_step=32), 32),
}


def _call(kw, T, chunk):
    state = gen.random_cluster(seed=3, num_brokers=20, num_racks=5,
                               num_partitions=300, mean_utilization=0.4,
                               distribution=gen.Distribution.EXPONENTIAL)
    opt = C.CudaGoalOptimizer(device="cpu")
    ctx = AnalyzerContext(state)
    m = opt._device_model(ctx)
    ca = opt._constraint_arrays(ctx)
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    cfg = C._resolve_batch(C.CudaSearchConfig(steps_per_call=T, **kw),
                           ctx.num_brokers)
    res, m_out, tab = C._scan_call(m, cfg, ca, C.grid_consts(cfg, ca, "cpu"),
                                   K, D, T, C._cold_tables(m), chunk=chunk)
    return res, m_out, tab


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_chunked_masked_loop_equals_the_per_step_loop(scenario):
    kw, T = SCENARIOS[scenario]
    runs = {n: _call(kw, T, n) for n in (1, 3, 16)}
    ref, m_ref, tab_ref = runs[1]
    steps = ref.diag["steps_run"]
    if scenario == "converges":
        assert ref.done and steps < T and steps % 3 and steps % 16
        # the stale pools' zero-commit step forced one more repool
        assert list(ref.step_counts[-2:]) == [0, 0]
    elif scenario == "repools":
        assert not ref.done and steps < T
        assert ref.diag["repools"] >= 4
        assert ref.diag["n_incremental_repool"] >= 3
    else:
        assert not ref.done and steps < T
        count = int(ref.step_counts.sum())
        slots = kw["repool_steps"] * kw["device_batch_per_step"]
        assert count > slots - kw["device_batch_per_step"]
    assert len(ref.kind) == int(ref.step_counts.sum()) > 0
    for n, (res, m_out, tab) in runs.items():
        for f in ("kind", "p", "s", "d", "step_counts"):
            assert np.array_equal(getattr(res, f), getattr(ref, f)), (n, f)
        assert res.done == ref.done
        for f in ("steps_run", "repools", "n_incremental_repool"):
            assert res.diag[f] == ref.diag[f], (n, f)
        for f in C.MUTABLE:
            a, b = getattr(m_out, f), getattr(m_ref, f)
            assert (a is None and b is None) or bool((a == b).all()), (n, f)
        for a, b in zip(tab, tab_ref):
            assert bool((a == b).all()), n
        # one carry read a chunk, one fetch of the output
        assert res.diag["host_syncs"] == math.ceil(steps / n) + 1, n
        assert res.diag["graph_replays"] == 0


def test_plan_is_the_same_at_any_chunk(monkeypatch):
    state = gen.random_cluster(seed=42, num_brokers=20, num_racks=5,
                               num_partitions=400)
    plans = {}
    for n in (1, 16):
        monkeypatch.setattr(C, "STEP_CHUNK", n)
        res = C.CudaGoalOptimizer(device="cpu").optimize(state)
        summ = res.goal_summaries[0]
        plans[n] = ([(int(a.action_type), a.partition, a.slot,
                      a.source_broker, a.dest_broker, a.dest_slot)
                     for a in res.actions], summ["steps"], summ["repools"])
        assert summ["graph_replays"] == 0
        assert summ["host_syncs"] <= summ["steps"] / n + 2 * summ["rounds"]
    assert plans[1] == plans[16] and plans[1][0]


def test_optimizer_keeps_its_loop_for_searches_of_one_shape(monkeypatch):
    """A second search of the same shape steps on the first one's static
    buffers (on the card: replays its captured chunk) and plans exactly as
    a fresh optimizer does; another shape gets a loop of its own, kept in
    the first one's place (one loop a device)."""
    monkeypatch.setattr(C, "_LOOPS", {})
    kw = dict(num_brokers=20, num_racks=5, num_partitions=300)
    opt = C.CudaGoalOptimizer(device="cpu")
    opt.optimize(gen.random_cluster(seed=5, **kw))
    loop = C._LOOPS["cpu"][1]
    state = gen.random_cluster(seed=6, **kw)
    again = opt.optimize(state)
    assert C._LOOPS["cpu"][1] is loop
    del C._LOOPS["cpu"]  # the next search builds a fresh loop
    fresh = C.CudaGoalOptimizer(device="cpu").optimize(state)
    assert C._LOOPS["cpu"][1] is not loop
    assert again.actions == fresh.actions and again.actions
    opt.optimize(gen.random_cluster(seed=6, num_brokers=20, num_racks=5,
                                    num_partitions=200))
    assert list(C._LOOPS) == ["cpu"] and C._LOOPS["cpu"][1] is not loop

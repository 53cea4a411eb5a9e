"""The port's delta-replan model side against the reference's
(``tests/test_replan.py``, first half): the aggregator's dirty tracking,
the monitor's delta model build, the context's reseed, the signature-based
partial re-verification and the greedy engine's warm plans.  Each scenario
runs once on the reference's package and stack and once on the port's
(greedy engine, CPU), and the port must give the reference's results
exactly: the same dirty sets, the same model bits, the same verdicts, the
same actions."""

import importlib

import numpy as np
import pytest

from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import WINDOW
from harness import full_stack as ref_full_stack

PKGS = ("cruise_control_tpu", "cruise_control_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def stack(pkg: str, **kw):
    if pkg == "cruise_control_tpu":
        return ref_full_stack(**kw)
    return full_stack(engine="greedy", device="cpu", **kw)


def roll_windows(cc, reporter, start_window: int, n: int = 2):
    for k in range(start_window, start_window + n):
        reporter.report(time_ms=k * WINDOW + 500)
        cc.load_monitor.run_sampling_iteration((k + 1) * WINDOW)


def drift_broker(reporter, broker: int, factor: float, limit=None):
    w = reporter.workload
    parts = [p for p, reps in w.assignment.items() if broker in reps]
    if limit is not None:
        parts = parts[:limit]
    for p in parts:
        w.bytes_in[p] *= factor
        w.bytes_out[p] *= factor
    return parts


def arrays(state, *names):
    return {n: np.asarray(getattr(state, n)) for n in names}


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)


def acts(result):
    return [(int(a.action_type), a.partition, a.slot, a.source_broker,
             a.dest_broker, a.dest_slot) for a in result.actions]


def both(scenario):
    """``scenario(pkg)`` on the reference and on the port → (ref, port)."""
    return tuple(scenario(pkg) for pkg in PKGS)


# ---- aggregator dirty tracking ---------------------------------------------------
def test_aggregator_dirty_entities_since():
    def scenario(pkg):
        defs = mod(pkg, "monitor.metric_defs")
        d = defs.MetricDef()
        d.define("m", defs.AggregationFunction.AVG)
        d.freeze()
        agg = mod(pkg, "monitor.aggregator").MetricSampleAggregator(
            d, num_entities=4, window_ms=100, num_windows=3)
        agg.add_sample(0, 50, [1.0])
        mark = agg.generation
        out = [agg.dirty_entities_since(mark).tolist()]
        agg.add_sample(2, 60, [2.0])
        out.append(agg.dirty_entities_since(mark).tolist())
        for w in range(1, 6):
            agg.add_sample(1, w * 100 + 1, [1.0])
        out.append((agg.eviction_generation > mark,
                    agg.dirty_entities_since(mark).tolist()))
        mark2 = agg.generation
        agg.ensure_entities(6)
        out.append(agg.dirty_entities_since(mark2).tolist())
        return out

    ref, port = both(scenario)
    assert port == ref
    assert port[1] == [False, False, True, False]
    assert port[2][0] and all(port[2][1]) and all(port[3][4:])


# ---- monitor delta build ---------------------------------------------------------
LOADS = ("leader_load", "follower_load")


def test_cluster_model_delta_patches_only_dirty_rows():
    def scenario(pkg):
        cc, _, reporter = stack(pkg, num_partitions=24, num_brokers=4)
        mon = cc.load_monitor
        prev = mon.cluster_model()
        mark = mon.aggregation_mark()
        drifted = drift_broker(reporter, 0, 3.0)
        roll_windows(cc, reporter, 3)
        state, delta = mon.cluster_model_delta(prev, mark)
        return (prev, state, mon._cluster_model(), delta, drifted)

    (rprev, rstate, rfresh, rdelta, _), (prev, state, fresh, delta,
                                         drifted) = both(scenario)
    assert not delta.full
    assert delta.load_changed and not delta.topology_changed
    dirty = delta.dirty_partitions
    assert np.array_equal(dirty, rdelta.dirty_partitions)
    assert dirty.any() and set(np.nonzero(dirty)[0]) <= set(drifted)
    nl, pl = np.asarray(state.leader_load), np.asarray(prev.leader_load)
    fl = np.asarray(fresh.leader_load)
    assert np.array_equal(nl[~dirty], pl[~dirty])
    assert np.array_equal(nl[dirty], fl[dirty])
    assert np.array_equal(np.asarray(state.follower_load)[dirty],
                          np.asarray(fresh.follower_load)[dirty])
    assert same(arrays(state, *LOADS), arrays(rstate, *LOADS))


def test_cluster_model_delta_broker_death_and_add():
    def scenario(pkg):
        cc, backend, reporter = stack(pkg, num_partitions=24, num_brokers=4)
        mon = cc.load_monitor
        prev = mon.cluster_model()
        mark = mon.aggregation_mark()
        backend.failed_brokers.add(3)
        roll_windows(cc, reporter, 3)
        state, delta = mon.cluster_model_delta(prev, mark)
        mark2 = mon.aggregation_mark()
        backend.brokers.add(4)
        mon.metadata.broker_rack[4] = 0
        roll_windows(cc, reporter, 5)
        state2, delta2 = mon.cluster_model_delta(state, mark2)
        return prev, delta, state2, delta2

    ref, (prev, delta, state2, delta2) = both(scenario)
    assert not delta.full and delta.topology_changed
    assert delta.removed_brokers == (3,) and delta.dirty_brokers[3]
    hosts3 = np.any(np.asarray(prev.assignment) == 3, axis=1)
    assert (delta.dirty_topology >= hosts3).all()
    assert not delta2.full
    assert delta2.shape_changed and delta2.added_brokers == (4,)
    assert state2.num_brokers == 5
    assert np.asarray(state2.broker_capacity).shape[0] == 5
    for got, want in ((delta, ref[1]), (delta2, ref[3])):
        for f in ("dirty_partitions", "dirty_topology", "dirty_brokers"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.removed_brokers == want.removed_brokers
        assert got.added_brokers == want.added_brokers
    assert same(arrays(state2, "assignment", "broker_capacity", *LOADS),
                arrays(ref[2], "assignment", "broker_capacity", *LOADS))


def test_cluster_model_delta_falls_back_full_on_universe_drift():
    def scenario(pkg):
        cc, backend, _ = stack(pkg, num_partitions=12, num_brokers=3)
        mon = cc.load_monitor
        prev = mon.cluster_model()
        mark = mon.aggregation_mark()
        backend.partitions[99] = type(next(iter(
            backend.partitions.values())))(replicas=[0, 1], leader=0)
        state, delta = mon.cluster_model_delta(prev, mark)
        return delta.full, delta.reason, state.num_partitions

    ref, port = both(scenario)
    assert port == ref == (True, "partition-universe-changed", 13)


# ---- context reseed + partial verify ---------------------------------------------
def test_reseed_rebuilds_exact_aggregates():
    def scenario(pkg):
        state = mod(pkg, "models.generators").random_cluster(
            seed=9, num_brokers=6, num_racks=3, num_partitions=40)
        res = mod(pkg, "analyzer.goal_optimizer").GoalOptimizer().optimize(
            state)
        Ctx = mod(pkg, "analyzer.context").AnalyzerContext
        ctx = Ctx(state)
        ctx.reseed(np.asarray(res.final_state.assignment),
                   np.asarray(res.final_state.leader_slot))
        truth = Ctx(res.final_state)
        assert np.allclose(ctx.broker_load, truth.broker_load)
        assert np.array_equal(ctx.broker_replica_count,
                              truth.broker_replica_count)
        assert np.array_equal(ctx.broker_leader_count,
                              truth.broker_leader_count)
        ctx.recompute_check()
        return (acts(res), ctx.broker_load, ctx.replica_offline,
                ctx.offline_origin)

    ref, port = both(scenario)
    assert port[0] == ref[0]
    for got, want in zip(port[1:], ref[1:]):
        assert np.array_equal(got, want)


def test_partial_violations_signature_reuse_is_exact():
    def scenario(pkg):
        state = mod(pkg, "models.generators").random_cluster(
            seed=4, num_brokers=6, num_racks=3, num_partitions=40)
        V = mod(pkg, "analyzer.verifier")
        Ctx = mod(pkg, "analyzer.context").AnalyzerContext
        goals = mod(pkg, "analyzer.goal_optimizer").make_goals()
        ctx = Ctx(state)
        sigs = V.goal_input_signatures(ctx, goals)
        truth = {g.name: g.violations(ctx) for g in goals}
        wrong = {name: v + 100 for name, v in truth.items()}
        reused_viol, _, reused = V.partial_violations(ctx, goals, sigs, wrong)
        assert set(reused) == set(truth) and reused_viol == wrong
        ctx2 = Ctx(state)
        ctx2.leader_load = ctx2.leader_load.copy()
        ctx2.leader_load[0] *= 1.5
        viol2, sigs2, reused2 = V.partial_violations(ctx2, goals, sigs, wrong)
        for g in goals:
            if "loads" in g.inputs:
                assert g.name not in reused2
                assert viol2[g.name] == g.violations(ctx2)
            else:
                assert g.name in reused2
        full_viol, _, none_reused = V.partial_violations(
            ctx, goals, sigs, wrong, force_full=True)
        assert none_reused == [] and full_viol == truth
        return sigs, truth, viol2, sigs2, reused2

    ref, port = both(scenario)
    assert port == ref


# ---- warm-vs-cold equivalence (property-style) -----------------------------------
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_warm_plan_score_within_parity_tolerance(seed):
    """Seeded drift deltas on the greedy engine: the warm plan verifies,
    scores inside the tolerance of the cold plan on the same drifted
    model, and equals the reference's warm and cold plans action for
    action."""
    def scenario(pkg):
        rng = np.random.default_rng(seed)
        cc, _, reporter = stack(pkg, num_partitions=24, num_brokers=4)
        mon = cc.load_monitor
        prev = mon.cluster_model()
        mark = mon.aggregation_mark()
        G = mod(pkg, "analyzer.goal_optimizer")
        V = mod(pkg, "analyzer.verifier")
        prev_res = G.GoalOptimizer().optimize(prev)
        broker = int(rng.integers(0, 4))
        factor = float(rng.uniform(1.5, 4.0))
        drift_broker(reporter, broker, factor, limit=4)
        roll_windows(cc, reporter, 3)
        state, delta = mon.cluster_model_delta(prev, mark)
        assert not delta.full and delta.dirty_partitions.any()
        goals = G.make_goals()
        cold = G.GoalOptimizer().optimize(state)
        fctx = mod(pkg, "analyzer.context").AnalyzerContext(
            prev_res.final_state)
        warm = G.GoalOptimizer().optimize(state, warm_start=mod(
            pkg, "replan.delta").WarmStart(
            assignment=np.asarray(prev_res.final_state.assignment),
            leader_slot=np.asarray(prev_res.final_state.leader_slot),
            prev_actions=list(prev_res.actions),
            dirty_partitions=delta.dirty_partitions,
            prev_signatures=V.goal_input_signatures(fctx, goals),
            prev_violations=prev_res.violations_after,
        ))
        V.verify_result(state, warm, goals)
        s_cold = V.violation_score(cold.final_state, goals)
        s_warm = V.violation_score(warm.final_state, goals)
        assert s_warm <= s_cold + max(1, round(0.02 * s_cold)), (
            seed, s_warm, s_cold)
        return acts(warm), acts(cold), s_warm, s_cold, warm.replan_verify

    ref, port = both(scenario)
    assert port == ref

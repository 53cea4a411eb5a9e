"""The port's facade operations against the reference's (mirror of
``tests/test_facade.py``'s rebalance, broker and offline-replica tests).

Each test builds the same skewed simulated cluster twice — the reference's
``harness.full_stack`` and the port's ``tools.served_stack.full_stack`` on
the CPU — runs one operation on the greedy engine through both facades and
holds the port to the reference exactly: the same proposals, the same
violations, and (for executions) the same final backend placement.  The
reference test's own assertions then run on the port's side."""

import functools

import pytest

from cruise_control_tpu_torch.server.progress import OperationProgress
from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

port_stack = functools.partial(full_stack, device="cpu", engine="greedy")


def proposals_of(result):
    return [(p.partition, p.topic, p.old_leader, p.new_leader,
             tuple(p.old_replicas), tuple(p.new_replicas),
             tuple(p.disk_moves)) for p in result.proposals]


def placement(backend):
    return {p: (list(st.replicas), st.leader)
            for p, st in backend.partitions.items()}


def both(op, **stack_kw):
    """Run ``op(cc)`` on the reference's stack and on the port's; hold the
    port's result and backend to the reference's.  Returns the port's
    (result, backend)."""
    ref_cc, ref_backend, _ = ref_full_stack(**stack_kw)
    cc, backend, _ = port_stack(**stack_kw)
    want, got = op(ref_cc), op(cc)
    assert proposals_of(got) == proposals_of(want)
    assert got.violations_before == want.violations_before
    assert got.violations_after == want.violations_after
    assert got.engine == want.engine == "greedy"
    assert (got.execution is None) == (want.execution is None)
    assert placement(backend) == placement(ref_backend)
    return got, backend


class TestRebalance:
    def test_dryrun_produces_proposals_without_touching_cluster(self):
        cc, backend, _ = port_stack()
        before = placement(backend)
        result, backend = both(lambda c: c.rebalance(dryrun=True))
        assert result.proposals
        assert result.execution is None
        assert placement(backend) == before

    def test_execute_applies_proposals_to_backend(self):
        result, backend = both(lambda c: c.rebalance(dryrun=False))
        assert result.execution is not None and result.execution.succeeded
        # the backend now matches the plan's target placement
        for prop in result.proposals:
            st = backend.partitions[prop.partition]
            assert set(st.replicas) == set(prop.new_replicas)
            assert st.leader == prop.new_leader

    def test_improves_leader_balance(self):
        result, backend = both(lambda c: c.rebalance(dryrun=False))
        leaders = [st.leader for st in backend.partitions.values()]
        # the skewed workload starts with ALL leaders on broker 0
        assert leaders.count(0) < len(leaders)
        assert result.violation_score_after <= result.violation_score_before

    def test_goal_subset_by_name(self):
        result, _ = both(lambda c: c.rebalance(
            goals=["ReplicaDistributionGoal"], dryrun=True))
        assert set(result.violations_after) == {"ReplicaDistributionGoal"}

    def test_progress_steps_recorded(self):
        cc, _, _ = port_stack()
        progress = OperationProgress("REBALANCE")
        cc.rebalance(dryrun=True, progress=progress)
        steps = [s["step"] for s in progress.to_json()["operationProgress"]]
        assert any("cluster model" in s.lower() for s in steps)
        assert any("optimizing" in s.lower() for s in steps)


class TestBrokerOperations:
    def test_add_brokers_moves_load_onto_new_broker(self):
        result, backend = both(lambda c: c.add_brokers([9], dryrun=False),
                               extra_brokers=(9,))
        assert result.execution.succeeded
        on_new = [
            p for p, st in backend.partitions.items() if 9 in st.replicas
        ]
        assert on_new, "no replicas moved onto the added broker"

    def test_remove_brokers_evacuates(self):
        result, backend = both(lambda c: c.remove_brokers([3], dryrun=False))
        assert result.execution.succeeded
        for p, st in backend.partitions.items():
            assert 3 not in st.replicas, f"partition {p} still on broker 3"

    def test_demote_brokers_moves_leadership_only(self):
        cc, backend, _ = port_stack()
        before = {p: list(st.replicas) for p, st in backend.partitions.items()}
        result, backend = both(lambda c: c.demote_brokers([0], dryrun=False))
        assert result.execution.succeeded
        for p, st in backend.partitions.items():
            assert st.leader != 0
            assert set(st.replicas) == set(before[p]), "replicas moved"

    def test_unknown_broker_raises(self):
        cc, _, _ = port_stack()
        with pytest.raises(ValueError, match="unknown broker"):
            cc.add_brokers([99], dryrun=True)


class TestFixOfflineReplicas:
    def test_evacuates_dead_broker(self):
        result, backend = both(lambda c: c.fix_offline_replicas(dryrun=False),
                               failed_brokers={2})
        assert result.execution is not None
        for p, st in backend.partitions.items():
            assert 2 not in st.replicas, f"partition {p} still on dead broker"

"""The port's facade: replication-factor changes through the goal chain and
the facade's constraint handling (mirror of ``tests/test_facade.py``), on
the CPU, each plan held to the reference facade's on the same input."""

import contextlib
import functools

import pytest

from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

port_stack = functools.partial(full_stack, device="cpu", engine="greedy")


def proposals_of(result):
    return sorted((p.partition, p.old_leader, p.new_leader,
                   tuple(p.old_replicas), tuple(p.new_replicas))
                  for p in result.proposals)


class _StubMonitor:
    metadata = object()

    def __init__(self, state):
        self.state = state

    def acquire_for_model_generation(self):
        return contextlib.nullcontext()

    def cluster_model(self, requirements=None):
        return self.state


def _rf_increase_model(pkg):
    """The capacity trap: X on broker 0, broker 1 nearly full, broker 2
    roomy but with a higher replica count (built by ``pkg``'s builder)."""
    import importlib

    builder = importlib.import_module(f"{pkg}.models.builder")
    Resource = importlib.import_module(f"{pkg}.common.resources").Resource
    b = builder.ClusterModelBuilder()
    cap = {Resource.CPU: 1e4, Resource.NW_IN: 1e6, Resource.NW_OUT: 1e6,
           Resource.DISK: 100.0}
    b.add_broker("r0", cap)   # hosts X
    b.add_broker("r1", cap)   # nearly full: naive count-based pick
    b.add_broker("r2", cap)   # roomy but higher replica count
    tiny = {Resource.CPU: 1.0, Resource.NW_IN: 1.0, Resource.NW_OUT: 1.0,
            Resource.DISK: 5.0}
    b.add_partition("X", [0], {Resource.CPU: 1.0, Resource.NW_IN: 1.0,
                               Resource.NW_OUT: 1.0, Resource.DISK: 10.0})
    b.add_partition("BIG", [1], {Resource.CPU: 1.0, Resource.NW_IN: 1.0,
                                 Resource.NW_OUT: 1.0, Resource.DISK: 75.0})
    b.add_partition("S1", [2], tiny)
    b.add_partition("S2", [2], tiny)
    return b.build()


def _rack_model(pkg):
    import importlib

    builder = importlib.import_module(f"{pkg}.models.builder")
    Resource = importlib.import_module(f"{pkg}.common.resources").Resource
    b = builder.ClusterModelBuilder()
    cap = {Resource.CPU: 1e4, Resource.NW_IN: 1e6, Resource.NW_OUT: 1e6,
           Resource.DISK: 1e4}
    for r in ("r0", "r1", "r1", "r2", "r2"):
        b.add_broker(r, cap)
    # leader on r0; followers r1, r1, r2 — RF 4 -> 3 must drop one of the
    # r1 twins and KEEP broker 3 (r2), never re-copy onto broker 4
    b.add_partition("T", [0, 1, 2, 3], {Resource.DISK: 10.0})
    return b.build()


def _stub_facade(pkg, state, assignment, leaders, **backend_kw):
    import importlib

    backend_mod = importlib.import_module(f"{pkg}.executor.backend")
    executor_mod = importlib.import_module(f"{pkg}.executor.executor")
    facade_mod = importlib.import_module(f"{pkg}.facade")
    backend = backend_mod.SimulatedClusterBackend(assignment, leaders,
                                                  **backend_kw)
    return facade_mod.CruiseControl(_StubMonitor(state),
                                    executor_mod.Executor(backend))


def test_rf_increase_respects_capacity_goals():
    """An RF increase that would overflow a broker picks a different
    destination through the goal chain."""
    results = {}
    for pkg in ("cruise_control_tpu", "cruise_control_tpu_torch"):
        cc = _stub_facade(
            pkg, _rf_increase_model(pkg), {0: [0], 1: [1], 2: [2], 3: [2]},
            {0: 0, 1: 1, 2: 2, 3: 2}, brokers={0, 1, 2})
        results[pkg] = cc.fix_topic_replication_factor(
            2, dryrun=True, topic_regex="X")
    result = results["cruise_control_tpu_torch"]
    assert proposals_of(result) == proposals_of(results["cruise_control_tpu"])
    by_p = {pr.partition: pr for pr in result.proposals}
    assert 0 in by_p, result.proposals
    # broker 1 would breach disk capacity (75 + 10 > 80): the goal chain
    # must place X's new replica on broker 2 despite its higher count
    assert set(by_p[0].new_replicas) == {0, 2}
    assert set(by_p[0].old_replicas) == {0}


def test_rf_decrease_emits_removal_proposals():
    """RF decreases produce executable removal proposals."""
    ref_cc, ref_backend, _ = ref_full_stack(rf=2)
    cc, backend, _ = port_stack(rf=2)
    want = ref_cc.fix_topic_replication_factor(1, dryrun=False)
    result = cc.fix_topic_replication_factor(1, dryrun=False)
    assert proposals_of(result) == proposals_of(want)
    assert result.proposals, "no removal proposals emitted"
    assert result.execution is not None and result.execution.succeeded
    for p, st in backend.partitions.items():
        assert len(set(st.replicas)) == 1, (p, st)
        assert list(st.replicas) == list(ref_backend.partitions[p].replicas)


def test_rf_decrease_keeps_data_hosting_rack_diverse_replicas():
    """The keep-selection updates its rack set live: duplicate-rack
    followers are dropped before rack-distinct ones."""
    results = {}
    for pkg in ("cruise_control_tpu", "cruise_control_tpu_torch"):
        cc = _stub_facade(pkg, _rack_model(pkg), {0: [0, 1, 2, 3]}, {0: 0})
        results[pkg] = cc.fix_topic_replication_factor(3, dryrun=True)
    result = results["cruise_control_tpu_torch"]
    assert proposals_of(result) == proposals_of(results["cruise_control_tpu"])
    (pr,) = result.proposals
    assert set(pr.old_replicas) == {0, 1, 2, 3}
    kept = set(pr.new_replicas)
    assert 0 in kept and 3 in kept          # leader + the rack-distinct r2
    assert len(kept & {1, 2}) == 1          # exactly one r1 twin dropped
    assert 4 not in kept                    # no data copy to a fresh broker


def test_shared_constraint_not_mutated_by_facade():
    """CruiseControl.__init__ works on a copy of a shared constraint."""
    from cruise_control_tpu_torch.analyzer.goals.base import (
        BalancingConstraint,
    )
    from cruise_control_tpu_torch.executor.backend import (
        SimulatedClusterBackend,
    )
    from cruise_control_tpu_torch.executor.executor import Executor
    from cruise_control_tpu_torch.facade import CruiseControl

    original = {"by-name": {0, 1}, 7: {2}}
    shared = BalancingConstraint(broker_sets=dict(original))
    backend = SimulatedClusterBackend({0: [0]}, {0: 0}, brokers={0, 1, 2})
    cc = CruiseControl(object(), Executor(backend), constraint=shared)
    assert shared.broker_sets == original
    assert cc.constraint is not shared
    assert cc.constraint.broker_sets == {7: {2}}


def test_rf_change_topic_regex_never_widens_silently():
    """A topic_regex matching no topic raises instead of applying the RF
    change to every topic."""
    cc, _, _ = port_stack()
    with pytest.raises(ValueError, match="matches no topic"):
        cc.fix_topic_replication_factor(2, dryrun=True,
                                        topic_regex="no-such-topic")

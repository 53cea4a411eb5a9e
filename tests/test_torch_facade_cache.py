"""The port's facade: the proposals cache, the state aggregate, id
translation, sanity checks and the proposal precompute daemon (mirror of
``tests/test_facade.py``), on the CPU.  Where a test plans, the port's
plan is held to the reference facade's on the same cluster exactly."""

import functools

import numpy as np
import pytest

from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

port_stack = functools.partial(full_stack, device="cpu", engine="greedy")


def proposals_of(result):
    return [(p.partition, p.old_leader, p.new_leader, tuple(p.old_replicas),
             tuple(p.new_replicas)) for p in result.proposals]


class TestProposalsCache:
    def test_cache_hit_and_invalidation(self):
        cc, _, _ = port_stack()
        r1 = cc.get_proposals()
        r2 = cc.get_proposals()
        assert r2 is r1  # served from cache
        cc.invalidate_proposal_cache()
        r3 = cc.get_proposals()
        assert r3 is not r1
        ref_cc, _, _ = ref_full_stack()
        assert proposals_of(r3) == proposals_of(ref_cc.get_proposals())

    def test_ignore_cache_recomputes(self):
        cc, _, _ = port_stack()
        r1 = cc.get_proposals()
        r2 = cc.get_proposals(ignore_cache=True)
        assert r2 is not r1
        assert proposals_of(r2) == proposals_of(r1)


class TestStateAggregate:
    def test_state_covers_all_subsystems(self):
        cc, _, _ = port_stack()
        st = cc.state()
        assert st["MonitorState"]["state"] == "RUNNING"
        assert st["ExecutorState"]["state"] == "NO_TASK_IN_PROGRESS"
        ref = ref_full_stack()[0].state()
        assert st["AnalyzerState"]["readyGoals"] == \
            ref["AnalyzerState"]["readyGoals"] != []
        assert st["MonitorState"] == ref["MonitorState"]

    def test_sampling_pause_resume_via_facade(self):
        cc, _, _ = port_stack()
        cc.pause_sampling()
        assert cc.state()["MonitorState"]["state"] == "PAUSED"
        cc.resume_sampling()
        assert cc.state()["MonitorState"]["state"] == "RUNNING"


class TestIdTranslation:
    def test_goal_subset_with_cuda_engine_falls_back_to_greedy(self):
        cc, backend, _ = port_stack(engine="cuda")
        before = {p: list(st.replicas) for p, st in backend.partitions.items()}
        result = cc.demote_brokers([0], dryrun=False, engine="cuda")
        assert result.engine == "greedy"  # subset ops pin greedy semantics
        for p, st in backend.partitions.items():
            assert st.leader != 0
            assert set(st.replicas) == set(before[p]), "replicas moved"

    def test_execution_invalidates_proposal_cache(self):
        cc, _, _ = port_stack()
        r1 = cc.get_proposals()
        cc.rebalance(dryrun=False)
        r2 = cc.get_proposals()
        assert r2 is not r1, "stale pre-execution proposals served from cache"

    def test_sparse_partition_ids_translate(self):
        from cruise_control_tpu_torch.executor.backend import (
            SimulatedClusterBackend,
        )
        from cruise_control_tpu_torch.executor.executor import Executor
        from cruise_control_tpu_torch.facade import CruiseControl
        from cruise_control_tpu_torch.monitor.load_monitor import (
            BackendMetadataClient, LoadMonitor,
        )
        from cruise_control_tpu_torch.monitor.sampling import (
            MetricsReporterSampler, MetricsTopic, SimulatedMetricsReporter,
            WorkloadModel,
        )

        # sparse partition keys (a deletion left holes) + sparse broker ids
        pids = [0, 2, 5, 9, 12, 17]
        brokers = [100, 101, 102]
        assignment = {p: [100, 101 + i % 2] for i, p in enumerate(pids)}
        leaders = {p: 100 for p in pids}
        n = max(pids) + 1
        rng = np.random.default_rng(5)
        w = WorkloadModel(
            bytes_in=rng.uniform(100, 1000, n),
            bytes_out=rng.uniform(100, 2000, n),
            size_mb=rng.uniform(10, 500, n),
            assignment=assignment, leaders=leaders,
        )
        backend = SimulatedClusterBackend(
            {p: list(r) for p, r in assignment.items()}, dict(leaders),
            brokers=set(brokers),
        )
        topic = MetricsTopic()
        rep = SimulatedMetricsReporter(w, topic)
        monitor = LoadMonitor(
            BackendMetadataClient(backend, {b: b % 2 for b in brokers}),
            MetricsReporterSampler(topic), window_ms=1000, num_windows=5,
        )
        for i in range(3):
            rep.report(time_ms=i * 1000 + 500)
            monitor.run_sampling_iteration((i + 1) * 1000)
        cc = CruiseControl(monitor, Executor(backend), device="cpu")
        result = cc.rebalance(dryrun=False)
        assert result.execution.succeeded
        # every executed proposal addressed a real external partition/broker
        leaders_now = [st.leader for st in backend.partitions.values()]
        assert leaders_now.count(100) < len(pids)
        for st in backend.partitions.values():
            assert set(st.replicas) <= set(brokers)

    def test_duplicate_external_ids_rejected(self):
        from cruise_control_tpu_torch.models.builder import (
            ClusterModelBuilder,
        )

        b = ClusterModelBuilder()
        b.add_broker(0, [1.0, 1.0, 1.0, 1.0], broker_id=7)
        b.add_broker(0, [1.0, 1.0, 1.0, 1.0], broker_id=7)
        with pytest.raises(ValueError, match="duplicate external broker"):
            b.build()


class TestSanityChecks:
    def test_ongoing_execution_blocks_new_operation(self):
        from cruise_control_tpu_torch.executor.executor import (
            ExecutorStateValue,
            OngoingExecutionError,
        )

        cc, _, _ = port_stack()
        cc.executor.state = (
            ExecutorStateValue.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
        )
        with pytest.raises(OngoingExecutionError):
            cc.rebalance(dryrun=False)
        # dryrun is still allowed during an execution
        result = cc.rebalance(dryrun=True)
        assert result is not None


class TestProposalPrecompute:
    def test_background_precompute_fills_cache(self):
        import time as _t

        cc, backend, _ = port_stack()
        assert cc._cached_proposals is None
        pre = cc.start_proposal_precomputation(interval_s=0.01)
        deadline = _t.time() + 5.0
        while pre.runs == 0 and _t.time() < deadline:
            _t.sleep(0.02)
        cc.stop_proposal_precomputation()
        assert pre.runs > 0
        assert cc._cached_proposals is not None
        # GET /proposals is now a cache hit
        r = cc.get_proposals()
        assert r is cc._cached_proposals
        st = cc.state()["AnalyzerState"]
        assert st["isProposalReady"]

    def test_refresh_once_records_errors(self):
        from cruise_control_tpu_torch.analyzer.precompute import (
            ProposalPrecomputingExecutor,
        )

        class Boom:
            def get_proposals(self, **kw):
                raise RuntimeError("model not ready")

        pre = ProposalPrecomputingExecutor(Boom(), interval_s=999)
        assert pre.refresh_once() is False
        assert pre.errors == 1 and "model not ready" in pre.last_error

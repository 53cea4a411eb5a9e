"""The port's config registry against the reference's
(``tests/test_config.py``).

Every reference key has its counterpart in the port under the engine
group's renaming (``use.tpu.optimizer`` → ``use.cuda.optimizer``,
``tpu.mesh.devices`` → ``cuda.mesh.devices``, ``tpu.search.*`` →
``cuda.search.*``), with the same type, default, importance and validator
(probed on the same values), except the keys the port drops (XLA's
compilation cache, the TPU's approximate top-k) and the keys
:data:`OTHER_DEFAULTS` lists.  The 35 ``cuda.search.*`` keys reach the same ``CudaSearchConfig`` fields the
reference's keys reach on ``TpuSearchConfig``; a class path into the JAX
package is refused; the whole server boots from a properties file with
one override per subsystem, each landing on its component."""

import dataclasses
import subprocess
import sys

import pytest

from cruise_control_tpu_torch.analyzer.cuda_optimizer import CudaSearchConfig
from cruise_control_tpu_torch.bootstrap import _cuda_search_config
from cruise_control_tpu_torch.config.cruise_control_config import (
    DEFAULT_CONFIG_DEF,
    ConfigException,
    CruiseControlConfig,
    resolve_class,
)

from cruise_control_tpu.bootstrap import _tpu_search_config
from cruise_control_tpu.config.cruise_control_config import (
    DEFAULT_CONFIG_DEF as REF_DEF,
    CruiseControlConfig as RefConfig,
)
from torch_bootstrap_cases import DROPPED, PORT, REF, booted, port_key

#: the port's keys whose default differs from the reference's: the device
#: cost estimate assumes the card's HBM3 bandwidth (an H100 SXM's
#: 3 350 GB/s), and the soak replans on cuda
OTHER_DEFAULTS = {
    "telemetry.device.cost.hbm.gbps": 3350.0,
    "sim.soak.engine": "cuda",
}
#: the CudaSearchConfig fields no key reaches: six have none in the
#: reference either, and ``topk_mode``'s key is dropped
UNKEYED = {"auction_dest_cap", "auction_src_cap", "auction_stack_ratio",
           "auction_rounds", "cohort_budget_slack", "step_diagnostics",
           "topk_mode"}
#: the engine keys whose docs say that only their default is accepted
#: until the ROADMAP item that gives them an effect
REWORDED = {"cuda.search.pipeline.depth", "cuda.search.shard.tables",
            "cuda.search.shard.donate"}
#: the engine keys whose docs name the port's own mechanism in place of
#: the reference's
PORT_DOCS = {"cuda.search.profiler.trace.dir": "torch.profiler"}
#: values every validator is probed on
PROBES = (-1, 0, 0.5, 1, 2, 100, 1e9, "auto", "grid", "exact", "corrected",
          "zzz")


def _verdict(validator, name, value):
    try:
        validator(name, value)
    except ValueError:  # either package's ConfigException
        return "refused"
    except TypeError:
        return "type"
    return "ok"


def test_every_reference_key_has_its_counterpart():
    ref, port = REF_DEF.keys(), DEFAULT_CONFIG_DEF.keys()
    assert {port_key(k) for k in ref if k not in DROPPED} == set(port)
    assert len(port) == len(ref) - len(DROPPED)
    for name, rk in ref.items():
        if name in DROPPED:
            continue
        pk = port[port_key(name)]
        want = OTHER_DEFAULTS.get(pk.name, rk.default)
        if isinstance(want, str):
            want = want.replace(f"{REF}.", f"{PORT}.")
        assert (pk.type.value, pk.default, pk.importance.value) == (
            rk.type.value, want, rk.importance.value), name
        assert (pk.validator is None) == (rk.validator is None), name
        if rk.validator is not None:
            assert [_verdict(pk.validator, pk.name, v) for v in PROBES] == [
                _verdict(rk.validator, name, v) for v in PROBES], name
        if name.startswith("tpu.search."):
            assert pk.group == "cuda.engine"
            if pk.name in REWORDED:
                assert "ROADMAP A" in pk.doc, name
            elif pk.name in PORT_DOCS:
                assert PORT_DOCS[pk.name] in pk.doc, name
            else:
                assert pk.doc == rk.doc.replace("tpu.search.",
                                                "cuda.search."), name


def test_defaults_materialize():
    cfg = CruiseControlConfig()
    assert cfg.get_boolean("use.cuda.optimizer") is True
    assert cfg.get_int("cuda.mesh.devices") == 0
    assert cfg.get_int("num.partition.metrics.windows") == 5
    assert cfg.get_boolean("telemetry.host.enabled") is True
    assert len(cfg.get_list("default.goals")) == 15


@pytest.mark.parametrize("key", ["use.tpu.optimizer", "tpu.mesh.devices",
                                 "tpu.search.max.rounds", *DROPPED,
                                 "cuda.search.topk.mode"])
def test_reference_engine_keys_are_unknown(key):
    with pytest.raises(ConfigException, match="unknown config keys"):
        CruiseControlConfig({key: "1"})


def test_cuda_search_config_maps_every_key_to_the_reference_field():
    assert _cuda_search_config(CruiseControlConfig()) == CudaSearchConfig()
    base = dataclasses.asdict(CudaSearchConfig())
    other = {"auto": "grid", "budget": "corrected", "": "trace"}
    reached = {}
    for name, key in DEFAULT_CONFIG_DEF.keys().items():
        if not name.startswith("cuda.search."):
            continue
        d = key.default
        value = (not d if isinstance(d, bool) else other[d]
                 if isinstance(d, str) else d + 1)
        got = dataclasses.asdict(
            _cuda_search_config(CruiseControlConfig({name: value})))
        changed = [f for f in got if got[f] != base[f]]
        assert len(changed) == 1 and got[changed[0]] == value, name
        ref = _tpu_search_config(RefConfig({
            "tpu.search." + name[len("cuda.search."):]: value}))
        assert getattr(ref, changed[0]) == value, name
        reached[name] = changed[0]
    assert len(reached) == 35 and len(set(reached.values())) == 35
    assert set(base) - set(reached.values()) == UNKEYED


def test_reference_class_paths_are_refused():
    path = f"{REF}.monitor.sample_store.NoopSampleStore"
    with pytest.raises(ConfigException, match="JAX package"):
        resolve_class(path)
    cfg = CruiseControlConfig({"sample.store.class": path})
    with pytest.raises(ConfigException, match=f"{PORT}.monitor.sample_store"):
        cfg.get_configured_instance("sample.store.class")
    from cruise_control_tpu_torch.monitor.sample_store import NoopSampleStore

    ok = CruiseControlConfig({"sample.store.class":
                              f"{PORT}.monitor.sample_store.NoopSampleStore"})
    assert isinstance(ok.get_configured_instance("sample.store.class"),
                      NoopSampleStore)
    # goal short-names still resolve through the port's goal registry
    from cruise_control_tpu_torch.analyzer.goals.rack import RackAwareGoal

    assert resolve_class("RackAwareGoal") is RackAwareGoal


def test_config_main_prints_the_cuda_engine_keys():
    out = subprocess.run(
        [sys.executable, "-m", f"{PORT}.config"], capture_output=True,
        text=True, timeout=120, check=True).stdout
    assert "## cuda.engine" in out and "`cuda.search.max.rounds`" in out
    assert "`use.cuda.optimizer`" in out
    assert "tpu.search." not in out and "tpu.engine" not in out
    assert out.count("| `cuda.search.") == 35


def test_boot_from_properties_overriding_each_subsystem(tmp_path):
    """The reference's test on the port: one override per subsystem from a
    properties file, each landing on its built component, the engine's
    through ``cuda.search.*``."""
    from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
    from cruise_control_tpu_torch.bootstrap import load_properties
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType

    props_file = tmp_path / "cc.properties"
    props_file.write_text("\n".join([
        "# one override per subsystem",
        "num.partition.metrics.windows=7",
        "capacity.estimation.percentile=90",
        "cpu.balance.threshold=1.33",
        "max.replicas.per.broker=5000",
        "default.goals=RackAwareGoal,DiskCapacityGoal,ReplicaCapacityGoal",
        "hard.goals=RackAwareGoal",
        "cuda.search.max.rounds=99",
        "cuda.search.time.budget.s=12.5",
        "num.concurrent.partition.movements.per.broker=9",
        "concurrency.adjuster.enabled=true",
        "default.replica.movement.strategies="
        f"{PORT}.executor.tasks.PrioritizeLargeReplicaMovementStrategy,"
        f"{PORT}.executor.tasks.PostponeUrpReplicaMovementStrategy",
        "anomaly.detection.interval.ms=123000",
        "goal.violation.detection.interval.ms=60000",
        "self.healing.enabled=true",
        "self.healing.metric.anomaly.enabled=false",
        "metric.anomaly.percentile.upper.threshold=80",
        "self.healing.goals=RackAwareGoal,DiskCapacityGoal",
        "max.active.user.tasks=3",
        "user.task.executor.threads=2",
        "max.cached.completed.user.tasks=11",
        "webserver.api.urlprefix=/cc",
        "webserver.http.cors.enabled=true",
        "webserver.http.cors.origin=https://ops.example",
        "two.step.purgatory.retention.time.ms=60000",
        "topics.excluded.from.partition.movement=topic_0",
        "simulation.num.brokers=6",
        "simulation.num.partitions=24",
    ]))
    with booted(PORT, load_properties(str(props_file))) as app:
        cc = app.cruise_control
        assert cc.load_monitor.partition_aggregator.num_windows == 7
        assert cc.load_monitor.capacity_estimation_percentile == 90
        assert cc.constraint.balance_threshold[Resource.CPU] == 1.33
        assert cc.constraint.max_replicas_per_broker == 5000
        engine = cc._make_engine("greedy")
        assert {g.name: g.is_hard for g in engine.goals} == {
            "RackAwareGoal": True, "DiskCapacityGoal": False,
            "ReplicaCapacityGoal": False}
        assert cc.default_engine == "cuda" and cc.device == "cpu"
        tc = cc.cuda_config
        assert tc.max_rounds == 99 and tc.time_budget_s == 12.5
        assert cc.engine_degradation is not None
        ec = cc.executor.config
        assert ec.num_concurrent_partition_movements_per_broker == 9
        assert ec.concurrency_adjuster_enabled is True
        assert cc.executor.default_strategy.name == (
            "PrioritizeLargeReplicaMovementStrategy"
            "+PostponeUrpReplicaMovementStrategy")
        dm = app.detector_manager
        assert dm.detection_interval_ms == 123000
        assert dm.per_type_interval_ms[AnomalyType.GOAL_VIOLATION] == 60000
        enabled = dm.notifier.self_healing_enabled()
        assert enabled[AnomalyType.BROKER_FAILURE] is True
        assert enabled[AnomalyType.METRIC_ANOMALY] is False
        assert dm.detectors[AnomalyType.GOAL_VIOLATION].fix_goal_names == [
            "RackAwareGoal", "DiskCapacityGoal"]
        assert dm.detectors[
            AnomalyType.METRIC_ANOMALY].finder.upper_percentile == 80
        assert app.server.tasks.max_active_tasks == 3
        assert app.server.tasks.max_cached_completed == 11
        assert app.server.prefix == "/cc"
        assert app.server.cors_enabled and \
            app.server.cors_origin == "https://ops.example"
        assert app.server.purgatory.retention_s == 60.0
        app.reporter.report(time_ms=500)
        cc.load_monitor.run_sampling_iteration(3_600_000)
        with cc.load_monitor.acquire_for_model_generation():
            state = cc.load_monitor.cluster_model()
        opts = OptimizationOptions()
        cc._resolved_constraint(state, opts)
        assert opts.excluded_topics == {
            i for i, n in enumerate(state.topic_names) if n == "topic_0"}
        assert len(app.backend.alive_brokers()) == 6

"""The port's copies of the reference's jax-free modules stay copies: each
module listed in :data:`COPIES` equals the reference's file once
``cruise_control_tpu.`` reads ``cruise_control_tpu_torch.``.  The modules
the port adapts are listed in :data:`ADAPTED` with the reason each
differs; every served-path module with a reference counterpart is in one
list or the other, so a copy cannot drift unnoticed."""

import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "cruise_control_tpu"
PORT = REPO / "cruise_control_tpu_torch"

#: modules the port keeps as copies (paths inside each package)
COPIES = (
    "analyzer/__init__.py", "analyzer/actions.py", "analyzer/degradation.py",
    "analyzer/goal_optimizer.py", "analyzer/goals/__init__.py",
    "analyzer/goals/capacity.py", "analyzer/goals/distribution.py",
    "analyzer/goals/intrabroker.py", "analyzer/goals/kafka_assigner.py",
    "analyzer/goals/rack.py", "analyzer/precompute.py",
    "analyzer/provision.py", "analyzer/verifier.py",
    "client/__init__.py",
    "common/__init__.py", "common/resources.py",
    "config/__init__.py", "config/__main__.py", "__main__.py",
    "detector/__init__.py", "detector/anomalies.py", "detector/detectors.py",
    "detector/manager.py", "detector/notifier.py",
    "executor/__init__.py", "executor/backend.py",
    "executor/concurrency.py", "executor/executor.py", "executor/journal.py",
    "executor/notifier.py", "executor/tasks.py", "executor/throttle.py",
    "kafka/__init__.py", "kafka/backend.py", "kafka/confluent_wire.py",
    "kafka/envelope.py", "kafka/metadata.py", "kafka/sample_store.py",
    "kafka/sampler.py", "kafka/wire.py",
    "models/__init__.py", "models/builder.py", "models/generators.py",
    "monitor/__init__.py", "monitor/aggregator.py", "monitor/capacity.py",
    "monitor/fetcher.py", "monitor/load_monitor.py",
    "monitor/metric_defs.py", "monitor/prometheus.py",
    "monitor/sample_store.py", "monitor/sampling.py",
    "replan/__init__.py", "replan/delta.py", "replan/planner.py",
    "server/__init__.py", "server/admission.py", "server/progress.py",
    "server/purgatory.py", "server/security.py", "server/user_tasks.py",
    "sim/__init__.py", "sim/artifact.py", "sim/backend.py",
    "sim/fault_schedule.py", "sim/timeline.py", "sim/workload.py",
    "telemetry/__init__.py", "telemetry/critical_path.py",
    "telemetry/events.py", "telemetry/host_profile.py",
    "telemetry/profile.py", "telemetry/recorder.py", "telemetry/slo.py",
    "telemetry/trace.py",
    "utils/checksum.py", "utils/locks.py", "utils/metrics.py",
    "whatif/proactive.py",
)

#: served-path modules the port adapts, and why each differs
ADAPTED = {
    "facade.py": "engine 'cuda' (CudaGoalOptimizer) in place of 'tpu' "
                 "and the default, cuda_config and a device argument, no "
                 "degradation to the CPU on the card, torch broker states, "
                 "a cold replan hands the engine the carry",
    "server/http_server.py": "profile/kernels and profile/mesh answer 503 "
                             "until their observatories are ported "
                             "(ROADMAP A10)",
    "telemetry/tracing.py": "device_span.block synchronizes the card of "
                            "CUDA tensors instead of jax.block_until_ready",
    "telemetry/exposition.py": "renders the registry, span, lock and "
                               "host-profiler families; the device "
                               "families are not ported yet (ROADMAP A10)",
    "client/cccli.py": "--engine offers 'cuda' in place of 'tpu'",
    "config/cruise_control_config.py": "the engine key group is cuda.* "
                                       "(use.cuda.optimizer, "
                                       "cuda.mesh.devices, 35 "
                                       "cuda.search.* keys), the XLA "
                                       "compilation-cache and approximate "
                                       "top-k keys are gone, the docs of "
                                       "four engine keys name the ROADMAP "
                                       "item that gives them an effect, "
                                       "sim.soak.engine defaults to cuda, "
                                       "the four device-telemetry toggles "
                                       "default to false, and a class path "
                                       "into the JAX package is refused",
    "bootstrap.py": "engine 'cuda' with CudaSearchConfig from "
                    "cuda.search.* on a device argument that must exist; "
                    "no XLA cache and no device observatories (A10); "
                    "refuses non-default A4, A10 and A11 keys",
    "server/ui.html": "the engine select offers 'cuda' in place of 'tpu'",
    "sim/simulator.py": "run_scenario takes a device (resolved first, "
                        "handed to the facade); the scripted engine "
                        "failure hits 'cuda'; kernel_capture_scans > 0 "
                        "raises until the kernel observatory is ported "
                        "(ROADMAP A10)",
    "sim/scenarios.py": "engine_failure_degrades_to_greedy runs engine "
                        "'cuda'",
    "sim/soak.py": "run_soak and the CLI take a device; the leak gate "
                   "reads the card's allocator instead of "
                   "jax.live_arrays; the day runs engine 'cuda'; no XLA "
                   "cache",
    "sim/__main__.py": "--device; on the card a scenario listed in ON_CARD "
                       "(the engine-failure ladder, which never degrades "
                       "there) is held to its on-card outcome",
    "whatif/artifact.py": "the batch leg times CudaGoalOptimizer; both "
                          "legs take a device",
    "whatif/__main__.py": "--device for both legs",
}

#: the sub-packages and modules of the served path
SERVED = ("analyzer/degradation.py", "analyzer/precompute.py",
          "analyzer/goal_optimizer.py", "bootstrap.py", "__main__.py",
          "client", "config", "detector", "executor", "facade.py", "kafka",
          "monitor", "replan", "server", "sim", "telemetry",
          "utils/checksum.py", "utils/locks.py", "utils/metrics.py",
          "whatif/proactive.py")


def _as_port(text: str) -> str:
    return text.replace("cruise_control_tpu.", "cruise_control_tpu_torch.")


def test_copies_equal_the_reference():
    drifted = [
        rel for rel in COPIES
        if (PORT / rel).read_text() != _as_port((REF / rel).read_text())
    ]
    assert drifted == []


def test_adapted_modules_differ_from_the_reference():
    for rel, reason in ADAPTED.items():
        assert reason and rel not in COPIES
        port, ref = (PORT / rel).read_text(), (REF / rel).read_text()
        assert port != _as_port(ref), f"{rel} is a copy: list it in COPIES"


def test_every_served_module_is_a_copy_or_adapted():
    served = set()
    for entry in SERVED:
        path = PORT / entry
        files = [path] if path.is_file() else path.rglob("*.py")
        served.update(str(f.relative_to(PORT)) for f in files)
    with_reference = {rel for rel in served if (REF / rel).is_file()}
    assert with_reference - set(COPIES) - set(ADAPTED) == set()

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
    "server/__init__.py", "server/admission.py", "server/http_server.py",
    "server/progress.py",
    "server/purgatory.py", "server/security.py", "server/user_tasks.py",
    "sim/__init__.py", "sim/artifact.py", "sim/backend.py",
    "sim/fault_schedule.py", "sim/timeline.py", "sim/workload.py",
    "telemetry/__init__.py", "telemetry/critical_path.py",
    "telemetry/events.py", "telemetry/host_profile.py",
    "telemetry/profile.py", "telemetry/recorder.py", "telemetry/slo.py",
    "telemetry/trace.py",
    "utils/checksum.py", "utils/locks.py", "utils/metrics.py",
    "whatif/proactive.py",
    "devtools/__init__.py", "devtools/lint/cache.py",
    "devtools/lint/cfg.py", "devtools/lint/context.py",
    "devtools/lint/dataflow.py", "devtools/lint/findings.py",
    "devtools/lint/project.py", "devtools/lint/sarif.py",
    "devtools/lint/rules_bounded.py", "devtools/lint/rules_cache.py",
    "devtools/lint/rules_deadline.py", "devtools/lint/rules_except.py",
    "devtools/lint/rules_fenced.py", "devtools/lint/rules_lock.py",
    "devtools/lint/rules_lockinst.py", "devtools/lint/rules_lockorder.py",
    "devtools/lint/rules_obs.py", "devtools/lint/rules_release.py",
    "devtools/lint/rules_retry.py", "devtools/lint/rules_schema.py",
    "devtools/lint/rules_wallclock.py", "devtools/lint/rules_xlock.py",
)

#: served-path modules the port adapts, and why each differs
ADAPTED = {
    "facade.py": "engine 'cuda' (CudaGoalOptimizer) in place of 'tpu' "
                 "and the default, cuda_config and a device argument, no "
                 "degradation to the CPU on the card, torch broker states, "
                 "a cold replan hands the engine the carry",
    "telemetry/tracing.py": "device_span.block synchronizes the card of "
                            "CUDA tensors instead of jax.block_until_ready",
    "telemetry/exposition.py": "the cc_jit_* families' help texts say what "
                               "the port counts (kernel builds and loads, "
                               "step-chunk captures) and its docstring "
                               "lists the mesh, lock and host families",
    "telemetry/kernel_budget.py": "torch.profiler (Kineto) in place of "
                                  "jax.profiler: CUPTI's kernel records "
                                  "and the CPU's host ops as the two "
                                  "dialects, buckets by csrc stem, bytes "
                                  "and operations from the kernels' work "
                                  "models, the trace started at a scan "
                                  "call's first replay, one session a "
                                  "process, the card's roofline",
    "telemetry/mesh_budget.py": "Kineto's memcpy and memset records and "
                                "NCCL's kernel names, torch transfers in "
                                "the ledger, the audit over live CUDA "
                                "tensors, the ledger window closed at the "
                                "trace's end",
    "telemetry/device_stats.py": "counts kernel builds and loads and "
                                 "step-chunk captures in place of XLA "
                                 "compiles; live buffers from the card's "
                                 "allocator",
    "telemetry/device_cost.py": "an executable's cost from its launches' "
                                "work models and its buffers in place of "
                                "XLA's cost and memory analyses; the "
                                "card's bandwidth",
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
                                       "the device-telemetry keys' docs say "
                                       "what the port measures (and the "
                                       "card's 3 350 GB/s), and a class "
                                       "path into the JAX package is "
                                       "refused",
    "bootstrap.py": "engine 'cuda' with CudaSearchConfig from "
                    "cuda.search.* on a device argument that must exist; "
                    "no XLA cache; "
                    "refuses non-default A4 and A11 keys",
    "server/ui.html": "the engine select offers 'cuda' in place of 'tpu'",
    "sim/simulator.py": "run_scenario takes a device (resolved first, "
                        "handed to the facade); the scripted engine "
                        "failure hits 'cuda'",
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
    "devtools/lint/__init__.py": "its docstring describes the port's pass "
                                 "and usage",
    "devtools/lint/__main__.py": "its usage text: the port's package, "
                                 "docs/STATIC_ANALYSIS_TORCH.md and "
                                 "PORT_LOCK_GRAPH_r*.json",
    "devtools/lint/driver.py": "its own cache directory, "
                               ".cclint_torch_cache/: the reference's pass "
                               "and this one run side by side in the test "
                               "workers",
    "devtools/lint/graph.py": "the torch sync vocabulary it records (.item, "
                              ".tolist, .cpu, .numpy, .synchronize, "
                              "mesh_budget.fetch, also on a computed "
                              "receiver), the captured torch.cuda.graph "
                              "blocks, and the step loop's key tuple as a "
                              "normalization site",
    "devtools/lint/callgraph.py": "a call into the caller's own nested def "
                                  "resolves (the facade's engine call runs "
                                  "in one)",
    "devtools/lint/lockflow.py": "a module-level named lock imported from "
                                 "another module resolves (DEVICE_LOCK), "
                                 "and witness chains reach 16 hops (the "
                                 "step-loop lock sits 13 below the "
                                 "facade's single flight)",
    "devtools/lint/rules_jax.py": "jax-hot-path checks the captured step: "
                                  "torch.cuda.graph blocks and the "
                                  "CAPTURED_ROOTS functions",
    "devtools/lint/rules_xjax.py": "jax-transitive walks from the captured "
                                   "step and keys on the step loop's key",
    "devtools/lint/rules_transfer.py": "torch copies outside ops/, "
                                       "telemetry/ and the two upload sites",
    "devtools/lint/rules_profiler.py": "torch.profiler, autograd and cuda "
                                       "profiler sessions",
    "devtools/lint/rules_sharding.py": "tensor factories without device= in "
                                       "the device modules",
    "devtools/lint/rules_blocking.py": "the device lock is held across "
                                       "syncs by design (HELD_ACROSS_SYNCS)",
    "devtools/lint/rules_config.py": "the port's registry and "
                                     "docs/CONFIGURATION_TORCH.md",
}

#: the sub-packages and modules of the served path, and the lint
SERVED = ("analyzer/degradation.py", "analyzer/precompute.py",
          "analyzer/goal_optimizer.py", "bootstrap.py", "__main__.py",
          "client", "config", "detector", "executor", "facade.py", "kafka",
          "monitor", "replan", "server", "sim", "telemetry",
          "utils/checksum.py", "utils/locks.py", "utils/metrics.py",
          "whatif/proactive.py", "devtools")


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

"""The scripted scenario suite — named fault timelines over the simulator.

Each entry is a :class:`ScenarioSpec` factory (a fresh spec per call — the
Timeline carries a consume cursor), covering the SURVEY §2.8/§3.4 anomaly
matrix end-to-end: broker death (including mid-execution), rack loss,
cascading disk failures, hot-partition skew, cooldown suppression,
maintenance precedence, metric gaps, broker adds, double faults, recovery
then relapse, alert-only metric anomalies, and scripted execution stalls.

``tests/test_scenarios.py`` asserts each scenario's heal outcome by reading
only the event journal; ``python -m cruise_control_tpu_torch.sim`` runs the suite
and emits the ``cc-tpu-scenarios/1`` artifact (``SCENARIOS_r09.json``).

Timing note: the monitor averages loads over its (5 × 1-virtual-minute)
windows, so a load change needs ~3 windows before a capacity detector sees
it breach — timelines below schedule faults early enough for detection,
reaction, and the post-heal quiet period to fit the scenario duration.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from cruise_control_tpu_torch.sim.simulator import MIN_MS, ScenarioSpec
from cruise_control_tpu_torch.sim.timeline import (
    Timeline,
    add_broker,
    perturb_broker_load,
    analyzer_outage,
    corrupt_checkpoint,
    corrupt_metrics,
    crash_process,
    create_topic,
    delete_topic,
    disk_failure,
    fail_engine,
    flap_broker,
    foreign_reassignment,
    hot_partition_skew,
    http_request,
    kill_broker,
    kill_broker_mid_execution,
    maintenance_event,
    metric_gap,
    rack_loss,
    request_storm,
    restart_process,
    restore_analyzer,
    restore_broker,
    restore_disk,
    slow_client,
    stall_execution,
    zombie_controller_resume,
)


def _broker_death_mid_execution() -> ScenarioSpec:
    return ScenarioSpec(
        name="broker_death_mid_execution",
        description=(
            "Hot-partition skew triggers a self-healing rebalance; a "
            "replica-receiving broker dies mid-catch-up — the stuck moves "
            "go DEAD on timeout, then the broker failure is detected and "
            "evacuated."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=6.0, leader=0),
            kill_broker_mid_execution(4 * MIN_MS, after_ticks=2),
        ]),
        self_healing={"goal_violation": True, "broker_failure": True},
        # headroom so the 5-broker cluster stays capacity-feasible after
        # the kill, and slow enough moves that the kill lands mid-catch-up
        mean_utilization=0.18,
        move_latency_ticks=3,
        duration_ms=30 * MIN_MS,
    )


def _rack_loss() -> ScenarioSpec:
    return ScenarioSpec(
        name="rack_loss",
        description=(
            "Every broker in rack 2 dies at once; one BrokerFailures "
            "anomaly covers the whole rack and the fix evacuates onto the "
            "two surviving racks (rf=2 stays rack-legal)."
        ),
        timeline=Timeline([rack_loss(5 * MIN_MS, rack=2)]),
        self_healing={"broker_failure": True},
        duration_ms=24 * MIN_MS,
    )


def _cascading_disk_failures() -> ScenarioSpec:
    return ScenarioSpec(
        name="cascading_disk_failures",
        description=(
            "Broker 1 loses its log dirs, is evacuated, then broker 4 "
            "fails too — two separate DISK_FAILURE heals; operators "
            "replace each disk after its heal."
        ),
        timeline=Timeline([
            disk_failure(4 * MIN_MS, broker=1),
            restore_disk(10 * MIN_MS, broker=1),
            disk_failure(12 * MIN_MS, broker=4),
            restore_disk(20 * MIN_MS, broker=4),
        ]),
        self_healing={"disk_failure": True},
        fix_cooldown_ms=3 * MIN_MS,
        duration_ms=26 * MIN_MS,
    )


def _hot_partition_skew_violation() -> ScenarioSpec:
    return ScenarioSpec(
        name="hot_partition_skew_violation",
        description=(
            "Partitions led by broker 0 go 8x hot; capacity detection "
            "goals breach once the windows catch up and the self-healing "
            "rebalance spreads the hot partitions."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
        ]),
        self_healing={"goal_violation": True},
        # headroom: post-heal the diurnal peak must stay under the
        # capacity threshold, or the tail of the run re-triggers
        mean_utilization=0.18,
        duration_ms=30 * MIN_MS,
    )


def _anomaly_during_cooldown() -> ScenarioSpec:
    return ScenarioSpec(
        name="anomaly_during_cooldown",
        description=(
            "A second disk failure lands inside the self-healing cooldown "
            "window of the first fix — FIX_DELAYED_COOLDOWN, retried and "
            "healed once the cooldown expires."
        ),
        timeline=Timeline([
            disk_failure(4 * MIN_MS, broker=1),
            restore_disk(8 * MIN_MS, broker=1),
            disk_failure(9 * MIN_MS, broker=4),
            restore_disk(20 * MIN_MS, broker=4),
        ]),
        self_healing={"disk_failure": True},
        fix_cooldown_ms=6 * MIN_MS,
        duration_ms=26 * MIN_MS,
    )


def _maintenance_suppresses_self_heal() -> ScenarioSpec:
    return ScenarioSpec(
        name="maintenance_suppresses_self_heal",
        description=(
            "An operator maintenance REBALANCE outranks the goal-violation "
            "self-heal detected in the same cycle (anomaly priority 0 vs "
            "4); the self-heal lands in FIX_DELAYED_COOLDOWN behind the "
            "maintenance fix."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
            maintenance_event(6 * MIN_MS, "REBALANCE"),
        ]),
        self_healing={"goal_violation": True, "maintenance_event": True},
        fix_cooldown_ms=8 * MIN_MS,
        duration_ms=30 * MIN_MS,
    )


def _detection_during_metric_gap() -> ScenarioSpec:
    return ScenarioSpec(
        name="detection_during_metric_gap",
        description=(
            "The metrics pipeline goes dark for 10 virtual minutes; a "
            "hot-partition skew inside the gap stays invisible (models "
            "build from stale windows) and is detected and healed only "
            "after sampling resumes."
        ),
        timeline=Timeline([
            metric_gap(4 * MIN_MS, duration_ms=10 * MIN_MS),
            hot_partition_skew(5 * MIN_MS, factor=8.0, leader=0),
        ]),
        self_healing={"goal_violation": True},
        duration_ms=34 * MIN_MS,
    )


def _add_broker_rebalance() -> ScenarioSpec:
    return ScenarioSpec(
        name="add_broker_rebalance",
        description=(
            "A new empty broker joins; the operator submits a maintenance "
            "ADD_BROKER event and the fix moves replicas onto it through "
            "the facade's add_brokers runnable."
        ),
        timeline=Timeline([
            add_broker(4 * MIN_MS, broker=6, rack=0),
            maintenance_event(6 * MIN_MS, "ADD_BROKER", brokers=[6]),
        ]),
        self_healing={"maintenance_event": True},
        duration_ms=20 * MIN_MS,
    )


def _double_fault() -> ScenarioSpec:
    return ScenarioSpec(
        name="double_fault",
        description=(
            "Broker 5 dies and broker 1 loses its disks in the same "
            "minute; broker failure outranks disk failure (priority 1 vs "
            "2), the disk fix waits out the cooldown, both heal."
        ),
        timeline=Timeline([
            kill_broker(6 * MIN_MS, broker=5),
            disk_failure(6 * MIN_MS, broker=1),
            restore_disk(16 * MIN_MS, broker=1),
        ]),
        self_healing={"broker_failure": True, "disk_failure": True},
        fix_cooldown_ms=4 * MIN_MS,
        duration_ms=26 * MIN_MS,
    )


def _recovery_then_relapse() -> ScenarioSpec:
    return ScenarioSpec(
        name="recovery_then_relapse",
        description=(
            "Broker 3 dies but returns before the self-healing threshold "
            "(CHECK escalation only, first-seen cleared on recovery); it "
            "then dies for good and is healed once the threshold from the "
            "SECOND failure elapses."
        ),
        timeline=Timeline([
            kill_broker(4 * MIN_MS, broker=3),
            restore_broker(8 * MIN_MS, broker=3),
            kill_broker(14 * MIN_MS, broker=3),
        ]),
        self_healing={"broker_failure": True},
        broker_failure_alert_ms=2 * MIN_MS,
        broker_failure_heal_ms=6 * MIN_MS,
        duration_ms=30 * MIN_MS,
    )


def _metric_anomaly_alert_only() -> ScenarioSpec:
    return ScenarioSpec(
        name="metric_anomaly_alert_only",
        description=(
            "Broker 2's traffic spikes 20x against its own history; the "
            "percentile finder flags it but metric anomalies have no safe "
            "automatic fix — alert-only, nothing executes."
        ),
        timeline=Timeline([
            hot_partition_skew(10 * MIN_MS, factor=20.0, leader=2),
        ]),
        self_healing={"metric_anomaly": True},
        diurnal_amplitude=0.05,
        duration_ms=20 * MIN_MS,
    )


def _stalled_execution_retries() -> ScenarioSpec:
    return ScenarioSpec(
        name="stalled_execution_retries",
        description=(
            "The first reassignment batch of the self-healing rebalance "
            "stalls past the task timeout (scripted backend stall) and "
            "goes DEAD; the persisting violation is re-detected and the "
            "retry completes once the stall drains."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
            stall_execution(4 * MIN_MS, ticks=30, batches=1),
        ]),
        self_healing={"goal_violation": True},
        fix_cooldown_ms=2 * MIN_MS,
        mean_utilization=0.18,  # see hot_partition_skew_violation
        duration_ms=30 * MIN_MS,
    )


# ---- crash-safe execution (ISSUE 7): checkpoint/resume + retry chaos -----------
def _crash_resume_mid_execution() -> ScenarioSpec:
    return ScenarioSpec(
        name="crash_resume_mid_execution",
        description=(
            "The control plane crashes mid-rebalance (checkpoint armed); "
            "the restarted process replays the execution checkpoint, "
            "marks the moves that finished as COMPLETED, and resumes the "
            "rest — zero already-completed partitions are re-moved."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=6.0, leader=0),
            crash_process(4 * MIN_MS, after_ticks=6),
            restart_process(16 * MIN_MS),
        ]),
        self_healing={"goal_violation": True},
        checkpoint=True,
        mean_utilization=0.18,
        move_latency_ticks=4,
        executor_moves_per_broker=1,  # multiple batches: some complete
        fix_cooldown_ms=2 * MIN_MS,   # before the crash, some do not
        duration_ms=32 * MIN_MS,
    )


def _crash_completes_while_down() -> ScenarioSpec:
    return ScenarioSpec(
        name="crash_completes_while_down",
        description=(
            "The process crashes right after dispatching; the cluster "
            "finishes every in-flight move while the controller is down. "
            "Recovery reconciles checkpoint vs live state, marks all "
            "moves COMPLETED-while-down, and resumes without issuing a "
            "single new replica batch."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=6.0, leader=0),
            crash_process(4 * MIN_MS, after_ticks=2),
            restart_process(18 * MIN_MS),
        ]),
        self_healing={"goal_violation": True},
        checkpoint=True,
        mean_utilization=0.18,
        move_latency_ticks=6,
        fix_cooldown_ms=2 * MIN_MS,
        duration_ms=32 * MIN_MS,
    )


def _crash_recovery_replans_dead_destination() -> ScenarioSpec:
    return ScenarioSpec(
        name="crash_recovery_replans_dead_destination",
        description=(
            "Crash mid-execution, then a replica-receiving broker dies "
            "while the controller is down: recovery finds the vanished "
            "destination, re-plans those moves onto live brokers, resumes "
            "the rest, and the broker-failure heal evacuates the corpse."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=6.0, leader=0),
            crash_process(4 * MIN_MS, after_ticks=2),
            kill_broker_mid_execution(4 * MIN_MS, after_ticks=4),
            restart_process(17 * MIN_MS),
        ]),
        self_healing={"goal_violation": True, "broker_failure": True},
        checkpoint=True,
        mean_utilization=0.15,
        move_latency_ticks=10,  # in-flight at restart: the dead dest matters
        fix_cooldown_ms=2 * MIN_MS,
        broker_failure_heal_ms=4 * MIN_MS,
        duration_ms=40 * MIN_MS,
    )


def _flapping_destination_retries() -> ScenarioSpec:
    return ScenarioSpec(
        name="flapping_destination_retries",
        description=(
            "A replica-receiving broker flaps (dies/recovers twice) "
            "during the self-healing rebalance: moves onto it time out, "
            "the executor retries them with exponential backoff, and the "
            "execution completes with zero dead tasks once the broker "
            "stays up."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
            flap_broker(4 * MIN_MS, down_ticks=8, up_ticks=6, cycles=2),
        ]),
        self_healing={"goal_violation": True},
        task_retry_attempts=4,
        task_retry_backoff_base_ticks=2,
        task_retry_backoff_max_ticks=16,
        executor_task_timeout_ticks=5,
        move_latency_ticks=2,
        mean_utilization=0.18,
        fix_cooldown_ms=2 * MIN_MS,
        duration_ms=30 * MIN_MS,
    )


# ---- overload-safe serving (ISSUE 8): chaos on the front door -------------------
def _degraded_serving_survives_analyzer_outage() -> ScenarioSpec:
    return ScenarioSpec(
        name="degraded_serving_survives_analyzer_outage",
        description=(
            "The analyzer starts failing every optimization; after two "
            "failed precompute passes the circuit breaker opens and "
            "GET /proposals degrades to the last-good cached plan with an "
            "explicit stale=true marker (no 5xx).  Once the analyzer "
            "recovers, the half-open probe closes the breaker and fresh "
            "serving resumes."
        ),
        timeline=Timeline([
            http_request(5 * MIN_MS, "proposals"),
            analyzer_outage(6 * MIN_MS),
            http_request(9 * MIN_MS, "proposals"),
            http_request(11 * MIN_MS, "proposals"),
            restore_analyzer(12 * MIN_MS),
            http_request(13 * MIN_MS, "proposals"),
            http_request(14 * MIN_MS, "health"),
        ]),
        serve_http=True,
        precompute_interval_ticks=2,
        breaker_failures=2,
        breaker_reset_ms=4 * MIN_MS,
        duration_ms=16 * MIN_MS,
    )


def _request_storm_sheds_with_retry_after() -> ScenarioSpec:
    return ScenarioSpec(
        name="request_storm_sheds_with_retry_after",
        description=(
            "16 concurrent GET /proposals clients hit a front door sized "
            "for 2 (queue 0), then 8 concurrent POST /rebalance clients "
            "hit a compute class sized for 1: the overflow is shed with "
            "429 + Retry-After, the admitted requests complete, and "
            "nothing 5xxes — load becomes backpressure, not collapse."
        ),
        timeline=Timeline([
            request_storm(6 * MIN_MS, n=16, endpoint="proposals"),
            request_storm(8 * MIN_MS, n=8, endpoint="rebalance",
                          method="POST", params={"dryrun": "true"}),
            http_request(10 * MIN_MS, "health"),
        ]),
        serve_http=True,
        precompute_interval_ticks=2,
        http_get_concurrent=2,
        http_compute_concurrent=1,
        http_queue_size=0,
        duration_ms=12 * MIN_MS,
    )


def _slow_loris_connection_reaped() -> ScenarioSpec:
    return ScenarioSpec(
        name="slow_loris_connection_reaped",
        description=(
            "A slow-loris client opens a connection and trickles a "
            "partial request forever: the per-connection read timeout "
            "reaps it (thread freed) and a normal request issued right "
            "after is served untouched."
        ),
        timeline=Timeline([
            slow_client(5 * MIN_MS, hold_s=2.0),
            http_request(5 * MIN_MS, "state"),
            http_request(6 * MIN_MS, "health"),
        ]),
        serve_http=True,
        http_read_timeout_ms=500,
        duration_ms=8 * MIN_MS,
    )


def _crash_mid_request_recovers_front_door() -> ScenarioSpec:
    return ScenarioSpec(
        name="crash_mid_request_recovers_front_door",
        description=(
            "An operator's POST /rebalance (dryrun=false) is mid-"
            "execution when the process crashes (checkpoint armed): the "
            "client gets an explicit 500, the front door goes dark "
            "(health unreachable) while the cluster finishes in-flight "
            "moves, and the restarted process resumes the checkpoint and "
            "reports ready again."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=6.0, leader=0),
            crash_process(5 * MIN_MS, after_ticks=4),
            http_request(6 * MIN_MS, "rebalance", method="POST",
                         params={"dryrun": "false"}),
            http_request(8 * MIN_MS, "health"),
            restart_process(16 * MIN_MS),
            http_request(18 * MIN_MS, "health"),
        ]),
        serve_http=True,
        checkpoint=True,
        mean_utilization=0.18,
        move_latency_ticks=4,
        executor_moves_per_broker=1,
        duration_ms=24 * MIN_MS,
    )


# ---- incremental re-optimization (delta replan) ---------------------------------
def _warm_replan_after_drift() -> ScenarioSpec:
    return ScenarioSpec(
        name="warm_replan_after_drift",
        description=(
            "Steady state with the precompute daemon and the delta "
            "replanner on: one broker's partitions drift 5x hot, the next "
            "window roll bumps the model generation, and the refresh "
            "WARM-STARTS from the previous plan (delta model, dirty "
            "partitions marked, partial verify) instead of cold "
            "recomputing; the capacity violation is then detected and "
            "healed.  The journal alone proves the warm path ran."
        ),
        timeline=Timeline([
            perturb_broker_load(6 * MIN_MS, broker=0, factor=5.0),
        ]),
        self_healing={"goal_violation": True},
        # flat synthesized load: between faults the windows are
        # bit-stable, so pre-drift refreshes are warm with ZERO dirty
        # partitions — the steady-state contract the subsystem targets
        diurnal_amplitude=0.0,
        precompute_interval_ticks=2,
        replan_enabled=True,
        # the healing rebalance moves ~half the partitions; the budget
        # must cover that topology delta or the post-heal refresh (not
        # the drift refresh) cold-starts
        replan_budget_ratio=0.8,
        mean_utilization=0.18,
        duration_ms=24 * MIN_MS,
    )


def _slo_observatory() -> ScenarioSpec:
    return ScenarioSpec(
        name="slo_observatory",
        description=(
            "The SLO observatory's gating scenario (ISSUE 11): steady "
            "HTTP proposal serving over the warm replan loop, one "
            "scripted drift fault detected and healed mid-run — the "
            "journal alone yields the cc-tpu-slo/1 gate table (heal "
            "latency p50/p99, cached-GET and compute serve p99, warm "
            "duty cycle, zero unhandled 5xx, shed fairness, bounded "
            "journal growth), the shape ROADMAP item 5's soak consumes."
        ),
        timeline=Timeline([
            # warm the proposal cache, then poll it through the fault
            http_request(3 * MIN_MS, "proposals"),
            http_request(5 * MIN_MS, "proposals"),
            perturb_broker_load(7 * MIN_MS, broker=0, factor=5.0),
            http_request(12 * MIN_MS, "proposals"),
            http_request(18 * MIN_MS, "proposals"),
            http_request(22 * MIN_MS, "proposals"),
            http_request(26 * MIN_MS, "state"),
        ]),
        self_healing={"goal_violation": True},
        diurnal_amplitude=0.0,
        serve_http=True,
        precompute_interval_ticks=2,
        replan_enabled=True,
        replan_budget_ratio=0.8,
        mean_utilization=0.18,
        duration_ms=28 * MIN_MS,
    )


def _warm_replan_after_add_broker() -> ScenarioSpec:
    return ScenarioSpec(
        name="warm_replan_after_add_broker",
        description=(
            "A new empty broker joins (prefix-compatible broker-axis "
            "growth): the next refresh still runs the DELTA path — the "
            "model is patched, not rebuilt, and the search warm-starts "
            "from the previous plan with the new broker as a fresh "
            "destination; the operator's ADD_BROKER maintenance event "
            "then moves replicas onto it."
        ),
        timeline=Timeline([
            add_broker(6 * MIN_MS, broker=6, rack=0),
            maintenance_event(10 * MIN_MS, "ADD_BROKER", brokers=[6]),
        ]),
        self_healing={"maintenance_event": True},
        diurnal_amplitude=0.0,
        precompute_interval_ticks=2,
        replan_enabled=True,
        duration_ms=20 * MIN_MS,
    )


# ---- data-integrity hardening (ISSUE 13): byzantine inputs ----------------------
def _poisoned_metrics_quarantined_then_healed() -> ScenarioSpec:
    return ScenarioSpec(
        name="poisoned_metrics_quarantined_then_healed",
        description=(
            "Broker 1's metrics reporter goes byzantine for six minutes "
            "(NaN broker CPU every interval, plus records for a broker "
            "metadata has never seen) while a REAL hot-partition skew "
            "develops on broker 0: the monitor quarantines every "
            "poisoned sample (journaled, counted per reason, zero NaN "
            "reaches the aggregate tensors), the persistent badness "
            "surfaces as an alert-only quarantine-storm metric anomaly, "
            "and once the poison clears and windows refill, the skew is "
            "detected and healed on clean data — garbage never moved a "
            "replica."
        ),
        timeline=Timeline([
            corrupt_metrics(4 * MIN_MS, broker=1, duration_ms=6 * MIN_MS),
            hot_partition_skew(5 * MIN_MS, factor=8.0, leader=0),
        ]),
        self_healing={"goal_violation": True, "metric_anomaly": True},
        mean_utilization=0.18,
        duration_ms=30 * MIN_MS,
    )


def _checkpoint_bitflip_recovers_loudly() -> ScenarioSpec:
    return ScenarioSpec(
        name="checkpoint_bitflip_recovers_loudly",
        description=(
            "The control plane crashes mid-rebalance; while it is down, "
            "one byte of the durable execution checkpoint is flipped "
            "MID-FILE (the record still parses as JSON — the exact "
            "corruption resume reconciliation used to trust verbatim). "
            "The restarted process's recovery detects the damage via the "
            "per-record CRC, journals executor.checkpoint_corrupt, "
            "treats the checkpoint as absent after the last good record, "
            "and reconciles the rest from live cluster state — loudly "
            "recovered, never silently wrong."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=6.0, leader=0),
            crash_process(4 * MIN_MS, after_ticks=6),
            corrupt_checkpoint(12 * MIN_MS, line=1),
            restart_process(16 * MIN_MS),
        ]),
        self_healing={"goal_violation": True},
        checkpoint=True,
        mean_utilization=0.18,
        move_latency_ticks=4,
        executor_moves_per_broker=1,
        fix_cooldown_ms=2 * MIN_MS,
        duration_ms=32 * MIN_MS,
    )


def _engine_failure_degrades_to_greedy() -> ScenarioSpec:
    return ScenarioSpec(
        name="engine_failure_degrades_to_greedy",
        description=(
            "The facade runs the TPU engine; a scripted cold engine "
            "failure (XLA OOM stand-in) starts before a hot-partition "
            "skew breaches.  The self-healing rebalance's TPU attempt "
            "fails, the degradation ladder journals "
            "analyzer.engine_degraded and serves the heal on the greedy "
            "engine, and every operation inside the cooldown goes "
            "straight to greedy — the fault is contained to one journal "
            "line, not a failed heal."
        ),
        timeline=Timeline([
            fail_engine(3 * MIN_MS),
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
        ]),
        self_healing={"goal_violation": True},
        engine="cuda",
        # the cooldown outlives the scenario: no recovery probe ever
        # touches the (real) TPU engine mid-run
        engine_degraded_cooldown_ms=60 * MIN_MS,
        mean_utilization=0.18,
        duration_ms=30 * MIN_MS,
    )


# ---- concurrent-controller safety (ISSUE 15) ------------------------------------
def _foreign_reassignment_tolerated() -> ScenarioSpec:
    return ScenarioSpec(
        name="foreign_reassignment_tolerated",
        description=(
            "While the self-healing rebalance is mid-flight, a foreign "
            "writer (a raw kafka-reassign-partitions run) moves a "
            "partition the plan does not touch.  The executor journals "
            "the disjoint foreign activity once, feeds its catch-up "
            "traffic to the concurrency machinery as external URPs, and "
            "completes every planned move untouched — tolerated, never "
            "fought."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
            foreign_reassignment(4 * MIN_MS, conflict=False, after_ticks=2),
        ]),
        self_healing={"goal_violation": True},
        mean_utilization=0.18,
        move_latency_ticks=3,
        fix_cooldown_ms=2 * MIN_MS,
        duration_ms=30 * MIN_MS,
    )


def _foreign_conflict_yield_retries() -> ScenarioSpec:
    return ScenarioSpec(
        name="foreign_conflict_yield_retries",
        description=(
            "A foreign writer re-targets one of the execution's own "
            "in-flight moves.  Under execution.foreign.conflict.policy="
            "yield the executor steps aside — the hijacked task retries "
            "with backoff (journaled foreign-conflict) once the foreign "
            "move drains — and the plan still converges to its planned "
            "placement with zero dead tasks and zero double-applied "
            "moves."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
            foreign_reassignment(4 * MIN_MS, conflict=True, after_ticks=1),
        ]),
        self_healing={"goal_violation": True},
        task_retry_attempts=3,
        task_retry_backoff_base_ticks=2,
        task_retry_backoff_max_ticks=8,
        mean_utilization=0.18,
        move_latency_ticks=3,
        fix_cooldown_ms=2 * MIN_MS,
        duration_ms=30 * MIN_MS,
    )


def _zombie_controller_fenced() -> ScenarioSpec:
    return ScenarioSpec(
        name="zombie_controller_fenced",
        description=(
            "The control plane crashes mid-rebalance; a restarted "
            "process resumes the checkpoint (conditionally claiming the "
            "next controller epoch).  Later the DEAD process's stale "
            "incarnation thaws and tries to resume the same checkpoint — "
            "its compare-and-swap epoch claim is refused before it "
            "mutates anything (executor.fenced journaled) and the live "
            "controller's execution stands: zero double-applied moves."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=6.0, leader=0),
            crash_process(4 * MIN_MS, after_ticks=6),
            restart_process(16 * MIN_MS),
            zombie_controller_resume(20 * MIN_MS),
        ]),
        self_healing={"goal_violation": True},
        checkpoint=True,
        mean_utilization=0.18,
        move_latency_ticks=4,
        executor_moves_per_broker=1,
        fix_cooldown_ms=2 * MIN_MS,
        duration_ms=32 * MIN_MS,
    )


def _topology_drift_mid_execution() -> ScenarioSpec:
    return ScenarioSpec(
        name="topology_drift_mid_execution",
        description=(
            "A whole topic is deleted two ticks into the self-healing "
            "rebalance and a new topic appears minutes later.  Tasks "
            "touching the vanished partitions cancel with the "
            "categorical topology-drift:deleted reason (never burning "
            "the retry/backoff budget as replica-mismatch), the plan "
            "completes partial-gracefully with the drift tallied in "
            "executor.end, and the monitor absorbs both the shrink and "
            "the growth without a failed detection."
        ),
        timeline=Timeline([
            hot_partition_skew(4 * MIN_MS, factor=8.0, leader=0),
            delete_topic(4 * MIN_MS, "topic_2", after_ticks=2),
            create_topic(14 * MIN_MS, "topic_new", partitions=4,
                         replication_factor=2),
        ]),
        self_healing={"goal_violation": True},
        task_retry_attempts=2,
        mean_utilization=0.18,
        move_latency_ticks=3,
        executor_moves_per_broker=1,
        fix_cooldown_ms=2 * MIN_MS,
        duration_ms=32 * MIN_MS,
    )


def _proactive_beats_reactive_peak() -> ScenarioSpec:
    return ScenarioSpec(
        name="proactive_beats_reactive_peak",
        description=(
            "A skewed broker rides a strong diurnal swell toward a "
            "capacity breach at the projected peak.  The proactive "
            "scheduler fits the diurnal curve to observed ingress, the "
            "what-if verdict on the projected-peak future flags the "
            "overload while current load is still legal, and the "
            "forecast-driven rebalance spreads the skew BEFORE the peak "
            "— the detector never sees a violation (outcome NO_ANOMALY; "
            "the reactive twin with proactive off heals the same swell "
            "only after it breaches)."
        ),
        timeline=Timeline([
            hot_partition_skew(1 * MIN_MS, factor=2.8, leader=0),
        ]),
        self_healing={"goal_violation": True},
        proactive_enabled=True,
        proactive_horizon_ms=120 * MIN_MS,
        proactive_threshold=1.1,
        proactive_cooldown_ms=60 * MIN_MS,
        proactive_min_samples=8,
        diurnal_amplitude=0.6,
        diurnal_period_ms=240 * MIN_MS,
        mean_utilization=0.25,
        fix_cooldown_ms=2 * MIN_MS,
        # the swell alone moves every broker's own-history percentile;
        # only a genuine capacity breach should reach the journal
        metric_anomaly_margin=4.0,
        duration_ms=75 * MIN_MS,
    )


#: name → spec factory; a fresh ScenarioSpec per call
SCENARIOS: Dict[str, Callable[[], ScenarioSpec]] = {
    factory().name: factory
    for factory in (
        _broker_death_mid_execution,
        _rack_loss,
        _cascading_disk_failures,
        _hot_partition_skew_violation,
        _anomaly_during_cooldown,
        _maintenance_suppresses_self_heal,
        _detection_during_metric_gap,
        _add_broker_rebalance,
        _double_fault,
        _recovery_then_relapse,
        _metric_anomaly_alert_only,
        _stalled_execution_retries,
        _crash_resume_mid_execution,
        _crash_completes_while_down,
        _crash_recovery_replans_dead_destination,
        _flapping_destination_retries,
        _degraded_serving_survives_analyzer_outage,
        _request_storm_sheds_with_retry_after,
        _slow_loris_connection_reaped,
        _crash_mid_request_recovers_front_door,
        _warm_replan_after_drift,
        _warm_replan_after_add_broker,
        _slo_observatory,
        _poisoned_metrics_quarantined_then_healed,
        _checkpoint_bitflip_recovers_loudly,
        _engine_failure_degrades_to_greedy,
        _foreign_reassignment_tolerated,
        _foreign_conflict_yield_retries,
        _zombie_controller_fenced,
        _topology_drift_mid_execution,
        _proactive_beats_reactive_peak,
    )
}

#: the tier-1 smoke subset (runs under ``-m 'not slow'``); the full matrix
#: is marked slow and exercised by the CLI artifact run.
#: crash_resume_mid_execution rides in tier-1 so the crash-resume journal
#: fingerprint is re-verified bit-for-bit on every run (ISSUE 7);
#: degraded_serving_survives_analyzer_outage does the same for the
#: serving layer (ISSUE 8) — its requests are sequential, so the journal
#: is bit-reproducible (storms are not, and stay out of smoke).
#: warm_replan_after_drift rides in tier-1 so the delta-replan journal
#: (warm refreshes before AND after the drift, zero cold recomputes in
#: the steady state) is re-verified bit-for-bit on every run (ISSUE 9).
#: slo_observatory rides in tier-1 so the cc-tpu-slo/1 gate table stays
#: derivable (all green) from one scenario's journal on every run
#: (ISSUE 11; its sequential requests keep the journal bit-reproducible,
#: deterministic sim-trace-N ids included).
#: poisoned_metrics_quarantined_then_healed rides in tier-1 so the
#: byzantine-input story (quarantine → storm finding → clean heal) is
#: re-verified bit-for-bit on every run (ISSUE 13; no RNG, sequential
#: journal, deterministic poison windows).
#: foreign_conflict_yield_retries and zombie_controller_fenced ride in
#: tier-1 so the concurrent-controller story (conflict yield/retry
#: convergence; stale-epoch zombie refusal with the live controller's
#: execution standing) is re-verified bit-for-bit on every run (ISSUE 15;
#: no RNG — armed events fire on deterministic tick counts).
#: proactive_beats_reactive_peak rides in tier-1 so the forecast-driven
#: control story (diurnal fit → projected-peak what-if verdict →
#: pre-peak rebalance, detector silent throughout) is re-verified
#: bit-for-bit on every run (ISSUE 16; closed-form lstsq fit + one
#: batched dispatch — no RNG, no wall clock).
SMOKE_SCENARIOS = ("rack_loss", "cascading_disk_failures",
                   "crash_resume_mid_execution",
                   "degraded_serving_survives_analyzer_outage",
                   "warm_replan_after_drift", "slo_observatory",
                   "poisoned_metrics_quarantined_then_healed",
                   "foreign_conflict_yield_retries",
                   "zombie_controller_fenced",
                   "proactive_beats_reactive_peak")


def make_scenario(name: str, seed: Optional[int] = None) -> ScenarioSpec:
    """Fresh spec for a registered scenario, optionally re-seeded."""
    spec = SCENARIOS[name]()
    if seed is not None:
        spec.seed = seed
    return spec

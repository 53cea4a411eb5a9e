"""CruiseControl facade — one method per operation (upstream
``KafkaCruiseControl.java``; SURVEY.md §2.7, L4 in the layer map).

Wires LoadMonitor (L2) + optimizer engines (L3b) + Executor (L3c) behind the
operation vocabulary the REST layer (L5) and the anomaly detector (L6) both
drive: ``rebalance``, ``add_brokers``, ``remove_brokers``, ``demote_brokers``,
``fix_offline_replicas``, ``get_proposals``, ``state``.  Sanity checks
(ongoing execution, completeness) happen here, once, so every caller gets the
same guarantees.

Engine-agnostic by construction: both the greedy baseline
(:class:`GoalOptimizer`) and the CUDA search (:class:`CudaGoalOptimizer`,
engine ``"cuda"``) produce the same ``OptimizerResult`` contract, selected
per-call via ``engine=`` or per-instance via config ``analyzer.engine``;
the default is ``"cuda"``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # wiring-time imports only (bootstrap builds both)
    from cruise_control_tpu_torch.analyzer.degradation import EngineDegradation
    from cruise_control_tpu_torch.analyzer.precompute import CircuitBreaker
    from cruise_control_tpu_torch.replan.planner import DeltaReplanner

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import BrokerState
from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
from cruise_control_tpu_torch.analyzer.degradation import (
    PlanSanityError,
    plan_sanity_reason,
)
from cruise_control_tpu_torch.analyzer.precompute import (
    AnalyzerSaturatedError,
    CachedPlan,
)
from cruise_control_tpu_torch.analyzer.goal_optimizer import (
    ExecutionProposal,
    GoalOptimizer,
    OptimizerResult,
    make_goals,
)
from cruise_control_tpu_torch.analyzer.goals.base import BalancingConstraint
from cruise_control_tpu_torch.analyzer.cuda_optimizer import CudaGoalOptimizer
from cruise_control_tpu_torch.executor.backend import StaleControllerEpochError
from cruise_control_tpu_torch.executor.executor import (
    Executor,
    OngoingExecutionError,
)
from cruise_control_tpu_torch.executor.tasks import ReplicaMovementStrategy
from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor,
    ModelCompletenessRequirements,
)
from cruise_control_tpu_torch.server import admission
from cruise_control_tpu_torch.server.progress import OperationProgress
from cruise_control_tpu_torch.telemetry import events, tracing
from cruise_control_tpu_torch.utils.locks import InstrumentedLock
from cruise_control_tpu_torch.utils.logging import get_logger
from cruise_control_tpu_torch.utils.metrics import DEFAULT_REGISTRY, MetricRegistry
from cruise_control_tpu_torch.whatif.cache import WhatifCache

LOG = get_logger("facade")


@dataclasses.dataclass
class WhatifResult:
    """Per-future verdicts from one ``whatif()`` call (the ``POST
    /whatif`` response body via ``to_json``)."""

    verdicts: List[dict]
    generation: str
    batch_size: int
    cached: bool

    def to_json(self) -> dict:
        return {
            "verdicts": self.verdicts,
            "generation": self.generation,
            "numFutures": len(self.verdicts),
            "batchSize": self.batch_size,
            "cached": self.cached,
        }


@dataclasses.dataclass
class TopicConfigurationResult:
    """Result of a replication-factor change (placements chosen by the
    hard-goal acceptance chain — see fix_topic_replication_factor)."""

    proposals: list
    execution: Optional[object] = None

    def summary(self) -> dict:
        return {
            "numProposals": len(self.proposals),
            "executed": self.execution is not None,
        }


class CruiseControl:
    """The facade.  One instance per managed cluster."""

    def __init__(
        self,
        load_monitor: LoadMonitor,
        executor: Executor,
        constraint: Optional[BalancingConstraint] = None,
        engine: str = "cuda",
        mesh=None,
        proposal_ttl_s: float = 300.0,
        registry: Optional[MetricRegistry] = None,
        cuda_config=None,
        device="cuda",
        excluded_topics_regex: str = "",
        min_leaders_topics_regex: str = "",
        allowed_goals: Optional[Sequence[str]] = None,
        default_goal_names: Optional[Sequence[str]] = None,
        hard_goal_names: Optional[Sequence[str]] = None,
        breaker: Optional["CircuitBreaker"] = None,
        replanner: Optional["DeltaReplanner"] = None,
        replan_heals: bool = False,
        engine_degradation: Optional["EngineDegradation"] = None,
        whatif_cache_entries: int = 256,
        whatif_precompute_futures: int = 0,
        whatif_max_futures: int = 256,
    ):
        self.load_monitor = load_monitor
        self.executor = executor
        self.registry = registry or DEFAULT_REGISTRY
        self.constraint = constraint or BalancingConstraint()
        self.default_engine = engine
        self.mesh = mesh
        #: CudaSearchConfig for the cuda engine (None = engine defaults)
        self.cuda_config = cuda_config
        #: the card the cuda engine and the what-if engine run on ("cpu"
        #: runs both on their kernels' plain twins, as the tests do)
        self.device = device
        #: topics.excluded.from.partition.movement: name regex resolved
        #: against each built model's topic names
        self.excluded_topics_regex = excluded_topics_regex
        #: topics.with.min.leaders.per.broker (resolved per model into the
        #: constraint's topic-id set)
        self.min_leaders_topics_regex = min_leaders_topics_regex
        #: `goals` config key: goal names REST requests may use (None = all)
        self.allowed_goals = set(allowed_goals) if allowed_goals else None
        #: default.goals / hard.goals config: the greedy engine's default
        #: stack and the hardness override (the cuda engine fuses the full
        #: stack; its hard set is intrinsic)
        self.default_goal_names = (
            list(default_goal_names) if default_goal_names else None
        )
        self.hard_goal_names = (
            list(hard_goal_names) if hard_goal_names else None
        )
        #: brokerset.config.file entries arrive keyed by topic NAME (ids are
        #: assigned per model build); split them out for per-model resolution.
        #: The id-keyed remainder is the static part — _apply_topic_regexes
        #: rebuilds broker_sets from it each model so entries resolved
        #: against an older build's topic-id mapping never go stale.
        self._broker_sets_by_name = {
            k: v for k, v in self.constraint.broker_sets.items()
            if isinstance(k, str)
        }
        self._broker_sets_static = {
            k: v for k, v in self.constraint.broker_sets.items()
            if not isinstance(k, str)
        }
        # keep the caller-supplied constraint intact (it may be shared);
        # this instance works on a copy holding only the static part
        self.constraint = dataclasses.replace(
            self.constraint, broker_sets=dict(self._broker_sets_static)
        )
        self.anomaly_detector = None  # attached by AnomalyDetectorManager
        self.proposal_precomputer = None  # started on demand (§3.5)
        #: analyzer circuit breaker (precompute.CircuitBreaker); None =
        #: disabled.  Bootstrap wires it from proposals.precompute.breaker.*
        self.breaker = breaker
        #: delta replanner (replan.DeltaReplanner); None = every proposal
        #: computation cold-starts.  Bootstrap wires it from replan.*
        self.replanner = replanner
        #: replan.heal.enabled: full-stack self-healing rebalances (the
        #: detector's goal-violation fixes) ALSO route through the
        #: replanner and warm-start from the previous plan — the
        #: steady-state control loop ROADMAP item 4 closes.  Off keeps the
        #: historical cold heal path.
        self.replan_heals = bool(replan_heals)
        #: engine degradation ladder (analyzer/degradation.py); None =
        #: cold cuda failures surface to the caller as before.  Bootstrap
        #: wires it whenever the cuda engine is the default.  On the card
        #: it never degrades: a cuda failure there surfaces (_on_card)
        self.engine_degradation = engine_degradation
        self._start_time = time.time()
        # cached proposals (upstream GoalOptimizer proposal precompute, §3.5)
        self._proposal_ttl_s = proposal_ttl_s
        self._cached_proposals: Optional[OptimizerResult] = None
        self._cached_at: float = 0.0
        self._cache_lock = InstrumentedLock("proposal.cache")
        #: the warm plan degraded-mode serving falls back on: survives
        #: invalidation (marked stale, not dropped) so an overloaded or
        #: window-starved server still has a last-good answer
        self._last_good: Optional[CachedPlan] = None
        #: single-flight guard: one proposal computation at a time — a
        #: GET /proposals stampede on a cold cache must not fan out into
        #: N identical optimizations
        self._compute_lock = InstrumentedLock("proposal.single_flight")
        # counterfactual what-if engine (ISSUE 16): per-future verdicts
        # keyed model_generation × fingerprint, invalidated with the warm
        # plan; whatif.precompute.futures > 0 keeps the top-k likely
        # futures warm through the precompute daemon
        self._whatif_cache = WhatifCache(whatif_cache_entries)
        self.whatif_precompute_futures = max(
            0, int(whatif_precompute_futures)
        )
        self.whatif_max_futures = max(1, int(whatif_max_futures))

    # ---- engine selection -------------------------------------------------------
    def _make_engine(self, engine: Optional[str], constraint=None):
        name = engine or self.default_engine
        constraint = constraint or self.constraint
        if name == "cuda":
            config = self.cuda_config
            # the request deadline clips the engine's anytime budget: an
            # abandoned POST /rebalance stops burning analyzer time at its
            # deadline instead of running the search to convergence.
            # time_budget_s is a host-loop knob normalized out of the
            # compile-cache key, so per-request budgets never recompile.
            rem = admission.remaining_s()
            if rem is not None:
                from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
                    CudaSearchConfig,
                )

                base = config or CudaSearchConfig()
                budget = max(0.05, rem * 0.9)  # headroom for fetch+finalize
                if base.time_budget_s:
                    budget = min(budget, base.time_budget_s)
                config = dataclasses.replace(base, time_budget_s=budget)
            return CudaGoalOptimizer(
                constraint=constraint, mesh=self.mesh,
                config=config, device=self.device,
            )
        if name == "greedy":
            return GoalOptimizer(
                goals=make_goals(
                    self.default_goal_names, constraint,
                    hard_names=self.hard_goal_names,
                ),
                constraint=constraint,
            )
        raise ValueError(f"unknown analyzer engine {name!r}")

    def _resolved_constraint(self, state, options: OptimizationOptions):
        """Resolve name-regex-scoped config against the built model's topic
        names (ids are assigned per build): default topic exclusions go into
        ``options``; topic-id-scoped constraint fields
        (MinTopicLeadersPerBrokerGoal topics, broker sets) land on a COPY of
        the shared constraint, so concurrent operations — each resolving
        against its own model — never mutate each other's goal inputs."""
        import re

        names = state.topic_names
        if self.excluded_topics_regex and names:
            pat = re.compile(self.excluded_topics_regex)
            options.excluded_topics.update(
                i for i, n in enumerate(names) if pat.fullmatch(n)
            )
        needs_copy = bool(
            names and (self.min_leaders_topics_regex
                       or self._broker_sets_by_name)
        )
        if not needs_copy:
            return self.constraint
        constraint = dataclasses.replace(self.constraint)
        if self.min_leaders_topics_regex:
            pat = re.compile(self.min_leaders_topics_regex)
            constraint.min_topic_leaders_topics = {
                i for i, n in enumerate(names) if pat.fullmatch(n)
            }
        if self._broker_sets_by_name:
            resolved = dict(self._broker_sets_static)
            name_to_id = {n: i for i, n in enumerate(names)}
            for name, brokers in self._broker_sets_by_name.items():
                if name in name_to_id:
                    resolved[name_to_id[name]] = brokers
            constraint.broker_sets = resolved
        return constraint

    # ---- model plumbing ---------------------------------------------------------
    def _model(
        self,
        requirements: Optional[ModelCompletenessRequirements],
        progress: OperationProgress,
        builder=None,
    ) -> ClusterState:
        with tracing.span("facade.model"):
            with progress.step("Acquiring model-generation semaphore"):
                # the semaphore wait honors the request deadline: a queued
                # request whose client gave up must not keep holding a
                # thread against the model lock
                rem = admission.remaining_s()
                if rem is None:
                    lock = self.load_monitor.acquire_for_model_generation()
                elif rem <= 0:
                    raise admission.DeadlineExceededError(
                        "deadline exceeded before model generation"
                    )
                else:
                    lock = self.load_monitor.acquire_for_model_generation(
                        timeout_s=max(0.05, rem)
                    )
            try:
                with lock, progress.step("Generating cluster model"):
                    if builder is not None:
                        # delta-replan seam: the replanner builds (and
                        # returns its delta alongside) under the same
                        # model-generation semaphore the cold path uses
                        return builder(requirements)
                    return self.load_monitor.cluster_model(requirements)
            except RuntimeError:
                if admission.expired():
                    raise admission.DeadlineExceededError(
                        "deadline exceeded waiting for the model-generation "
                        "semaphore"
                    ) from None
                raise

    @staticmethod
    def _to_internal(state: ClusterState, broker_ids: Sequence[int]) -> List[int]:
        """External (Kafka) broker ids → dense internal indices."""
        ext = state.broker_ids or tuple(range(state.num_brokers))
        index = {e: i for i, e in enumerate(ext)}
        try:
            return [index[b] for b in broker_ids]
        except KeyError as e:
            raise ValueError(f"unknown broker id {e.args[0]}") from None

    @staticmethod
    def _to_external_proposals(state: ClusterState, proposals):
        """Internal broker/partition indices → external ids, and disk indices
        → log-dir names, so the executor hands the backend real Kafka ids."""
        ext_b = state.broker_ids or tuple(range(state.num_brokers))
        ext_p = state.partition_ids or tuple(range(state.num_partitions))
        names = state.disk_names
        identity = (
            ext_b == tuple(range(state.num_brokers))
            and ext_p == tuple(range(state.num_partitions))
            and not names
        )
        if identity:
            return list(proposals)

        def dirs(pr):
            if not pr.disk_moves:
                return ()
            # old disk may be unknown (-1): never negative-index into names
            return tuple(
                (ext_b[b], names[b][od] if od >= 0 else "", names[b][nd])
                for b, od, nd in pr.disk_moves
            )

        out = []
        for pr in proposals:
            out.append(
                dataclasses.replace(
                    pr,
                    partition=ext_p[pr.partition],
                    old_leader=ext_b[pr.old_leader],
                    new_leader=ext_b[pr.new_leader],
                    old_replicas=tuple(ext_b[b] for b in pr.old_replicas),
                    new_replicas=tuple(ext_b[b] for b in pr.new_replicas),
                    disk_moves=dirs(pr),
                )
            )
        return out

    def _on_card(self) -> bool:
        """True when the cuda engine runs on the card.  There a failed cuda
        plan surfaces to the caller: the ladder's greedy rung would plan on
        the CPU, and a card failure (a kernel that does not build or
        launch, the card out of memory) must show, not be served around."""
        return torch.device(self.device).type == "cuda"

    @staticmethod
    def _with_broker_state(
        state: ClusterState, internal_ids: Sequence[int], value: BrokerState
    ) -> ClusterState:
        bs = np.array(state.broker_state)
        for b in internal_ids:
            bs[b] = value
        return state.replace(broker_state=torch.from_numpy(bs))

    def _sanity_check_no_execution(self, dryrun: bool) -> None:
        if not dryrun and self.executor.has_ongoing_execution:
            raise OngoingExecutionError(
                "cannot start a new execution while one is in progress"
            )

    # ---- the goal-based operations (upstream GoalBasedOperationRunnable) --------
    def _goal_based_operation(
        self,
        operation: str,
        state: ClusterState,
        goals: Optional[Sequence[str]],
        options: OptimizationOptions,
        dryrun: bool,
        engine: Optional[str],
        progress: OperationProgress,
        strategy: Optional[ReplicaMovementStrategy] = None,
        warm_start=None,
        carry=None,
    ) -> OptimizerResult:
        if tracing.enabled():  # guard: no formatting on the disabled path
            op_span = tracing.span("facade", sub=operation.lower())
        else:
            op_span = tracing.NOOP
        with op_span as sp:
            sp.set("dryrun", dryrun)
            return self._goal_based_operation_traced(
                operation, state, goals, options, dryrun, engine, progress,
                strategy, warm_start=warm_start, carry=carry,
            )

    def _goal_based_operation_traced(
        self,
        operation: str,
        state: ClusterState,
        goals: Optional[Sequence[str]],
        options: OptimizationOptions,
        dryrun: bool,
        engine: Optional[str],
        progress: OperationProgress,
        strategy: Optional[ReplicaMovementStrategy] = None,
        warm_start=None,
        carry=None,
    ) -> OptimizerResult:
        constraint = self._resolved_constraint(state, options)
        # brokers whose every log dir is offline stay alive in the model (their
        # partitions need evacuating) but must not receive new replicas
        topo = self.load_monitor.metadata.refresh()
        for b in topo.degraded_brokers or ():
            try:
                (internal,) = self._to_internal(state, [b])
            except ValueError:
                continue
            options.excluded_brokers_for_replica_move.add(internal)
        # engine degradation ladder (analyzer/degradation.py): a recent
        # cold cuda failure routes would-be cuda operations straight to the
        # greedy engine until the cooldown expires; the first cuda attempt
        # past it is the recovery probe
        cuda_requested = goals is None and \
            (engine or self.default_engine) == "cuda"
        degradation = self.engine_degradation
        degraded_pick = bool(
            cuda_requested and degradation is not None and degradation.active()
        )
        if goals is not None:
            # A goal subset pins the operation's semantics (e.g. demote =
            # PreferredLeaderElectionGoal only).  The cuda search optimizes the
            # full stack, so subset operations always use the greedy engine.
            opt = GoalOptimizer(
                goals=make_goals(goals, constraint),
                constraint=constraint,
            )
        elif degraded_pick:
            opt = self._make_engine("greedy", constraint)
        else:
            opt = self._make_engine(engine, constraint)
        # a dead request must not reach the analyzer at all, and repeated
        # analyzer failures trip the breaker into cached/shed-only serving
        # (both checked before the optimize.start journal mark — a refused
        # request must not leave a dangling start record)
        admission.check_deadline(operation)
        if self.breaker is not None and not self.breaker.allow():
            raise AnalyzerSaturatedError(
                "analyzer circuit breaker open "
                f"({self.breaker.state_summary()['lastError']})",
                retry_after_s=self.breaker.retry_after_s(),
            )
        LOG.info(
            "%s starting: %d brokers / %d partitions, engine=%s, dryrun=%s",
            operation, state.num_brokers, state.num_partitions,
            opt.__class__.__name__, dryrun,
        )
        start_extra = {}
        if warm_start is not None:
            # only stamped on warm runs so cold journals stay byte-stable
            start_extra["warmStart"] = True
        events.emit(
            "optimize.start", operation=operation,
            engine=opt.__class__.__name__, dryrun=dryrun,
            brokers=state.num_brokers, partitions=state.num_partitions,
            **start_extra,
        )
        def _cuda_optimize(o: CudaGoalOptimizer, **kw):
            """The cuda engine's call, typed, so that the static lock
            graph (``PORT_LOCK_GRAPH_r21.json``) sees the engine's device
            lock taken under the facade's locks."""
            return o.optimize(state, options, **kw)

        def _optimize_with(o):
            """One engine attempt, gated: a result with non-finite scores
            or a score worse than the pre-plan state never leaves the
            facade (the plan sanity gate — last line of defense when
            garbage slipped past the monitor's quarantine)."""
            kw = ({"warm_start": warm_start, "carry": carry}
                  if warm_start is not None or carry is not None else {})
            if isinstance(o, CudaGoalOptimizer):
                r = _cuda_optimize(o, **kw)
            else:
                r = o.optimize(state, options, **kw)
            reason = plan_sanity_reason(
                r, hard_goals=self.hard_goal_names
            )
            if reason is not None:
                LOG.error("%s: %s plan rejected (%s)", operation,
                          o.__class__.__name__, reason)
                events.emit(
                    "analyzer.plan_rejected", severity="ERROR",
                    engine=o.__class__.__name__, reason=reason,
                    scoreBefore=r.violation_score_before,
                    scoreAfter=r.violation_score_after,
                )
                raise PlanSanityError(o.__class__.__name__, reason)
            return r

        fell_back = False
        with progress.step(f"Optimizing ({opt.__class__.__name__})"):
            # upstream GoalOptimizer's "proposal-computation-timer"
            with self.registry.timer("proposal-computation-timer"), \
                    tracing.span("facade.optimize"):
                try:
                    try:
                        result = _optimize_with(opt)
                    except Exception as e:
                        if degraded_pick or not cuda_requested \
                                or degradation is None or self._on_card():
                            raise
                        # a COLD cuda failure off the card (a sanity-gate
                        # rejection, say): fall one rung down the ladder — serve this operation on the greedy
                        # engine and hold further cuda attempts for a
                        # breaker-style cooldown
                        fell_back = True
                        LOG.exception(
                            "%s: cuda engine failed; degrading to greedy",
                            operation,
                        )
                        degradation.record_failure(repr(e))
                        events.emit(
                            "analyzer.engine_degraded", severity="WARNING",
                            engine="cuda", fallback="greedy", error=repr(e),
                            cooldownS=degradation.cooldown_s,
                        )
                        result = _optimize_with(
                            self._make_engine("greedy", constraint)
                        )
                except Exception as e:
                    LOG.exception("%s optimization failed", operation)
                    if self.breaker is not None:
                        self.breaker.record_failure(repr(e))
                    # the diagnosability contract: a failed rebalance is
                    # reconstructable from the journal alone — the failing
                    # goal (in the error) + the per-pass reject accounting
                    # the optimizer attached to the failure
                    events.emit(
                        "optimize.failed", severity="ERROR",
                        operation=operation, error=repr(e),
                        goalSummaries=getattr(e, "goal_summaries", None),
                    )
                    raise
                else:
                    if self.breaker is not None:
                        self.breaker.record_success()
                    if (cuda_requested and not degraded_pick
                            and not fell_back and degradation is not None
                            and degradation.record_success()):
                        # the post-cooldown probe succeeded: the ladder
                        # closes and cuda serving resumes
                        events.emit("analyzer.engine_recovered",
                                    engine="cuda")
        LOG.info(
            "%s optimized: %d actions, %d proposals, %.2fs",
            operation, len(result.actions), len(result.proposals),
            result.duration_s,
        )
        events.emit(
            "optimize.end", operation=operation, engine=result.engine,
            numActions=len(result.actions),
            numProposals=len(result.proposals),
            durationS=round(result.duration_s, 3),
            goalSummaries=result.goal_summaries,
        )
        self.registry.meter(f"operation.{operation.lower()}").mark()  # cclint: disable=obs-dynamic-name -- bounded: operation is the REST endpoint vocabulary (rebalance/add_broker/...), not caller data
        # the proposals leaving the facade always speak external (Kafka) ids —
        # dryrun consumers (REST, operators) act on them too, not just the
        # executor
        result.proposals = self._to_external_proposals(state, result.proposals)
        if not dryrun:
            with progress.step(
                f"Executing {len(result.proposals)} proposals"
            ):
                sizes = self._partition_sizes(state)
                events.emit(
                    "execute.start", operation=operation,
                    numProposals=len(result.proposals),
                )
                with self.registry.timer("execution-timer"), \
                        tracing.span("facade.execute"):
                    result.execution = self.executor.execute_proposals(
                        result.proposals, strategy=strategy,
                        partition_sizes=sizes,
                    )
            ex = result.execution
            LOG.info(
                "%s executed: %d completed / %d dead / %d aborted in "
                "%d ticks%s", operation, ex.completed, ex.dead, ex.aborted,
                ex.ticks, " (STOPPED)" if ex.stopped else "",
            )
            events.emit(
                "execute.end", operation=operation,
                severity="WARNING" if (ex.dead or ex.stopped) else "INFO",
                completed=ex.completed, dead=ex.dead, aborted=ex.aborted,
                ticks=ex.ticks, stopped=ex.stopped,
            )
            # the cluster just changed; cached proposals and cached metadata
            # both describe a stale world
            self.invalidate_proposal_cache()
            invalidate = getattr(self.load_monitor.metadata, "invalidate",
                                 None)
            if invalidate is not None:
                invalidate()
        progress.finish()
        return result

    @staticmethod
    def _partition_sizes(state: ClusterState) -> Dict[int, float]:
        from cruise_control_tpu_torch.common.resources import Resource

        disk = np.array(state.leader_load)[:, Resource.DISK]
        ext_p = state.partition_ids or tuple(range(state.num_partitions))
        return {ext_p[p]: float(disk[p]) for p in range(disk.shape[0])}

    def rebalance(
        self,
        goals: Optional[Sequence[str]] = None,
        dryrun: bool = True,
        requirements: Optional[ModelCompletenessRequirements] = None,
        options: Optional[OptimizationOptions] = None,
        engine: Optional[str] = None,
        strategy: Optional[ReplicaMovementStrategy] = None,
        progress: Optional[OperationProgress] = None,
        rebalance_disk: bool = False,
        kafka_assigner: bool = False,
    ) -> OptimizerResult:
        """Upstream ``rebalance()`` — the §3.2 call stack from the facade
        down.  ``rebalance_disk=True`` runs the JBOD intra-broker goal list;
        ``kafka_assigner=True`` the legacy kafka-assigner mode goals."""
        progress = progress or OperationProgress("REBALANCE")
        self._sanity_check_no_execution(dryrun)
        if goals is None and (rebalance_disk or kafka_assigner):
            from cruise_control_tpu_torch.analyzer.goal_optimizer import (
                INTRA_BROKER_GOAL_ORDER,
                KAFKA_ASSIGNER_GOAL_ORDER,
            )
            goals = (INTRA_BROKER_GOAL_ORDER if rebalance_disk
                     else KAFKA_ASSIGNER_GOAL_ORDER)
        if (
            self.replan_heals
            and self.replanner is not None
            and goals is None
            and options is None
            and requirements is None
        ):
            # replan.heal.enabled: a full-stack default-option rebalance —
            # the detector's goal-violation fix — warm-starts from the
            # previous plan through the replanner (the same single-flight
            # lock the proposal path holds, so a heal and a refresh never
            # interleave their snapshot commits).  Goal subsets, explicit
            # options, and completeness overrides keep the cold path: the
            # snapshot describes full-stack plans only.
            with self._compute_lock:
                result, _state = self._replan_operation(  # cclint: disable=blocking-under-lock -- proposal.single_flight intentionally serializes the WHOLE operation, execution-journal write-ahead included: two interleaved plans would corrupt the snapshot commit it exists to protect
                    "REBALANCE", dryrun, engine,
                    self._model_generation(), progress, strategy,
                )
            return result
        state = self._model(requirements, progress)
        return self._goal_based_operation(
            "REBALANCE", state, goals, options or OptimizationOptions(),
            dryrun, engine, progress, strategy,
        )

    def add_brokers(
        self,
        broker_ids: Sequence[int],
        goals: Optional[Sequence[str]] = None,
        dryrun: bool = True,
        engine: Optional[str] = None,
        progress: Optional[OperationProgress] = None,
    ) -> OptimizerResult:
        """Upstream ``addBrokers()``: mark the brokers NEW so distribution
        goals treat them as under-loaded destinations and move load onto
        them.  The brokers must already be registered in the metadata /
        capacity resolver (they joined the cluster empty)."""
        progress = progress or OperationProgress("ADD_BROKER")
        self._sanity_check_no_execution(dryrun)
        state = self._model(None, progress)
        internal = self._to_internal(state, broker_ids)
        state = self._with_broker_state(state, internal, BrokerState.NEW)
        return self._goal_based_operation(
            "ADD_BROKER", state, goals, OptimizationOptions(),
            dryrun, engine, progress,
        )

    def remove_brokers(
        self,
        broker_ids: Sequence[int],
        goals: Optional[Sequence[str]] = None,
        dryrun: bool = True,
        engine: Optional[str] = None,
        progress: Optional[OperationProgress] = None,
    ) -> OptimizerResult:
        """Upstream ``removeBrokers()``: every replica on the brokers becomes
        an immigrant that hard goals must evacuate; the brokers are excluded
        as destinations."""
        progress = progress or OperationProgress("REMOVE_BROKER")
        self._sanity_check_no_execution(dryrun)
        state = self._model(None, progress)
        options = OptimizationOptions(
            brokers_to_remove=set(self._to_internal(state, broker_ids))
        )
        return self._goal_based_operation(
            "REMOVE_BROKER", state, goals, options, dryrun, engine, progress,
        )

    def demote_brokers(
        self,
        broker_ids: Sequence[int],
        dryrun: bool = True,
        engine: Optional[str] = None,
        progress: Optional[OperationProgress] = None,
    ) -> OptimizerResult:
        """Upstream ``demoteBrokers()``: move leadership (and preferred-leader
        position) off the brokers without moving replicas.  Runs only
        PreferredLeaderElectionGoal, with the brokers marked DEMOTED and
        excluded from leadership."""
        progress = progress or OperationProgress("DEMOTE_BROKER")
        self._sanity_check_no_execution(dryrun)
        state = self._model(None, progress)
        internal = self._to_internal(state, broker_ids)
        state = self._with_broker_state(state, internal, BrokerState.DEMOTED)
        options = OptimizationOptions(
            excluded_brokers_for_leadership=set(internal)
        )
        return self._goal_based_operation(
            "DEMOTE_BROKER", state, ["PreferredLeaderElectionGoal"], options,
            dryrun, engine, progress,
        )

    def fix_offline_replicas(
        self,
        goals: Optional[Sequence[str]] = None,
        dryrun: bool = True,
        engine: Optional[str] = None,
        progress: Optional[OperationProgress] = None,
    ) -> OptimizerResult:
        """Upstream ``fixOfflineReplicas()``: dead brokers' replicas are
        offline in the model; the hard-goal stack evacuates them."""
        progress = progress or OperationProgress("FIX_OFFLINE_REPLICAS")
        self._sanity_check_no_execution(dryrun)
        state = self._model(None, progress)
        return self._goal_based_operation(
            "FIX_OFFLINE_REPLICAS", state, goals, OptimizationOptions(),
            dryrun, engine, progress,
        )

    def fix_topic_replication_factor(
        self,
        target_rf: int,
        dryrun: bool = True,
        progress: Optional[OperationProgress] = None,
        topic_regex: Optional[str] = None,
    ) -> "TopicConfigurationResult":
        """Upstream ``TopicConfigurationRunnable`` (update_topic_config
        endpoint), routed through the goal framework (VERDICT round-1 #9):

        RF *increases* widen the tensor model's replica-slot axis and place
        each new replica on a zero-capacity virtual DEAD broker — the goal
        machinery then evacuates those offline "immigrants" through the
        normal acceptance chain, so capacity, rack-awareness and every other
        hard goal pick the destinations (an RF-increase that would overflow
        a broker lands elsewhere or fails loudly, never silently overloads).
        RF *decreases* drop follower replicas keeping rack diversity.
        ``topic_regex`` scopes the change (upstream topic parameter)."""
        import re

        from cruise_control_tpu_torch.common.resources import (
            EMPTY_SLOT,
            BrokerState,
        )

        progress = progress or OperationProgress("TOPIC_CONFIGURATION")
        self._sanity_check_no_execution(dryrun)
        state = self._model(None, progress)
        pat = re.compile(topic_regex) if topic_regex else None
        topic_ok = np.ones(max(state.num_topics, 1), bool)
        if pat is not None:
            if not state.topic_names:
                raise ValueError(
                    "topic_regex given but the model carries no topic "
                    "names — a scoped RF change must never widen silently"
                )
            topic_ok = np.array([
                bool(pat.fullmatch(n)) for n in state.topic_names
            ])
            if not topic_ok.any():
                raise ValueError(
                    f"topic_regex {topic_regex!r} matches no topic"
                )

        with progress.step("Widening model to the target RF"):
            a = np.array(state.assignment)
            off = np.array(state.replica_offline)
            P, S = a.shape
            S_new = max(S, target_rf)
            if S_new > S:
                pad = np.full((P, S_new - S), EMPTY_SLOT, a.dtype)
                a = np.concatenate([a, pad], axis=1)
                off = np.concatenate(
                    [off, np.zeros((P, S_new - S), bool)], axis=1
                )
            rf = (a != EMPTY_SLOT).sum(axis=1)
            scoped = topic_ok[np.asarray(state.partition_topic)]
            grow = scoped & (rf < target_rf)
            # virtual broker: DEAD, zero capacity, its own rack — its
            # replicas are immigrants every hard goal must evacuate
            B = state.num_brokers
            vb = B
            changed = False
            for p in np.nonzero(grow)[0]:
                for s in range(S_new):
                    if rf[p] >= target_rf:
                        break
                    if a[p, s] == EMPTY_SLOT:
                        a[p, s] = vb
                        off[p, s] = True
                        rf[p] += 1
                        changed = True
            # RF decrease: drop followers, keeping one replica per rack
            # first (removals cannot violate capacity).  The removals are
            # pre-applied to the model AND recorded — the optimizer's diff
            # starts from the shrunk placement, so the removal proposals
            # must be emitted explicitly below.
            shrink = scoped & (rf > target_rf)
            racks = np.array(state.broker_rack)
            lslot = np.array(state.leader_slot)
            orig_assignment = np.array(state.assignment)
            shrink_old: Dict[int, tuple] = {}
            for p in np.nonzero(shrink)[0]:
                pre = tuple(
                    int(b) for b in orig_assignment[p] if b != EMPTY_SLOT
                )
                # greedy keep-selection with a LIVE rack set: rack-new slots
                # are taken as they are found, so duplicate-rack followers
                # are dropped before rack-distinct ones (keeping a replica
                # that already hosts the data is a zero-copy removal; the
                # alternative forces the goal chain to re-add the data on a
                # fresh broker)
                keep = [int(lslot[p])]
                seen_racks = {int(racks[a[p, lslot[p]]])}
                rest = [
                    s for s in range(S_new)
                    if s != lslot[p] and a[p, s] != EMPTY_SLOT
                    and a[p, s] < B
                ]
                for rack_new in (True, False):
                    for s in rest:
                        if len(keep) >= target_rf or s in keep:
                            continue
                        if (int(racks[a[p, s]]) not in seen_racks) == rack_new:
                            keep.append(s)
                            seen_racks.add(int(racks[a[p, s]]))
                for s in range(S_new):
                    if s not in keep and a[p, s] != EMPTY_SLOT:
                        a[p, s] = EMPTY_SLOT
                        off[p, s] = False
                        changed = True
                shrink_old[int(p)] = pre
            if not changed:
                progress.finish()
                return TopicConfigurationResult([], None)
            widened = state.replace(
                assignment=a,
                replica_offline=off,
                broker_capacity=np.concatenate([
                    np.array(state.broker_capacity),
                    np.zeros((1, state.broker_capacity.shape[1]), np.float32),
                ]),
                broker_rack=np.concatenate([
                    racks, np.array([int(racks.max(initial=0)) + 1],
                                    racks.dtype)
                ]),
                broker_state=np.concatenate([
                    np.array(state.broker_state),
                    np.array([int(BrokerState.DEAD)], np.int8),
                ]),
                broker_ids=(
                    tuple(state.broker_ids) + (-1,) if state.broker_ids
                    else ()
                ),
            )

        with progress.step("Placing new replicas through the goal chain"):
            # hard goals only (honoring the hard.goals override): evacuate
            # the virtual replicas through the full acceptance chain with
            # minimal other movement (upstream TopicConfigurationRunnable)
            options = OptimizationOptions()
            constraint = self._resolved_constraint(widened, options)
            hard = self.hard_goal_names or [
                g.name for g in make_goals(None, constraint) if g.is_hard
            ]
            opt = GoalOptimizer(
                goals=make_goals(hard, constraint, hard_names=hard),
                constraint=constraint,
            )
            result = opt.optimize(widened, options)
            # the virtual broker never existed: scrub it from old-replica
            # lists so proposals describe a pure replica addition; RF
            # decreases (pre-applied above) get their removal proposals
            # emitted here, composed with any optimizer move on the same
            # partition
            by_p = {pr.partition: pr for pr in result.proposals}
            cleaned = []
            for p, pr in by_p.items():
                old = tuple(b for b in pr.old_replicas if b != vb)
                if p in shrink_old:
                    old = shrink_old.pop(p)
                cleaned.append(dataclasses.replace(pr, old_replicas=old))
            fa = np.array(result.final_state.assignment)
            fls = np.array(result.final_state.leader_slot)
            ptopic = np.array(widened.partition_topic)
            for p, pre in shrink_old.items():  # pure removals
                new = tuple(int(b) for b in fa[p] if b != EMPTY_SLOT)
                leader = int(fa[p, fls[p]])
                cleaned.append(ExecutionProposal(
                    partition=p,
                    topic=int(ptopic[p]),
                    old_leader=leader, new_leader=leader,
                    old_replicas=pre,
                    new_replicas=tuple(
                        sorted(new, key=lambda b: b != leader)
                    ),
                ))
            proposals = self._to_external_proposals(widened, cleaned)
        execution = None
        if not dryrun and proposals:
            with progress.step(f"Executing {len(proposals)} RF changes"):
                sizes = self._partition_sizes(state)
                execution = self.executor.execute_proposals(
                    proposals, partition_sizes=sizes,
                )
            self.invalidate_proposal_cache()
            invalidate = getattr(self.load_monitor.metadata, "invalidate",
                                 None)
            if invalidate is not None:
                invalidate()
        progress.finish()
        return TopicConfigurationResult(proposals, execution)

    # ---- proposals cache (upstream proposal precompute, §3.5) -------------------
    def _servable_cached(
        self, ignore_cache: bool, generation_fresh_only: bool
    ) -> Optional[OptimizerResult]:
        """The cached result a get_proposals call may answer with, or
        None.  ``generation_fresh_only`` is the serving layer's stricter
        freshness (warm plan at the current model generation); the legacy
        path keeps the wall-clock TTL semantics."""
        if ignore_cache:
            return None
        if generation_fresh_only:
            if not self.proposal_cache_fresh():
                return None
            with self._cache_lock:
                plan = self._last_good
            return plan.result if plan is not None else None
        with self._cache_lock:
            fresh = (
                self._cached_proposals is not None
                and time.time() - self._cached_at < self._proposal_ttl_s
            )
            return self._cached_proposals if fresh else None

    def get_proposals(
        self,
        engine: Optional[str] = None,
        ignore_cache: bool = False,
        progress: Optional[OperationProgress] = None,
        generation_fresh_only: bool = False,
    ) -> OptimizerResult:
        progress = progress or OperationProgress("PROPOSALS")
        cached = self._servable_cached(ignore_cache, generation_fresh_only)
        if cached is not None:
            progress.add_step("Returning cached proposals")
            progress.finish()
            return cached
        # single-flight: a stampede on a cold cache serializes here and
        # every follower re-checks the cache the leader just filled.  The
        # wait honors the caller's deadline.
        rem = admission.remaining_s()
        acquired = self._compute_lock.acquire(
            timeout=-1 if rem is None else max(0.0, rem)
        )
        if not acquired:
            raise admission.DeadlineExceededError(
                "deadline exceeded waiting for an in-flight proposal "
                "computation"
            )
        try:
            cached = self._servable_cached(
                ignore_cache, generation_fresh_only
            )
            if cached is not None:
                progress.add_step("Returning cached proposals")
                progress.finish()
                return cached
            generation = self._model_generation()
            if self.replanner is not None:
                result, state = self._replan_proposals(  # cclint: disable=blocking-under-lock -- proposal.single_flight intentionally serializes the whole proposal computation (that is the single-flight contract); journal write-ahead rides inside it by design
                    engine, generation, progress
                )
            else:
                state = self._model(None, progress)
                result = self._goal_based_operation(  # cclint: disable=blocking-under-lock -- proposal.single_flight intentionally serializes the whole proposal computation (that is the single-flight contract); journal write-ahead rides inside it by design
                    "PROPOSALS", state, None, OptimizationOptions(), True,
                    engine, progress,
                )
            sizes = self._partition_sizes(state)
        finally:
            self._compute_lock.release()
        now = time.time()
        with self._cache_lock:
            self._cached_proposals = result
            self._cached_at = now
            self._last_good = CachedPlan(
                result=result,
                generation=generation,
                partition_sizes=sizes,
                computed_monotonic=time.monotonic(),
                computed_unix=now,
                engine=result.engine,
            )
        return result

    def _replan_proposals(self, engine, generation: str, progress):
        """Proposal computation through the delta replanner (see
        :meth:`_replan_operation`)."""
        return self._replan_operation(
            "PROPOSALS", True, engine, generation, progress
        )

    def _replan_operation(self, operation: str, dryrun: bool, engine,
                          generation: str, progress, strategy=None):
        """A goal-based operation through the delta replanner: delta model
        build under the model semaphore → warm-start decision → warm (or
        cold) optimization → snapshot commit.  A warm-path failure falls
        back to one cold attempt — a replan must never be WORSE than the
        cold path it replaces — and every decision lands in the journal
        (``replan.start`` / ``replan.end`` / ``replan.warm_failed``).
        The whole decision runs under a ``facade.replan`` span, so a
        trace reconstructed from one id shows the replan phase between
        the request span and the engine's device slices.

        ``dryrun=False`` is the self-healing seam (replan.heal.enabled):
        the detector's full-stack REBALANCE fix warm-starts exactly like a
        proposal refresh, then executes — so a fault's heal plan absorbs
        into the steady state instead of cold-recomputing.  Executed
        operations never take the zero-delta short-circuit (re-executing a
        snapshot plan would re-issue moves the cluster already made)."""
        with tracing.span("facade.replan"):
            return self._replan_operation_traced(
                operation, dryrun, engine, generation, progress, strategy
            )

    def _replan_operation_traced(self, operation: str, dryrun: bool, engine,
                                 generation: str, progress, strategy=None):
        built = self._model(
            None, progress, builder=self.replanner.build_model
        )
        state, delta, agg_mark = built
        warm, reason = self.replanner.warm_start_for(state, delta)
        # zero-delta short-circuit: the generation bumped but the delta
        # build proved the model BIT-IDENTICAL to the snapshot's (every
        # drift below the dirty threshold patched away, no topology or
        # shape change) — the previous plan is exactly servable, no
        # search needed.  This is the ROADMAP item-2 cache-invalidation
        # story closed: a window roll re-validates the cached plan in
        # milliseconds instead of recomputing it.  The full-verify
        # safety net (replan.full.verify) disables the short-circuit.
        snap_result = (
            self.replanner.servable_snapshot(
                engine or self.default_engine, delta
            ) if dryrun else None
        )
        # heal-origin replans stamp their operation on the envelope;
        # PROPOSALS refreshes keep their historical (fingerprinted) shape
        op_extra = {} if operation == "PROPOSALS" else {
            "operation": operation}
        if warm is not None and snap_result is not None:
            events.emit(
                "replan.start", mode="warm", reason=None,
                generation=generation, dirtyPartitions=0, deltaModel=True,
                **op_extra,
            )
            self.replanner.commit(
                state, snap_result, generation, agg_mark
            )
            self.replanner.record_mode("warm", "zero-delta")
            events.emit(
                "replan.end", mode="warm", reason=None,
                generation=generation, dirtyPartitions=0, deltaModel=True,
                shortCircuit=True,
                tableCarry=bool(self.replanner.carry.tables is not None),
                engine=snap_result.engine, goalsReused=-1,
                durationS=0.0, **op_extra,
            )
            progress.add_step("Re-validated previous plan (zero delta)")
            return snap_result, state
        mode = "warm" if warm is not None else "cold"
        events.emit(
            "replan.start", mode=mode, reason=None if warm else reason,
            generation=generation,
            dirtyPartitions=(
                delta.n_dirty_partitions if delta is not None else None
            ),
            deltaModel=bool(delta is not None and not delta.full),
            **op_extra,
        )
        t0 = time.perf_counter()
        # a cold plan takes the carry too (warm_start=None): it exports its
        # device model and row tables, so the first warm plan after it
        # already rides them
        kwargs = self.replanner.engine_kwargs(warm)
        try:
            result = self._goal_based_operation(
                operation, state, None, OptimizationOptions(), dryrun,
                engine, progress, strategy, **kwargs,
            )
        except Exception as e:
            if warm is None:
                raise
            # the warm attempt failed (seed infeasible under the new
            # model, carry drift, ...): journal it, drop the replan state,
            # and serve the request through one cold attempt
            LOG.warning("warm replan failed, falling back cold: %r", e)
            events.emit(
                "replan.warm_failed", severity="WARNING", error=repr(e),
                generation=generation,
            )
            self.replanner.reset("warm-failed")
            mode, reason = "cold", "warm-failed"
            result = self._goal_based_operation(
                operation, state, None, OptimizationOptions(), dryrun,
                engine, progress, strategy,
                **self.replanner.engine_kwargs(None),
            )
        self.replanner.commit(state, result, generation, agg_mark)
        self.replanner.record_mode(mode, reason)
        verify = getattr(result, "replan_verify", None)
        events.emit(
            "replan.end", mode=mode,
            reason=None if mode == "warm" else reason,
            generation=generation,
            dirtyPartitions=(
                delta.n_dirty_partitions if delta is not None else None
            ),
            deltaModel=bool(delta is not None and not delta.full),
            tableCarry=bool(self.replanner.carry.tables is not None),
            engine=result.engine,
            goalsReused=(
                len(verify["reusedAfter"]) if verify is not None else 0
            ),
            durationS=round(time.perf_counter() - t0, 4),
            **op_extra,
        )
        return result, state

    def _model_generation(self) -> str:
        gen = getattr(self.load_monitor, "model_generation", None)
        return gen() if gen is not None else ""

    def invalidate_proposal_cache(self, reason: str = "execution") -> None:
        """Drop the TTL cache and mark the warm plan stale.  The warm plan
        is KEPT — it is the last-good answer degraded-mode serving falls
        back on, now carrying its invalidation reason.  What-if verdicts
        ride the same invalidation: a counterfactual computed against a
        model the cluster no longer matches has no stale-serving value."""
        with self._cache_lock:
            self._cached_proposals = None
            if self._last_good is not None and \
                    self._last_good.invalidated is None:
                self._last_good.invalidated = reason
        self._whatif_cache.invalidate(reason)

    def note_anomaly(self, anomaly) -> None:
        """Detector hook: a detected anomaly means the model the warm plan
        was computed against no longer describes the cluster."""
        self.invalidate_proposal_cache(
            f"anomaly:{anomaly.anomaly_type.value}"
        )

    def proposal_cache_fresh(self) -> bool:
        """True while the warm plan still answers for the live model:
        computed against the current model generation, never invalidated,
        and inside the TTL."""
        with self._cache_lock:
            plan = self._last_good
        if plan is None or plan.invalidated is not None:
            return False
        if plan.age_s() >= self._proposal_ttl_s:
            return False
        return plan.generation == self._model_generation()

    def proposal_cache_state(self) -> dict:
        with self._cache_lock:
            plan = self._last_good
        if plan is None:
            out = {"cacheWarm": False}
        else:
            out = {
                "cacheWarm": True,
                "cacheFresh": self.proposal_cache_fresh(),
                "cacheGeneration": plan.generation,
                "cacheAgeS": round(plan.age_s(), 3),
                "cacheInvalidated": plan.invalidated,
                "cacheEngine": plan.engine,
            }
        if self.replanner is not None:
            out["replan"] = self.replanner.state_summary()
        return out

    def serve_proposals(
        self,
        engine: Optional[str] = None,
        ignore_cache: bool = False,
        allow_stale: bool = True,
        progress: Optional[OperationProgress] = None,
    ) -> "Tuple[OptimizerResult, dict]":
        """The serving-layer entry for ``GET /proposals``: answer from the
        warm plan in milliseconds when it is fresh, recompute when it is
        not — and when the analyzer is saturated (breaker open) or the
        monitor window-starved, **degrade** to the last-good plan with an
        explicit ``stale=true`` + generation marker instead of 503ing.

        Returns ``(result, meta)`` with meta keys ``cached`` / ``stale`` /
        ``proposalGeneration`` / ``cacheAgeS`` / ``staleReason``."""
        def meta_for(plan: CachedPlan, stale: bool) -> dict:
            out = {
                "cached": True,
                "stale": stale,
                "proposalGeneration": plan.generation,
                "cacheAgeS": round(plan.age_s(), 3),
            }
            if stale:
                out["staleReason"] = (
                    plan.invalidated or "model generation advanced"
                )
            return out

        with self._cache_lock:
            plan = self._last_good
        if plan is not None and not ignore_cache \
                and self.proposal_cache_fresh():
            self.registry.meter("proposals.cache.hit").mark()
            return plan.result, meta_for(plan, stale=False)
        try:
            result = self.get_proposals(
                engine=engine, ignore_cache=ignore_cache, progress=progress,
                generation_fresh_only=True,
            )
        except Exception:
            # saturated / window-starved / analyzer failure: the degraded
            # path — for a read-only plan view, the last-good plan with an
            # explicit stale marker beats a 503 (the failure itself is
            # journaled by the compute path; repeated ones trip the breaker)
            if plan is not None and allow_stale:
                self.registry.meter("proposals.cache.stale").mark()
                events.emit("proposals.served_stale", severity="WARNING",
                            generation=plan.generation,
                            reason=plan.invalidated or "stale-generation")
                return plan.result, meta_for(plan, stale=True)
            raise
        self.registry.meter("proposals.cache.miss").mark()
        with self._cache_lock:
            new_plan = self._last_good
        meta = {"cached": False, "stale": False}
        if new_plan is not None:
            meta["proposalGeneration"] = new_plan.generation
        return result, meta

    def rebalance_cached(
        self,
        dryrun: bool = True,
        progress: Optional[OperationProgress] = None,
        strategy: Optional[ReplicaMovementStrategy] = None,
    ) -> OptimizerResult:
        """``POST /rebalance?allow_cached=true``: execute (or return) the
        warm precomputed plan in milliseconds instead of recomputing.
        Falls back to a full rebalance when no warm plan exists.  A stale
        plan is still served/executed — that is the operator's explicit
        ``allow_cached`` trade — with the staleness marked on the result."""
        progress = progress or OperationProgress("REBALANCE")
        with self._cache_lock:
            plan = self._last_good
        if plan is None:
            return self.rebalance(dryrun=dryrun, progress=progress,
                                  strategy=strategy)
        stale = not self.proposal_cache_fresh()
        result = dataclasses.replace(plan.result) if dataclasses.is_dataclass(
            plan.result) else plan.result
        result.cache_meta = {
            "cached": True,
            "stale": stale,
            "proposalGeneration": plan.generation,
            "cacheAgeS": round(plan.age_s(), 3),
        }
        self.registry.meter(
            "proposals.cache.stale" if stale else "proposals.cache.hit"
        ).mark()
        progress.add_step("Serving precomputed proposals")
        if dryrun:
            progress.finish()
            return result
        self._sanity_check_no_execution(dryrun)
        with progress.step(
            f"Executing {len(result.proposals)} cached proposals"
        ):
            events.emit(
                "execute.start", operation="REBALANCE",
                numProposals=len(result.proposals), cached=True,
                stale=stale,
            )
            with self.registry.timer("execution-timer"), \
                    tracing.span("facade.execute"):
                result.execution = self.executor.execute_proposals(
                    result.proposals, strategy=strategy,
                    partition_sizes=plan.partition_sizes,
                )
        ex = result.execution
        events.emit(
            "execute.end", operation="REBALANCE",
            severity="WARNING" if (ex.dead or ex.stopped) else "INFO",
            completed=ex.completed, dead=ex.dead, aborted=ex.aborted,
            ticks=ex.ticks, stopped=ex.stopped,
        )
        self.invalidate_proposal_cache()
        invalidate = getattr(self.load_monitor.metadata, "invalidate", None)
        if invalidate is not None:
            invalidate()
        progress.finish()
        return result

    def start_proposal_precomputation(
        self, interval_s: float = 30.0, engine: Optional[str] = None
    ) -> "ProposalPrecomputingExecutor":
        """Launch the background proposal-precompute thread (§3.5)."""
        from cruise_control_tpu_torch.analyzer.precompute import (
            ProposalPrecomputingExecutor,
        )

        if self.proposal_precomputer is None:
            self.proposal_precomputer = ProposalPrecomputingExecutor(
                self, interval_s, engine
            )
            self.proposal_precomputer.start()
        return self.proposal_precomputer

    def stop_proposal_precomputation(self) -> None:
        if self.proposal_precomputer is not None:
            self.proposal_precomputer.stop()
            self.proposal_precomputer = None

    # ---- counterfactual what-if engine (ISSUE 16) -------------------------------
    def whatif(
        self,
        futures: Optional[Sequence] = None,
        progress: Optional[OperationProgress] = None,
        use_cache: bool = True,
    ) -> WhatifResult:
        """Evaluate hypothetical futures in ONE batched device dispatch.

        ``futures`` is a sequence of :class:`whatif.FutureSpec`; None
        derives the model's likely futures.  Verdicts are cached per
        ``model_generation × fingerprint`` — an all-hit request answers
        in microseconds without touching the model semaphore."""
        from cruise_control_tpu_torch.whatif.compiler import compile_futures
        from cruise_control_tpu_torch.whatif.engine import (
            evaluate_batch,
            verdicts as verdicts_of,
        )
        from cruise_control_tpu_torch.whatif.futures import likely_futures

        progress = progress or OperationProgress("WHATIF")
        generation = self._model_generation()
        if futures is not None:
            futures = tuple(futures)
            if len(futures) > self.whatif_max_futures:
                raise ValueError(
                    f"{len(futures)} futures > cap "
                    f"{self.whatif_max_futures} (whatif.max.futures)"
                )
            if use_cache:
                cached = [
                    self._whatif_cache.get(generation, f.fingerprint())
                    for f in futures
                ]
                if all(v is not None for v in cached):
                    self.registry.meter("whatif.cache.hit").mark()
                    events.emit(
                        "whatif.request", numFutures=len(futures),
                        cached=True, generation=generation,
                    )
                    progress.add_step("Serving cached what-if verdicts")
                    progress.finish()
                    return WhatifResult(
                        verdicts=cached, generation=generation,
                        batch_size=0, cached=True,
                    )
        self.registry.meter("whatif.cache.miss").mark()
        state = self._model(None, progress)
        if futures is None:
            futures = likely_futures(
                state, k=max(self.whatif_precompute_futures, 8)
            )
        events.emit(
            "whatif.request", numFutures=len(futures), cached=False,
            generation=generation,
        )
        with progress.step(f"Evaluating {len(futures)} futures"), \
                tracing.span("whatif.evaluate"):
            t0 = time.perf_counter()
            batch = compile_futures(state, futures)
            raw = evaluate_batch(
                state, batch, capacity_scale=self._whatif_capacity_scale(),
                device=self.device,
            )
            duration_s = time.perf_counter() - t0
        verdict_list = verdicts_of(batch, raw)
        for f, v in zip(futures, verdict_list):
            self._whatif_cache.put(generation, f.fingerprint(), v)
        events.emit(
            "whatif.evaluated", numFutures=len(futures),
            batchSize=batch.padded_size, generation=generation,
            survivable=sum(1 for v in verdict_list if v["survivable"]),
            violations=sum(v["goalViolations"] for v in verdict_list),
            durationS=round(duration_s, 4),
        )
        progress.finish()
        return WhatifResult(
            verdicts=verdict_list, generation=generation,
            batch_size=batch.padded_size, cached=False,
        )

    def _whatif_capacity_scale(self):
        """Per-resource usable-fraction vector from the analyzer's
        capacity thresholds, so what-if overload verdicts share the
        capacity goals' bar instead of raw hardware limits."""
        from cruise_control_tpu_torch.common.resources import (
            NUM_RESOURCES,
            Resource,
        )

        thresholds = self.constraint.capacity_threshold
        return [
            float(thresholds.get(Resource(r), 1.0))
            for r in range(NUM_RESOURCES)
        ]

    def whatif_cache_fresh(self) -> bool:
        """The precompute daemon's per-future freshness probe (the
        satellite-2 generalization of ``proposal_cache_fresh``): True
        while the warm top-k future set still answers for the live model
        generation — or what-if precompute is disabled entirely."""
        if self.whatif_precompute_futures <= 0:
            return True
        return self._whatif_cache.fresh_for(self._model_generation())

    def refresh_whatif_precompute(self) -> int:
        """Re-evaluate the top-k likely futures against a fresh model and
        mark the warm set current (daemon-driven; one batched dispatch)."""
        from cruise_control_tpu_torch.whatif.compiler import compile_futures
        from cruise_control_tpu_torch.whatif.engine import (
            evaluate_batch,
            verdicts as verdicts_of,
        )
        from cruise_control_tpu_torch.whatif.futures import likely_futures

        k = self.whatif_precompute_futures
        if k <= 0:
            return 0
        progress = OperationProgress("WHATIF")
        generation = self._model_generation()
        state = self._model(None, progress)
        futures = likely_futures(state, k)
        if not futures:
            return 0
        batch = compile_futures(state, futures)
        raw = evaluate_batch(
            state, batch, capacity_scale=self._whatif_capacity_scale(),
            device=self.device,
        )
        for f, v in zip(futures, verdicts_of(batch, raw)):
            self._whatif_cache.put(generation, f.fingerprint(), v)
        self._whatif_cache.mark_warm(generation)
        events.emit(
            "whatif.precompute", numFutures=len(futures),
            generation=generation,
        )
        progress.finish()
        return len(futures)

    def whatif_cache_state(self) -> dict:
        return self._whatif_cache.state_summary()

    def rightsize(
        self, progress: Optional[OperationProgress] = None
    ) -> "ProvisionResponse":
        """Upstream RIGHTSIZE endpoint: provisioning analysis of the live
        cluster (ProvisionResponse)."""
        from cruise_control_tpu_torch.analyzer.provision import analyze_provisioning

        progress = progress or OperationProgress("RIGHTSIZE")
        state = self._model(None, progress)
        with progress.step("Analyzing provisioning"):
            response = analyze_provisioning(state)
        progress.finish()
        return response

    # ---- crash recovery (docs/ARCHITECTURE.md "Execution recovery") -------------
    def recover_execution(self):
        """Resume (or cleanly settle) an execution a previous process
        left checkpointed.  Called once at startup, before the executor
        adopts foreign reassignments and before the detector scheduler
        starts: the checkpoint's moves are OURS, and the detector's
        self-healing must treat the recovered execution like a fix of its
        own (cooldown starts at the next detection cycle, so recovery
        cannot double-fire a concurrent self-heal).

        Returns the resumed ExecutionResult, or None when there is no
        journal / no in-flight checkpoint / reconciliation failed (the
        failure is journaled as ``execution.recovery.end`` outcome
        ``aborted`` and the checkpoint cleared, so a crash loop cannot
        wedge startup)."""
        journal = getattr(self.executor, "journal", None)
        if journal is None:
            return None
        checkpoint = journal.load()
        if checkpoint is None:
            return None
        LOG.warning(
            "found in-flight execution checkpoint (execution %d, %d "
            "proposals, phase %s): recovering",
            checkpoint.execution_id, len(checkpoint.proposals),
            checkpoint.phase,
        )
        events.emit(
            "execution.recovery.start", severity="WARNING",
            executionId=checkpoint.execution_id,
            numProposals=len(checkpoint.proposals),
            phase=checkpoint.phase,
            resumedBefore=checkpoint.resumed_before,
        )
        self.executor.last_checkpoint_epoch = checkpoint.epoch
        result = None
        try:
            result = self.executor.resume(checkpoint)
        except StaleControllerEpochError as e:
            # zombie resume refused: a newer controller already claimed the
            # cluster past this checkpoint's epoch.  Do NOT clear the
            # checkpoint — it belongs to the live controller now; this
            # process just stands down (executor.fenced is already
            # journaled by the fenced wrapper).
            LOG.error("execution recovery fenced — standing down: %s", e)
            events.emit(
                "execution.recovery.end", severity="ERROR",
                executionId=checkpoint.execution_id, outcome="fenced",
                succeeded=False, error=repr(e),
            )
            return None
        except Exception as e:
            # a recovery that cannot even reconcile must not wedge every
            # subsequent startup: journal the abort and clear the
            # checkpoint (the event journal keeps the full story)
            LOG.exception("execution recovery failed; aborting checkpoint")
            events.emit(
                "execution.recovery.end", severity="ERROR",
                executionId=checkpoint.execution_id, outcome="aborted",
                succeeded=False, error=repr(e),
            )
            journal.thaw()
            journal.append("end", executionId=checkpoint.execution_id,
                           outcome="recovery-aborted", error=repr(e))
        else:
            events.emit(
                "execution.recovery.end",
                severity="INFO" if result.succeeded else "WARNING",
                executionId=checkpoint.execution_id, outcome="resumed",
                succeeded=result.succeeded, completed=result.completed,
                dead=result.dead, aborted=result.aborted,
                ticks=result.ticks,
            )
        if self.anomaly_detector is not None:
            # the recovered execution counts as the last fix: self-healing
            # honors the cooldown instead of double-firing mid-recovery
            self.anomaly_detector.note_recovery()
        # whatever happened, the cluster moved while we were away
        self.invalidate_proposal_cache()
        invalidate = getattr(self.load_monitor.metadata, "invalidate", None)
        if invalidate is not None:
            invalidate()
        return result

    # ---- admin ------------------------------------------------------------------
    def stop_execution(self) -> None:
        self.executor.stop_execution()

    def pause_sampling(self) -> None:
        self.load_monitor.pause_sampling()

    def resume_sampling(self) -> None:
        self.load_monitor.resume_sampling()

    # ---- state aggregate (upstream GET /state, §5.5) ----------------------------
    def state(self, verbose: bool = False) -> dict:
        out = {
            "version": 1,
            "upTimeSeconds": round(time.time() - self._start_time, 1),
            "MonitorState": self.load_monitor.state_summary(),
            "ExecutorState": self.executor.state_summary(verbose=verbose),
            "AnalyzerState": {
                "engine": self.default_engine,
                "isProposalReady": self._cached_proposals is not None,
                "readyGoals": [g.name for g in make_goals(
                    constraint=self.constraint)],
                "proposalCache": self.proposal_cache_state(),
                **(
                    {"proposalPrecompute":
                     self.proposal_precomputer.state_summary()}
                    if self.proposal_precomputer is not None else {}
                ),
                **(
                    {"circuitBreaker": self.breaker.state_summary()}
                    if self.breaker is not None else {}
                ),
                **(
                    {"engineDegradation":
                     self.engine_degradation.state_summary()}
                    if self.engine_degradation is not None else {}
                ),
            },
        }
        if self.anomaly_detector is not None:
            out["AnomalyDetectorState"] = self.anomaly_detector.state_summary()
        out["Metrics"] = self.registry.snapshot()
        if verbose:
            # recent completed root spans (telemetry subsystem); the cheap
            # always-on summary stays out of the 5s-poll payload
            out["Telemetry"] = {
                "enabled": tracing.enabled(),
                "recentSpans": tracing.recent_roots(32),
            }
        return out

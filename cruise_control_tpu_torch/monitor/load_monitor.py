"""LoadMonitor — owns aggregators + metadata and produces ``ClusterState``
snapshots (upstream ``monitor/LoadMonitor.java`` + ``LoadMonitorState`` +
``ModelCompletenessRequirements`` + ``MetadataClient``; SURVEY.md §2.3, call
stacks §3.2/§3.3).

Differences from upstream are TPU-shaped, not semantic: the "model" handed to
the analyzer is the dense :class:`ClusterState` pytree (built in one pass from
the aggregate tensors), and window aggregation is vectorized.  The
concurrency contract is upstream's: a semaphore gates model generation, and
sampling iterations are explicit ticks (driven by a scheduler thread in a
real deployment, by tests here).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, List, Optional

import numpy as np

from cruise_control_tpu_torch.common.resources import (
    FOLLOWER_CPU_RATIO,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.models.builder import ClusterModelBuilder
from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.monitor.aggregator import (
    AggregationOptions,
    MetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.capacity import (
    BrokerCapacityConfigResolver,
    StaticCapacityResolver,
)
from cruise_control_tpu_torch.utils.locks import InstrumentedSemaphore
from cruise_control_tpu_torch.monitor.sampling import (
    BROKER_DEF,
    PARTITION_DEF,
    P_CPU,
    P_DISK,
    P_NW_IN,
    P_NW_OUT,
    MetricSampler,
    SampleValidator,
)
from cruise_control_tpu_torch.monitor.sample_store import NoopSampleStore, SampleStore
from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.utils.logging import get_logger

_LOG = get_logger("monitor")


class LoadMonitorState(enum.Enum):
    NOT_STARTED = "NOT_STARTED"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    LOADING = "LOADING"


@dataclasses.dataclass
class ModelCompletenessRequirements:
    """Upstream ``ModelCompletenessRequirements``: what a goal demands of the
    monitored data before trusting a model built from it."""

    min_required_num_windows: int = 1
    min_monitored_partitions_ratio: float = 0.95
    include_all_topics: bool = False

    def stronger(self, other: "ModelCompletenessRequirements"):
        return ModelCompletenessRequirements(
            max(self.min_required_num_windows, other.min_required_num_windows),
            max(self.min_monitored_partitions_ratio,
                other.min_monitored_partitions_ratio),
            self.include_all_topics or other.include_all_topics,
        )


class NotEnoughValidWindowsError(RuntimeError):
    pass


@dataclasses.dataclass
class ClusterTopology:
    """Metadata snapshot (upstream ``MetadataClient`` view): placement plus
    broker attributes."""

    assignment: Dict[int, List[int]]      # partition → replica brokers
    leaders: Dict[int, int]               # partition → leader broker
    broker_rack: Dict[int, int]           # broker → rack id
    partition_topic: Dict[int, str]       # partition → topic name
    alive_brokers: Optional[set] = None   # None = all referenced brokers
    #: partition → brokers whose replica is offline (failed disk) even though
    #: the broker itself is alive; None = none
    offline_replicas: Optional[Dict[int, List[int]]] = None
    #: alive brokers that must not receive replicas (all log dirs offline)
    degraded_brokers: Optional[set] = None
    #: JBOD: (partition, broker) → log dir currently hosting the replica
    replica_dirs: Optional[Dict] = None
    #: JBOD: broker → offline log dirs
    offline_dirs: Optional[Dict[int, List[str]]] = None

    @property
    def num_partitions(self) -> int:
        return len(self.assignment)

    def broker_ids(self) -> List[int]:
        out = set(self.broker_rack)
        for reps in self.assignment.values():
            out.update(reps)
        return sorted(out)


class MetadataClient:
    """SPI: where topology snapshots come from."""

    def refresh(self) -> ClusterTopology:
        raise NotImplementedError


class CachingMetadataClient(MetadataClient):
    """Shared metadata.max.age.ms caching: subclasses implement
    ``_refresh()``; ``invalidate()`` drops the cache (the facade calls it
    after every execution so post-move reads see the new placement)."""

    def __init__(self, max_age_ms: int = 0):
        self.max_age_ms = max_age_ms
        self._cached: Optional[ClusterTopology] = None
        self._cached_at_ms = 0

    def invalidate(self) -> None:
        self._cached = None

    def refresh(self) -> ClusterTopology:
        import time as _time

        if self.max_age_ms > 0 and self._cached is not None:
            if _time.time() * 1000 - self._cached_at_ms < self.max_age_ms:
                return self._cached
        topo = self._refresh()
        if self.max_age_ms > 0:
            self._cached = topo
            self._cached_at_ms = int(_time.time() * 1000)
        return topo

    def _refresh(self) -> ClusterTopology:
        raise NotImplementedError


class StaticMetadataClient(MetadataClient):
    def __init__(self, topology: ClusterTopology):
        self.topology = topology

    def refresh(self) -> ClusterTopology:
        return self.topology


class BackendMetadataClient(CachingMetadataClient):
    """Reads topology straight from a cluster backend (the simulated cluster
    or a real admin adapter), so monitor and executor see one world."""

    def __init__(self, backend, broker_rack: Dict[int, int],
                 partition_topic: Optional[Dict[int, str]] = None,
                 max_age_ms: int = 0):
        super().__init__(max_age_ms=max_age_ms)
        self.backend = backend
        self.broker_rack = broker_rack
        self.partition_topic = partition_topic or {}

    def _refresh(self) -> ClusterTopology:
        assignment = {
            p: list(st.replicas) for p, st in self.backend.partitions.items()
        }
        leaders = {p: st.leader for p, st in self.backend.partitions.items()}
        probe = getattr(self.backend, "offline_replicas", None)
        degraded = getattr(self.backend, "degraded_brokers", None)
        dirs = getattr(self.backend, "replica_dir", None)
        off_dirs = getattr(self.backend, "offline_log_dirs", None)
        return ClusterTopology(
            assignment=assignment,
            leaders=leaders,
            broker_rack=self.broker_rack,
            partition_topic={
                p: self.partition_topic.get(p, "topic_0") for p in assignment
            },
            alive_brokers=self.backend.alive_brokers(),
            offline_replicas=probe() if probe is not None else None,
            degraded_brokers=degraded() if degraded is not None else None,
            replica_dirs=dict(dirs) if dirs else None,
            offline_dirs=off_dirs() if off_dirs is not None else None,
        )


class LoadMonitor:
    """Aggregates samples and generates models on demand."""

    def __init__(
        self,
        metadata: MetadataClient,
        sampler: MetricSampler,
        capacity_resolver: Optional[BrokerCapacityConfigResolver] = None,
        sample_store: Optional[SampleStore] = None,
        window_ms: int = 3_600_000,
        num_windows: int = 5,
        min_samples_per_window: int = 1,
        max_allowed_extrapolations: int = 5,
        capacity_estimation_percentile: float = 0.0,
        skip_loading_samples: bool = False,
        sample_validator: Optional[SampleValidator] = None,
    ):
        self.metadata = metadata
        self.sampler = sampler
        #: the data-integrity front door (ISSUE 13): every ingested batch
        #: passes validation before it can touch the aggregate tensors.
        #: Default-on with the conservative config (finiteness / sign /
        #: metadata-membership checks only); None disables the stage.
        self.sample_validator = (
            sample_validator if sample_validator is not None
            else SampleValidator()
        )
        self.capacity_resolver = capacity_resolver or StaticCapacityResolver(
            {Resource.CPU: 100.0, Resource.NW_IN: 1e5, Resource.NW_OUT: 1e5,
             Resource.DISK: 1e6}
        )
        self.sample_store = sample_store or NoopSampleStore()
        self.window_ms = window_ms
        self.max_allowed_extrapolations = max_allowed_extrapolations
        #: > 0 ⇒ built models carry the per-window load series and capacity
        #: goals estimate at this percentile over windows (upstream
        #: model/Load.java window semantics; 0 keeps mean-only models)
        self.capacity_estimation_percentile = capacity_estimation_percentile
        self.state = LoadMonitorState.NOT_STARTED
        self._model_semaphore = InstrumentedSemaphore(
            1, name="model.semaphore")
        self._last_sample_ms = 0

        topo = metadata.refresh()
        num_p = topo.num_partitions
        num_b = (max(topo.broker_ids()) + 1) if topo.broker_ids() else 0
        self.partition_aggregator = MetricSampleAggregator(
            PARTITION_DEF, num_p, window_ms, num_windows,
            min_samples_per_window,
        )
        self.broker_aggregator = MetricSampleAggregator(
            BROKER_DEF, num_b, window_ms, num_windows, min_samples_per_window,
        )
        if not skip_loading_samples:
            self._startup_load()
        self.state = LoadMonitorState.RUNNING

    # ---- lifecycle --------------------------------------------------------------
    def _startup_load(self) -> None:
        """Replay persisted samples (upstream LOADING state, §5.4)."""
        self.state = LoadMonitorState.LOADING
        psamples, bsamples = self.sample_store.load_samples()
        if psamples:
            self.partition_aggregator.ensure_entities(
                max(s.partition for s in psamples) + 1
            )
        if bsamples:
            self.broker_aggregator.ensure_entities(
                max(s.broker_id for s in bsamples) + 1
            )
        for s in psamples:
            self.partition_aggregator.add_sample(s.partition, s.time_ms, s.values)
        for s in bsamples:
            self.broker_aggregator.add_sample(s.broker_id, s.time_ms, s.values)
        if psamples or bsamples:
            self._last_sample_ms = max(
                [s.time_ms for s in psamples] + [s.time_ms for s in bsamples]
            )
            _LOG.info(
                "sample-store replay: %d partition / %d broker samples "
                "(latest %d ms)", len(psamples), len(bsamples),
                self._last_sample_ms,
            )

    def pause_sampling(self) -> None:
        _LOG.info("sampling paused")
        self.state = LoadMonitorState.PAUSED

    def resume_sampling(self) -> None:
        if self.state == LoadMonitorState.PAUSED:
            _LOG.info("sampling resumed")
            self.state = LoadMonitorState.RUNNING

    def ingest_samples(self, psamples, bsamples, now_ms: int) -> int:
        """Aggregate + persist one batch of samples (shared by the single-
        sampler iteration below and the MetricFetcherManager fetcher pool).

        The validation stage runs first: non-finite / negative /
        metadata-unknown (and, when configured, stale / spiking) samples
        are quarantined — journaled as ``monitor.sample_quarantined``,
        counted per reason, and NEVER aggregated or persisted (a
        quarantined sample must not come back via sample-store replay).
        Clean batches pass through bit-identically.  Quarantine also
        stops phantom entity growth: a stale reporter still emitting for
        a removed broker no longer widens the aggregate tensors."""
        if self.state == LoadMonitorState.PAUSED:
            return 0
        validator = self.sample_validator
        if validator is not None and validator.config.enabled \
                and (psamples or bsamples):
            topo = self.metadata.refresh()
            psamples, bsamples, report = validator.validate(
                psamples, bsamples,
                known_brokers=set(topo.broker_ids()),
                known_partitions=set(topo.assignment),
                now_ms=now_ms,
            )
            if report is not None:
                _LOG.warning(
                    "quarantined %d/%d samples: %s",
                    report.quarantined,
                    report.quarantined + report.accepted, report.reasons,
                )
                events.emit(
                    "monitor.sample_quarantined", severity="WARNING",
                    accepted=report.accepted,
                    quarantined=report.quarantined,
                    reasons=report.reasons,
                    brokers=report.brokers,
                    partitions=report.partitions,
                )
        prev_state, self.state = self.state, LoadMonitorState.SAMPLING
        try:
            if psamples:
                self.partition_aggregator.ensure_entities(
                    max(s.partition for s in psamples) + 1
                )
            if bsamples:
                self.broker_aggregator.ensure_entities(
                    max(s.broker_id for s in bsamples) + 1
                )
            for s in psamples:
                self.partition_aggregator.add_sample(
                    s.partition, s.time_ms, s.values
                )
            for s in bsamples:
                self.broker_aggregator.add_sample(
                    s.broker_id, s.time_ms, s.values
                )
            self.sample_store.store_samples(psamples, bsamples)
            self._last_sample_ms = max(self._last_sample_ms, now_ms)
            return len(psamples) + len(bsamples)
        finally:
            self.state = prev_state

    def run_sampling_iteration(self, now_ms: int) -> int:
        """One fetcher pass (upstream MetricFetcherManager interval): pull
        samples in (last, now], aggregate, persist.  Returns #samples."""
        if self.state == LoadMonitorState.PAUSED:
            return 0
        psamples, bsamples = self.sampler.get_samples(
            self._last_sample_ms, now_ms
        )
        return self.ingest_samples(psamples, bsamples, now_ms)

    # ---- model generation -------------------------------------------------------
    def acquire_for_model_generation(
        self, timeout_s: Optional[float] = None
    ) -> "ModelGenerationLock":
        """Upstream ``acquireForModelGeneration`` semaphore.  ``timeout_s``
        bounds the acquire wait (request-deadline propagation); None keeps
        the 60s default."""
        return ModelGenerationLock(
            self._model_semaphore,
            timeout_s=60.0 if timeout_s is None else timeout_s,
        )

    def model_generation(self) -> str:
        """Coarse model-generation marker the proposal cache keys on:
        bumps when a new metric window opens or the partition universe
        grows — NOT on every sample (the per-sample aggregator generation
        would mark every cached plan stale within one sampling interval).
        Topology changes the windows can't see (broker death) reach the
        cache through the detector-anomaly invalidation hook instead."""
        agg = self.partition_aggregator
        return f"w{agg.window_generation}.e{agg.num_entities}"

    def observed_total_ingress(self) -> float:
        """Cluster-wide leader ingress (KB/s) from the newest window's
        latest samples — one O(P) probe, no model build.  The proactive
        forecaster's sample feed: it only needs a stable load-shaped
        scalar to fit the diurnal curve against, not a complete model."""
        agg = self.partition_aggregator
        m = agg.metric_def.metric_info("LEADER_BYTES_IN")
        return agg.latest_window_total(m.metric_id)

    def cluster_model(
        self,
        requirements: Optional[ModelCompletenessRequirements] = None,
    ) -> ClusterState:
        """Build a ClusterState from current topology + aggregated loads."""
        from cruise_control_tpu_torch.telemetry import tracing

        with tracing.span("monitor.cluster_model") as sp:
            state = self._cluster_model(requirements)
            sp.set("brokers", state.num_brokers)
            sp.set("partitions", state.num_partitions)
            return state

    def _aggregated_means(
        self, req: ModelCompletenessRequirements, topo: ClusterTopology
    ):
        """Shared aggregation front half of both model builds: enforce
        completeness, collapse valid windows to per-partition mean loads.
        Returns ``(mean_vals [max_pid, M], agg, wsel)``."""
        # completeness is scored over the topology's partition universe, not
        # the raw entity axis — sparse keys (deleted partitions) leave hole
        # entities in the aggregator that must not count as missing data
        interested = [
            p for p in sorted(topo.assignment)
            if p < self.partition_aggregator.num_entities
        ]
        agg = self.partition_aggregator.aggregate(AggregationOptions(
            min_valid_entity_ratio=req.min_monitored_partitions_ratio,
            max_allowed_extrapolations=self.max_allowed_extrapolations,
            interested_entities=interested,
        ))
        comp = agg.completeness
        if comp.num_valid_windows < req.min_required_num_windows:
            raise NotEnoughValidWindowsError(
                f"{comp.num_valid_windows} valid windows < required "
                f"{req.min_required_num_windows}"
            )
        if comp.valid_entity_ratio < req.min_monitored_partitions_ratio:
            raise NotEnoughValidWindowsError(
                f"monitored-partition ratio {comp.valid_entity_ratio:.3f} < "
                f"required {req.min_monitored_partitions_ratio}"
            )

        # mean over valid windows per partition → one load vector each
        wsel = (np.array(comp.valid_window_indices, int)
                if comp.valid_window_indices else np.arange(agg.values.shape[1]))
        if wsel.size:
            mean_vals = agg.values[:, wsel, :].mean(axis=1)  # [P, M]
        else:
            mean_vals = np.zeros((topo.num_partitions, PARTITION_DEF.num_metrics))
        # topology may have grown past the aggregate (brand-new partitions
        # with no samples yet), and partition keys may be sparse after
        # deletions — mean_vals is indexed by the raw external key, so pad to
        # max key + 1, not to the partition count
        max_pid = max(topo.assignment, default=-1) + 1
        if mean_vals.shape[0] < max_pid:
            pad = np.zeros((max_pid - mean_vals.shape[0], mean_vals.shape[1]))
            mean_vals = np.concatenate([mean_vals, pad], axis=0)
        return mean_vals, agg, wsel

    def _cluster_model(
        self,
        requirements: Optional[ModelCompletenessRequirements] = None,
    ) -> ClusterState:
        req = requirements or ModelCompletenessRequirements()
        topo = self.metadata.refresh()
        mean_vals, agg, wsel = self._aggregated_means(req, topo)

        builder = ClusterModelBuilder()
        broker_index: Dict[int, int] = {}
        #: broker → {dir name → disk index} for replica_disk resolution
        dir_index: Dict[int, Dict[str, int]] = {}
        alive = topo.alive_brokers
        from cruise_control_tpu_torch.common.resources import BrokerState
        for b in topo.broker_ids():
            info = self.capacity_resolver.capacity_for_broker(b)
            state = (BrokerState.ALIVE if alive is None or b in alive
                     else BrokerState.DEAD)
            disks = None
            if info.disk_capacities:
                off = set((topo.offline_dirs or {}).get(b, ()))
                disks = [
                    (name, mb, name in off)
                    for name, mb in sorted(info.disk_capacities.items())
                ]
                dir_index[b] = {name: i for i, (name, _, _) in enumerate(disks)}
            broker_index[b] = builder.add_broker(
                topo.broker_rack.get(b, 0), info.capacity, state, broker_id=b,
                disks=disks,
            )
        for p in sorted(topo.assignment):
            replicas = topo.assignment[p]
            leader = topo.leaders[p]
            lead_slot = replicas.index(leader) if leader in replicas else 0
            load = np.zeros(NUM_RESOURCES, np.float32)
            load[Resource.CPU] = mean_vals[p, P_CPU]
            load[Resource.NW_IN] = mean_vals[p, P_NW_IN]
            load[Resource.NW_OUT] = mean_vals[p, P_NW_OUT]
            load[Resource.DISK] = mean_vals[p, P_DISK]
            follower = load.copy()
            follower[Resource.NW_OUT] = 0.0
            follower[Resource.CPU] = load[Resource.CPU] * FOLLOWER_CPU_RATIO
            off_brokers = (topo.offline_replicas or {}).get(p, ())
            disks = None
            if dir_index:
                disks = [
                    dir_index.get(b, {}).get(
                        (topo.replica_dirs or {}).get((p, b)), -1
                    )
                    for b in replicas
                ]
            builder.add_partition(
                topic=topo.partition_topic.get(p, "topic_0"),
                brokers=[broker_index[b] for b in replicas],
                leader_load=load,
                follower_load=follower,
                leader_slot=lead_slot,
                partition_id=p,
                offline=[b in off_brokers for b in replicas],
                disks=disks,
            )
        state = builder.build()
        if self.capacity_estimation_percentile > 0 and wsel.size:
            # carry the per-window series into the model (upstream
            # model/Load.java): [P, W, R] in the state's dense partition
            # order, follower series derived the same way as the mean
            max_pid = max(topo.assignment, default=-1) + 1
            vals = agg.values[:, wsel, :]                    # [E, W, M]
            if vals.shape[0] < max_pid:
                vals = np.concatenate(
                    [vals, np.zeros((max_pid - vals.shape[0],) + vals.shape[1:])],
                    axis=0,
                )
            W = vals.shape[1]
            P = state.num_partitions
            lw = np.zeros((P, W, NUM_RESOURCES), np.float32)
            ext = state.partition_ids or tuple(range(P))
            v = vals[np.asarray(ext, int)]                   # [P, W, M]
            lw[:, :, Resource.CPU] = v[:, :, P_CPU]
            lw[:, :, Resource.NW_IN] = v[:, :, P_NW_IN]
            lw[:, :, Resource.NW_OUT] = v[:, :, P_NW_OUT]
            lw[:, :, Resource.DISK] = v[:, :, P_DISK]
            fw = lw.copy()
            fw[:, :, Resource.NW_OUT] = 0.0
            fw[:, :, Resource.CPU] *= FOLLOWER_CPU_RATIO
            state = state.replace(
                leader_load_windows=lw,
                follower_load_windows=fw,
                capacity_percentile=self.capacity_estimation_percentile,
            )
        return state

    # ---- delta model build (incremental re-optimization) ------------------------
    def aggregation_mark(self) -> int:
        """Aggregator generation to remember alongside a model snapshot —
        ``cluster_model_delta`` diffs dirty entities against it."""
        return self.partition_aggregator.generation

    def cluster_model_delta(
        self,
        prev_state: ClusterState,
        prev_mark: int,
        requirements: Optional[ModelCompletenessRequirements] = None,
        prev_generation: str = "",
        rel_threshold: float = 0.05,
        abs_floor: float = 1e-6,
    ):
        """Build the next model by PATCHING ``prev_state``'s arrays, and
        report what changed as a structured :class:`ModelDelta`.

        The contract the warm-start path leans on: when ``delta.full`` is
        False, every row NOT marked dirty is bit-identical to the previous
        model (loads below ``rel_threshold`` relative drift keep the
        previous values), so resident device tables only need the dirty
        rows re-uploaded.  Structural drift the patch cannot express —
        partition-universe changes, RF growth, broker reindexing, JBOD /
        window-series models — degrades to the full builder with the
        reason recorded.  Completeness requirements are enforced exactly
        as in :meth:`cluster_model`.
        """
        from cruise_control_tpu_torch.common.resources import (
            EMPTY_SLOT,
            BrokerState,
        )
        from cruise_control_tpu_torch.replan.delta import ModelDelta

        req = requirements or ModelCompletenessRequirements()
        gen = self.model_generation()

        def full(reason: str):
            state = self._cluster_model(requirements)
            return state, ModelDelta(
                generation=gen, prev_generation=prev_generation,
                full=True, reason=reason,
            )

        if (
            prev_state.has_disks
            or prev_state.leader_load_windows is not None
            or self.capacity_estimation_percentile > 0
        ):
            return full("unsupported-model-features")
        topo = self.metadata.refresh()
        P, S = prev_state.num_partitions, prev_state.max_replication_factor
        ext_p = list(prev_state.partition_ids or range(P))
        if sorted(topo.assignment) != sorted(ext_p):
            return full("partition-universe-changed")
        if max((len(r) for r in topo.assignment.values()), default=1) > S:
            return full("replication-factor-grew")
        prev_b = list(prev_state.broker_ids or range(prev_state.num_brokers))
        new_b = topo.broker_ids()
        if new_b[: len(prev_b)] != prev_b:
            # an insert in the middle shifts every internal index — the
            # previous placement arrays no longer mean the same brokers
            return full("broker-axis-reindexed")
        added = tuple(new_b[len(prev_b):])
        if added and any(
            isinstance(topo.broker_rack.get(b), str) for b in added
        ):
            # string rack names densify through the builder's private
            # name→id table, which the patch path cannot reconstruct
            return full("added-broker-needs-rack-densification")
        B = len(new_b)

        mean_vals, _agg, _wsel = self._aggregated_means(req, topo)

        # ---- load diff (vectorized, narrowed by the aggregator's dirty set)
        idx = np.asarray(ext_p, int)
        mv = mean_vals[idx]                                  # [P, M]
        new_load = np.zeros((P, NUM_RESOURCES), np.float32)
        new_load[:, Resource.CPU] = mv[:, P_CPU]
        new_load[:, Resource.NW_IN] = mv[:, P_NW_IN]
        new_load[:, Resource.NW_OUT] = mv[:, P_NW_OUT]
        new_load[:, Resource.DISK] = mv[:, P_DISK]
        prev_load = np.asarray(prev_state.leader_load, np.float32)
        scale = np.maximum(np.abs(prev_load), abs_floor)
        load_dirty = np.any(
            np.abs(new_load - prev_load) > rel_threshold * scale, axis=1
        )
        # entities with no new sample AND no window eviction since the
        # previous build cannot have moved — the value diff above already
        # says so, this just documents that the aggregator's dirty set is
        # a superset of the value diff
        candidates = self.partition_aggregator.dirty_entities_since(prev_mark)
        in_range = idx < candidates.shape[0]
        load_dirty &= np.where(in_range, candidates[np.minimum(
            idx, candidates.shape[0] - 1)], True)

        # ---- topology diff
        b_index = {e: i for i, e in enumerate(new_b)}
        new_assign = np.full((P, S), EMPTY_SLOT, np.int32)
        new_lslot = np.zeros(P, np.int32)
        for i, pid in enumerate(ext_p):
            reps = topo.assignment[pid]
            for s, b in enumerate(reps):
                new_assign[i, s] = b_index[b]
            leader = topo.leaders[pid]
            new_lslot[i] = reps.index(leader) if leader in reps else 0
        prev_assign = np.asarray(prev_state.assignment)
        prev_ls = np.asarray(prev_state.leader_slot)
        topo_dirty = (
            np.any(new_assign != prev_assign, axis=1)
            | (new_lslot != prev_ls)
        )

        # ---- broker diff
        alive = topo.alive_brokers
        new_bstate = np.array([
            int(BrokerState.ALIVE if alive is None or b in alive
                else BrokerState.DEAD)
            for b in new_b
        ], np.int8)
        prev_bstate = np.asarray(prev_state.broker_state, np.int8)

        # offline flags: dead-broker replicas + per-replica disk failures
        dead = (new_bstate == int(BrokerState.DEAD)) | (
            new_bstate == int(BrokerState.REMOVED)
        )
        exists = new_assign != EMPTY_SLOT
        new_off = exists & dead[np.clip(new_assign, 0, None)]
        pid_to_row = {pid: i for i, pid in enumerate(ext_p)}
        for pid, brokers in (topo.offline_replicas or {}).items():
            i = pid_to_row.get(pid)
            if i is None:
                continue
            for b in brokers:
                bi = b_index.get(b)
                if bi is None:
                    continue
                hits = np.nonzero(new_assign[i] == bi)[0]
                if hits.size:
                    new_off[i, hits[0]] = True
        prev_off = np.asarray(prev_state.replica_offline, bool)
        topo_dirty |= np.any(new_off != prev_off, axis=1)

        dirty_brokers = np.zeros(B, bool)
        n_prev = len(prev_b)
        dirty_brokers[:n_prev] = new_bstate[:n_prev] != prev_bstate
        dirty_brokers[n_prev:] = True
        prev_dead = (prev_bstate == int(BrokerState.DEAD)) | (
            prev_bstate == int(BrokerState.REMOVED)
        )
        removed = tuple(
            b for i, b in enumerate(prev_b)
            if dead[i] and not prev_dead[i]
        )

        # ---- patched state: untouched rows keep the previous bits
        dirty = load_dirty | topo_dirty
        add_cap = add_rack = None
        if added:
            from cruise_control_tpu_torch.models.builder import _resource_vec

            add_cap = np.stack([
                _resource_vec(self.capacity_resolver.capacity_for_broker(b)
                              .capacity)
                for b in added
            ])
            add_rack = np.array(
                [int(topo.broker_rack.get(b, 0)) for b in added], np.int32
            )
        from cruise_control_tpu_torch.models.builder import patch_cluster_state

        state = patch_cluster_state(
            prev_state,
            assignment=new_assign,
            leader_slot=new_lslot,
            replica_offline=new_off,
            load_dirty=load_dirty,
            new_leader_load=new_load,
            broker_state=new_bstate,
            broker_ids=new_b,
            added_capacity=add_cap,
            added_racks=add_rack,
        )
        delta = ModelDelta(
            generation=gen,
            prev_generation=prev_generation,
            full=False,
            dirty_partitions=dirty,
            dirty_topology=topo_dirty,
            dirty_brokers=dirty_brokers,
            added_brokers=added,
            removed_brokers=removed,
            topology_changed=bool(topo_dirty.any()),
            load_changed=bool(load_dirty.any()),
            shape_changed=bool(added),
        )
        return state, delta

    # ---- observability ----------------------------------------------------------
    def state_summary(self) -> dict:
        agg = self.partition_aggregator.aggregate()
        c = agg.completeness
        out = {
            "state": self.state.value,
            "numValidWindows": c.num_valid_windows,
            "numWindows": c.num_windows,
            "validPartitionRatio": round(c.valid_entity_ratio, 4),
            "lastSampleMs": self._last_sample_ms,
            "aggregatorGeneration": self.partition_aggregator.generation,
        }
        if self.sample_validator is not None:
            out["sampleValidation"] = self.sample_validator.state_summary()
        return out


class ModelGenerationLock:
    def __init__(self, sem: threading.Semaphore, timeout_s: float = 60.0):
        self._sem = sem
        self._timeout_s = timeout_s

    def __enter__(self):
        acquired = self._sem.acquire(timeout=self._timeout_s)
        if not acquired:
            raise RuntimeError("could not acquire model-generation semaphore")
        return self

    def __exit__(self, *exc):
        self._sem.release()
        return False

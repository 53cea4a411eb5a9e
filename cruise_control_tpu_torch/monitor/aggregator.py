"""Windowed metric-sample aggregation, tensor-first (upstream
``cruise-control-core`` ``MetricSampleAggregator`` / ``RawMetricValues`` /
``MetricSampleCompleteness`` / ``ValuesAndExtrapolations``; SURVEY.md §2.1).

The upstream aggregator keeps per-entity ring buffers of raw values and walks
them object-by-object.  Here the whole raw state is three dense arrays —
``sum/max/latest[W, E, M]`` plus ``counts[W, E]`` — so aggregation,
completeness and extrapolation are vectorized reductions over the window
axis, and the output loads straight into the model builder without a
per-entity loop.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.monitor.metric_defs import MetricDef


class Extrapolation(enum.Enum):
    """Per-entity window-fill technique (upstream ``Extrapolation.java``)."""

    NONE = "NONE"                     # window had enough real samples
    AVG_ADJACENT = "AVG_ADJACENT"     # mean of the two neighbor windows
    AVG_AVAILABLE = "AVG_AVAILABLE"   # mean of all this entity's valid windows
    NO_VALID_EXTRAPOLATION = "NO_VALID_EXTRAPOLATION"


@dataclasses.dataclass
class AggregationOptions:
    """Upstream ``AggregationOptions``: what makes the aggregate usable."""

    min_valid_entity_ratio: float = 0.95
    min_valid_entity_group_ratio: float = 0.0
    min_valid_windows: int = 1
    max_allowed_extrapolations: int = 5
    #: entities the caller insists on (upstream interested-entities set);
    #: None = all known entities
    interested_entities: Optional[Sequence[int]] = None


@dataclasses.dataclass
class MetricSampleCompleteness:
    valid_entity_ratio: float
    valid_window_indices: List[int]
    num_valid_windows: int
    num_windows: int

    @property
    def valid_window_ratio(self) -> float:
        return self.num_valid_windows / max(self.num_windows, 1)


@dataclasses.dataclass
class ValuesAndExtrapolations:
    """Aggregate output: ``values[E, W_valid, M]`` + per-entity-window
    extrapolation records + completeness."""

    values: np.ndarray                    # f32 [E, W, M]
    window_times: np.ndarray              # int64 [W] window start ms
    entity_valid: np.ndarray              # bool [E]
    extrapolations: Dict[int, Dict[int, Extrapolation]]  # entity → window → how
    completeness: MetricSampleCompleteness


class MetricSampleAggregator:
    """Rolling-window aggregator for one entity class (partitions or
    brokers).  Entities are dense integer ids ``0..num_entities-1``."""

    def __init__(
        self,
        metric_def: MetricDef,
        num_entities: int,
        window_ms: int,
        num_windows: int,
        min_samples_per_window: int = 1,
    ):
        self.metric_def = metric_def
        self.num_entities = num_entities
        self.window_ms = int(window_ms)
        self.num_windows = int(num_windows)
        self.min_samples_per_window = int(min_samples_per_window)
        M = metric_def.num_metrics
        # ring over window slots; _window_index[i] = absolute window of slot i
        W = self.num_windows + 1  # +1 = the in-progress window
        self._sum = np.zeros((W, num_entities, M), np.float64)
        self._max = np.full((W, num_entities, M), -np.inf, np.float64)
        self._latest_val = np.zeros((W, num_entities, M), np.float64)
        self._latest_ts = np.full((W, num_entities), -1, np.int64)
        self._count = np.zeros((W, num_entities), np.int64)
        self._window_index = np.full(W, -1, np.int64)
        self._first_window = -1  # earliest absolute window ever observed
        self._generation = 0
        # ---- dirty tracking (delta replan) ----------------------------------
        #: per-entity generation of the last accepted sample — consumers
        #: diff against a remembered generation mark to get the entities
        #: whose raw data changed since (O(E) compare, no mutation, so any
        #: number of consumers can hold independent marks)
        self._entity_touch_gen = np.zeros(num_entities, np.int64)
        #: generation of the last window eviction.  An eviction changes the
        #: window set, which shifts EVERY entity's mean — consumers seeing
        #: ``eviction_generation > mark`` must treat all entities as
        #: candidates, not just the sample-touched ones.
        self._eviction_gen = 0

    # ---- ingest -----------------------------------------------------------------
    def ensure_entities(self, num_entities: int) -> None:
        """Grow the entity axis (topics/brokers can appear after startup;
        upstream handles this by keying maps on the entity object)."""
        if num_entities <= self.num_entities:
            return
        extra = num_entities - self.num_entities
        W = self.num_windows + 1
        M = self.metric_def.num_metrics
        self._sum = np.concatenate(
            [self._sum, np.zeros((W, extra, M))], axis=1)
        self._max = np.concatenate(
            [self._max, np.full((W, extra, M), -np.inf)], axis=1)
        self._latest_val = np.concatenate(
            [self._latest_val, np.zeros((W, extra, M))], axis=1)
        self._latest_ts = np.concatenate(
            [self._latest_ts, np.full((W, extra), -1, np.int64)], axis=1)
        self._count = np.concatenate(
            [self._count, np.zeros((W, extra), np.int64)], axis=1)
        self.num_entities = num_entities
        self._generation += 1
        # brand-new entities are dirty by construction
        self._entity_touch_gen = np.concatenate([
            self._entity_touch_gen,
            np.full(extra, self._generation, np.int64),
        ])

    def _slot_for(self, abs_window: int) -> Optional[int]:
        hits = np.nonzero(self._window_index == abs_window)[0]
        if hits.size:
            return int(hits[0])
        oldest_allowed = int(self._window_index.max()) - self.num_windows
        if abs_window < max(oldest_allowed, 0):
            return None  # too old — sample dropped (upstream: out of range)
        slot = int(abs_window % (self.num_windows + 1))
        # evict whatever cycled out of range
        self._window_index[slot] = abs_window
        self._sum[slot] = 0.0
        self._max[slot] = -np.inf
        self._latest_val[slot] = 0.0
        self._latest_ts[slot] = -1
        self._count[slot] = 0
        self._generation += 1
        self._eviction_gen = self._generation
        return slot

    def add_sample(
        self, entity: int, timestamp_ms: int, values: Sequence[float]
    ) -> bool:
        """Record one sample; returns False if it fell outside retention
        or carried a non-finite value (defense in depth behind the
        monitor's quarantine stage — one NaN in ``_sum`` poisons every
        mean/extrapolation computed from that window forever, so the
        raw-state tensors refuse it even when a caller skips
        validation)."""
        abs_window = int(timestamp_ms) // self.window_ms
        v = np.asarray(values, np.float64)
        if not np.isfinite(v).all():
            return False
        slot = self._slot_for(abs_window)
        if slot is None:
            return False
        if self._first_window < 0 or abs_window < self._first_window:
            self._first_window = abs_window
        self._sum[slot, entity] += v
        self._max[slot, entity] = np.maximum(self._max[slot, entity], v)
        if timestamp_ms >= self._latest_ts[slot, entity]:
            self._latest_val[slot, entity] = v
            self._latest_ts[slot, entity] = timestamp_ms
        self._count[slot, entity] += 1
        self._generation += 1
        self._entity_touch_gen[entity] = self._generation
        return True

    def add_samples_batch(
        self,
        entities: np.ndarray,
        timestamps_ms: np.ndarray,
        values: np.ndarray,
    ) -> int:
        """Vectorized ingest of many samples (columns aligned); returns the
        number accepted."""
        accepted = 0
        for e, t, v in zip(entities, timestamps_ms, values):
            accepted += bool(self.add_sample(int(e), int(t), v))
        return accepted

    def latest_window_total(self, metric_id: int) -> float:
        """Sum of the newest window's latest per-entity values for one
        metric — an O(E) probe (no aggregation pass) for consumers that
        only need a load-shaped scalar, e.g. the proactive forecaster."""
        if (self._window_index < 0).all():
            return 0.0
        slot = int(np.argmax(self._window_index))
        return float(self._latest_val[slot, :, metric_id].sum())

    # ---- aggregate --------------------------------------------------------------
    def _completed_windows(self) -> List[int]:
        """Absolute indices of completed windows — the CONTIGUOUS range from
        the oldest retained window up to (excluding) the newest, so a window
        no sample ever landed in still exists (as all-invalid) rather than
        silently vanishing from completeness accounting."""
        if self._first_window < 0:
            return []
        newest = int(self._window_index.max())
        lo = max(newest - self.num_windows, self._first_window)
        return list(range(lo, newest)) or [newest]

    def aggregate(
        self, options: Optional[AggregationOptions] = None
    ) -> ValuesAndExtrapolations:
        """Aggregate all completed windows → ``ValuesAndExtrapolations``.

        Vectorized: per-window per-entity validity from counts; invalid
        windows filled by AVG_ADJACENT then AVG_AVAILABLE; entities whose
        extrapolation count exceeds the allowance are flagged invalid.
        """
        opts = options or AggregationOptions()
        abs_windows = self._completed_windows()
        M = self.metric_def.num_metrics
        E = self.num_entities
        W = len(abs_windows)
        is_avg, is_max = self.metric_def.aggregation_matrix()
        values = np.zeros((E, W, M), np.float32)
        window_times = np.asarray(abs_windows, np.int64) * self.window_ms
        slot_of = {
            int(w): s for s, w in enumerate(self._window_index) if w >= 0
        }
        counts = np.zeros((W, E), np.int64)
        sums = np.zeros((W, E, M), np.float64)
        maxs = np.full((W, E, M), -np.inf, np.float64)
        latest = np.zeros((W, E, M), np.float64)
        for i, aw in enumerate(abs_windows):
            s = slot_of.get(aw)
            if s is not None:
                counts[i] = self._count[s]
                sums[i] = self._sum[s]
                maxs[i] = self._max[s]
                latest[i] = self._latest_val[s]
        valid = counts >= self.min_samples_per_window   # [W, E]

        if W:
            cnt = np.maximum(counts, 1)[:, :, None]
            avg = sums / cnt
            agg = np.where(is_avg[None, None, :], avg, latest)
            mx = np.where(maxs == -np.inf, 0.0, maxs)
            agg = np.where(is_max[None, None, :], mx, agg)
            values = np.transpose(agg, (1, 0, 2)).astype(np.float32)  # [E, W, M]

        extrapolations: Dict[int, Dict[int, Extrapolation]] = {}
        entity_valid = np.ones(E, bool)
        if W:
            validEW = valid.T                            # [E, W]
            any_valid = validEW.any(axis=1)
            # AVG_AVAILABLE fill value per entity
            safe = np.where(validEW[:, :, None], values, 0.0)
            n_valid = np.maximum(validEW.sum(axis=1), 1)[:, None]
            avg_available = safe.sum(axis=1) / n_valid   # [E, M]
            for e in np.nonzero(~validEW.all(axis=1))[0]:
                e = int(e)
                recs: Dict[int, Extrapolation] = {}
                for w in np.nonzero(~validEW[e])[0]:
                    w = int(w)
                    neighbors = [
                        x for x in (w - 1, w + 1) if 0 <= x < W and validEW[e, x]
                    ]
                    if neighbors:
                        values[e, w] = values[e, neighbors].mean(axis=0)
                        recs[w] = Extrapolation.AVG_ADJACENT
                    elif any_valid[e]:
                        values[e, w] = avg_available[e]
                        recs[w] = Extrapolation.AVG_AVAILABLE
                    else:
                        recs[w] = Extrapolation.NO_VALID_EXTRAPOLATION
                extrapolations[e] = recs
                n_extrap = sum(
                    1 for r in recs.values()
                    if r != Extrapolation.NO_VALID_EXTRAPOLATION
                )
                bad = any(
                    r == Extrapolation.NO_VALID_EXTRAPOLATION
                    for r in recs.values()
                )
                if bad or n_extrap > opts.max_allowed_extrapolations:
                    entity_valid[e] = False

        if opts.interested_entities is not None:
            mask = np.zeros(E, bool)
            mask[list(opts.interested_entities)] = True
            ratio_pool = mask
        else:
            ratio_pool = np.ones(E, bool)
        pool_n = max(int(ratio_pool.sum()), 1)
        valid_entity_ratio = float((entity_valid & ratio_pool).sum()) / pool_n

        # a window is valid when enough interested entities have real or
        # extrapolated coverage in it (upstream: per-window valid-entity
        # ratio against min_valid_entity_ratio — one brand-new partition
        # must not invalidate the whole window)
        covered = np.ones((E, W), bool)
        for e, recs in extrapolations.items():
            for w, r in recs.items():
                if r == Extrapolation.NO_VALID_EXTRAPOLATION:
                    covered[e, w] = False
        if W:
            cov_ratio = (covered & ratio_pool[:, None]).sum(axis=0) / pool_n
            window_ok = cov_ratio >= opts.min_valid_entity_ratio
        else:
            window_ok = np.zeros(0, bool)
        completeness = MetricSampleCompleteness(
            valid_entity_ratio=valid_entity_ratio,
            valid_window_indices=[int(i) for i in np.nonzero(window_ok)[0]],
            num_valid_windows=int(window_ok.sum()),
            num_windows=W,
        )
        return ValuesAndExtrapolations(
            values=values,
            window_times=np.asarray(window_times, np.int64),
            entity_valid=entity_valid,
            extrapolations=extrapolations,
            completeness=completeness,
        )

    @property
    def generation(self) -> int:
        """Monotonic state version (upstream aggregator generation)."""
        return self._generation

    @property
    def eviction_generation(self) -> int:
        """Generation of the last window eviction (0 = never).  Past a
        consumer's mark, window means may have shifted for entities no new
        sample touched — the dirty set must widen to every entity."""
        return self._eviction_gen

    def dirty_entities_since(self, generation_mark: int) -> np.ndarray:
        """bool [E] — entities whose raw samples changed after the mark.
        When a window eviction happened after the mark this is all-True
        (the roll moved every mean); otherwise exactly the sample-touched
        set.  The delta-replan monitor narrows this candidate set further
        by value-diffing against the previous model's loads."""
        if self._eviction_gen > generation_mark:
            return np.ones(self.num_entities, bool)
        return self._entity_touch_gen > generation_mark

    @property
    def window_generation(self) -> int:
        """Latest absolute metric window observed (-1 before any sample).
        Window-granular where ``generation`` is per-sample — the model
        generation the proposal cache keys on."""
        return int(self._window_index.max(initial=-1))

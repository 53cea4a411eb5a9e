"""Seeded time-varying workload synthesis for scenario runs.

Wraps the real :class:`~cruise_control_tpu_torch.monitor.sampling.WorkloadModel`
ground truth that :class:`SimulatedMetricsReporter` observes, and re-derives
its per-partition rates every virtual tick from three deterministic terms:

* a **diurnal** sine (amplitude/period knobs — load breathes like a real
  day/night traffic curve),
* a linear **drift** per virtual hour (organic growth),
* a per-partition **skew** multiplier vector the timeline's
  ``hot_partition_skew`` events compound into.

Because the same WorkloadModel object feeds the reporter, every sample the
monitor ingests flows through the real pipeline — processor, aggregator,
windows — with zero mocking of the system under test.  Topology (assignment
/ leaders) is re-synced from the scripted backend each tick, so load follows
partitions wherever the executor moves them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.monitor.sampling import WorkloadModel

#: the synthesizer's load floor: the diurnal trough + drift can never push
#: the multiplier below this (a cluster is never fully idle)
MIN_MULTIPLIER = 0.05


def diurnal_multiplier(
    now_ms: float,
    amplitude: float,
    period_ms: int,
    drift_per_hour: float = 0.0,
) -> float:
    """The synthesizer's exact load multiplier at virtual time ``now_ms``.

    This is THE formula — :meth:`ScenarioWorkload.advance` applies it
    verbatim (bit-identity contract: extracting it must not move a single
    float op), and the proactive scheduler's forecast projects it forward.
    """
    phase = math.sin(2.0 * math.pi * now_ms / period_ms)
    mult = (1.0 + amplitude * phase
            + drift_per_hour * (now_ms / 3_600_000.0))
    return max(mult, MIN_MULTIPLIER)


@dataclasses.dataclass(frozen=True)
class DiurnalForecast:
    """A fitted diurnal load model: ``level(t) = mean + a·sin(ωt) +
    b·cos(ωt)`` with ``ω = 2π/period_ms``.

    Seed-stable by construction: :func:`fit_diurnal` is a closed-form
    least-squares solve over the caller's samples — same samples, same
    coefficients, bit for bit.  Shared by the sim (whose ground truth it
    recovers) and the proactive scheduler (which projects the next peak
    from observed monitor windows).
    """

    mean: float
    a: float
    b: float
    period_ms: int
    num_samples: int = 0

    @property
    def amplitude(self) -> float:
        """Relative swing of the fitted sine around its mean."""
        if self.mean <= 0.0:
            return 0.0
        return math.hypot(self.a, self.b) / self.mean

    def level_at(self, now_ms: float) -> float:
        w = 2.0 * math.pi * now_ms / self.period_ms
        return self.mean + self.a * math.sin(w) + self.b * math.cos(w)

    def multiplier_at(self, now_ms: float) -> float:
        """Projected load at ``now_ms`` relative to the fitted mean."""
        if self.mean <= 0.0:
            return 1.0
        return max(self.level_at(now_ms) / self.mean, MIN_MULTIPLIER)

    def peak_within(
        self, now_ms: float, horizon_ms: float, steps: int = 128
    ) -> Tuple[float, float]:
        """``(peak_time_ms, peak_multiplier)`` over ``[now, now+horizon]``.

        Deterministic coarse grid + the analytic sine crest when it falls
        inside the horizon — ties resolve to the earliest time.
        """
        candidates = [
            now_ms + horizon_ms * i / steps for i in range(steps + 1)
        ]
        # analytic crest: a·sin(ωt) + b·cos(ωt) = R·cos(ωt − ψ) with
        # ψ = atan2(a, b), so the maximum lands at ωt = ψ + 2πk
        crest = math.atan2(self.a, self.b)
        w = 2.0 * math.pi / self.period_ms
        t0 = crest / w
        k = math.ceil((now_ms - t0) / self.period_ms)
        t = t0 + k * self.period_ms
        if now_ms <= t <= now_ms + horizon_ms:
            candidates.append(t)
        best_t, best_m = now_ms, self.multiplier_at(now_ms)
        for t in candidates:
            m = self.multiplier_at(t)
            if m > best_m + 1e-12:
                best_t, best_m = t, m
        return best_t, best_m


def fit_diurnal(
    samples: Sequence[Tuple[float, float]],
    period_ms: int,
) -> Optional[DiurnalForecast]:
    """Least-squares fit of ``mean + a·sin(ωt) + b·cos(ωt)`` at the KNOWN
    period to observed ``(time_ms, load)`` samples.

    Returns None when the samples cannot pin the three coefficients
    (fewer than 4 points, or all at one instant).  Pure numpy normal
    equations — deterministic for identical inputs.
    """
    if len(samples) < 4:
        return None
    t = np.asarray([s[0] for s in samples], np.float64)
    y = np.asarray([s[1] for s in samples], np.float64)
    if float(t.max() - t.min()) <= 0.0:
        return None
    w = 2.0 * np.pi * t / float(period_ms)
    design = np.stack([np.ones_like(w), np.sin(w), np.cos(w)], axis=1)
    coef, *_ = np.linalg.lstsq(design, y, rcond=None)
    mean, a, b = (float(c) for c in coef)
    if not (math.isfinite(mean) and math.isfinite(a) and math.isfinite(b)):
        return None
    return DiurnalForecast(
        mean=mean, a=a, b=b, period_ms=int(period_ms),
        num_samples=len(samples),
    )


class ScenarioWorkload:
    """Deterministic load synthesis over a generated cluster state."""

    def __init__(
        self,
        state: ClusterState,
        diurnal_amplitude: float = 0.2,
        diurnal_period_ms: int = 7_200_000,
        drift_per_hour: float = 0.0,
    ):
        a = np.array(state.assignment)
        lslot = np.array(state.leader_slot)
        assignment = {
            p: [int(b) for b in a[p] if b >= 0] for p in range(a.shape[0])
        }
        leaders = {p: int(a[p, lslot[p]]) for p in range(a.shape[0])}
        load = np.array(state.leader_load, np.float64)
        self._base_in = load[:, Resource.NW_IN].copy()
        self._base_out = load[:, Resource.NW_OUT].copy()
        self._base_size = load[:, Resource.DISK].copy()
        self._skew = np.ones(a.shape[0], np.float64)
        self.diurnal_amplitude = diurnal_amplitude
        self.diurnal_period_ms = max(1, int(diurnal_period_ms))
        self.drift_per_hour = drift_per_hour
        self.model = WorkloadModel(
            bytes_in=self._base_in.copy(),
            bytes_out=self._base_out.copy(),
            size_mb=self._base_size.copy(),
            assignment=assignment,
            leaders=leaders,
        )

    def add_partitions(self, count: int, bytes_in: float = 1.0,
                       bytes_out: float = 1.0, size_mb: float = 1.0) -> None:
        """Grow the ground-truth arrays for ``count`` newly created
        partitions (timeline ``create_topic``) — modest default load so a
        mid-scenario topic doesn't perturb capacity headroom.  Topology
        for the new ids arrives via the next :meth:`sync_topology`."""
        n = max(0, int(count))
        if n == 0:
            return
        self._base_in = np.append(self._base_in, np.full(n, float(bytes_in)))
        self._base_out = np.append(self._base_out,
                                   np.full(n, float(bytes_out)))
        self._base_size = np.append(self._base_size,
                                    np.full(n, float(size_mb)))
        self._skew = np.append(self._skew, np.ones(n))

    def apply_skew(self, partitions: Sequence[int], factor: float) -> None:
        """Compound a skew multiplier onto a partition subset (timeline
        ``hot_partition_skew``); the load follows the partitions through
        every subsequent rebalance."""
        idx = np.asarray(list(partitions), int)
        self._skew[idx] *= float(factor)

    def advance(self, now_ms: int) -> None:
        """Re-derive the observable rates for virtual time ``now_ms``."""
        mult = diurnal_multiplier(
            now_ms, self.diurnal_amplitude, self.diurnal_period_ms,
            self.drift_per_hour,
        )
        m = self.model
        m.bytes_in = self._base_in * mult * self._skew
        m.bytes_out = self._base_out * mult * self._skew
        # on-disk size tracks skew (hot partitions grow) but not the
        # diurnal breath — disk is an integral, not a rate
        m.size_mb = self._base_size * self._skew

    def observed_total_rate(self) -> float:
        """Total cluster bytes-in rate as of the last :meth:`advance` —
        the scalar load signal the proactive scheduler samples during
        scenario runs (production wires the monitor's model instead)."""
        return float(np.sum(self.model.bytes_in))

    def sync_topology(self, backend) -> None:
        """Mirror the scripted backend's current placement into the ground
        truth the brokers' metrics reporters observe."""
        self.model.assignment = {
            p: list(st.replicas) for p, st in backend.partitions.items()
        }
        self.model.leaders = {
            p: st.leader for p, st in backend.partitions.items()
        }

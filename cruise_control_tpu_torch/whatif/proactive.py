"""Forecast-driven proactive control — rebalance BEFORE the peak.

The reactive loop heals after a fault: detect → fix → settle.  This
scheduler closes the other half of ROADMAP item 5: it fits the workload
synthesizer's own diurnal model (:func:`sim.workload.fit_diurnal`) to
observed load samples, projects the next peak inside its horizon, asks
the what-if engine whether the cluster SURVIVES that peak (a
``traffic_scale`` future at the projected multiplier), and — when the
verdict says a goal breaks — triggers a full rebalance while there is
still headroom, journaled as ``proactive.*`` so an operator can
reconstruct why the cluster moved with no anomaly in sight.

Clock discipline: every decision takes ``now_ms`` (the sim drives a
virtual clock); production wiring injects nothing and the guarded
fallback reads wall time.  Skip decisions are journaled once per reason
change, not per tick — the journal records decisions, not idling.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.utils.logging import get_logger
from cruise_control_tpu_torch.whatif.futures import FutureSpec, traffic_scale

LOG = get_logger("whatif.proactive")


class ProactiveScheduler:
    """Projects the diurnal peak and pre-empts the breach.

    ``clock`` (→ milliseconds) makes every decision virtual-clock
    drivable; ``sample_fn`` is the production pull source (the sim
    pushes via :meth:`record` instead).
    """

    def __init__(
        self,
        cc,
        period_ms: int,
        horizon_ms: int = 3_600_000,
        threshold: float = 1.1,
        cooldown_ms: int = 1_800_000,
        min_samples: int = 8,
        max_samples: int = 512,
        sample_fn: Optional[Callable[[], float]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.cc = cc
        self.period_ms = max(1, int(period_ms))
        self.horizon_ms = max(1, int(horizon_ms))
        self.threshold = float(threshold)
        self.cooldown_ms = max(0, int(cooldown_ms))
        self.min_samples = max(4, int(min_samples))
        self._samples: deque = deque(maxlen=max(8, int(max_samples)))
        self._sample_fn = sample_fn
        self._clock = clock
        self._last_trigger_ms: Optional[float] = None
        self._last_skip_reason: Optional[str] = None
        self.triggers = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- clock + samples --------------------------------------------------------
    def _now_ms(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        return time.time() * 1000.0

    def record(self, now_ms: float, value: float) -> None:
        """Feed one observed ``(time, total load)`` sample."""
        self._samples.append((float(now_ms), float(value)))

    # ---- the decision -----------------------------------------------------------
    def _skip(self, reason: str) -> None:
        # journal transitions, not idle ticks: a 500-tick quiet stretch
        # is one record, and the fingerprint stays insensitive to length
        if reason != self._last_skip_reason:
            events.emit("proactive.skip", reason=reason)
            self._last_skip_reason = reason

    def maybe_trigger(self, now_ms: Optional[float] = None) -> bool:
        """One scheduling decision at ``now_ms``; True = a proactive
        rebalance was kicked off."""
        # import at use-site: the forecast API lives next to the workload
        # synthesizer it mirrors (sim/workload.py), and sim's package
        # import closes a cycle through the facade at module-import time
        from cruise_control_tpu_torch.sim.workload import fit_diurnal

        now_ms = self._now_ms() if now_ms is None else float(now_ms)
        if len(self._samples) < self.min_samples:
            self._skip("insufficient-samples")
            return False
        forecast = fit_diurnal(list(self._samples), self.period_ms)
        if forecast is None or forecast.amplitude < 1e-6:
            self._skip("no-diurnal-signal")
            return False
        peak_t, peak_mult = forecast.peak_within(now_ms, self.horizon_ms)
        now_mult = forecast.multiplier_at(now_ms)
        ratio = peak_mult / max(now_mult, 1e-9)
        if ratio < self.threshold:
            self._skip("peak-below-threshold")
            return False
        if self._last_trigger_ms is not None and \
                now_ms - self._last_trigger_ms < self.cooldown_ms:
            self._skip("cooldown")
            return False
        factor = round(ratio, 4)
        peak_in_ms = int(round(peak_t - now_ms))
        events.emit(
            "proactive.forecast",
            peakMultiplier=round(peak_mult, 4), peakInMs=peak_in_ms,
            amplitude=round(forecast.amplitude, 4),
            samples=len(self._samples),
        )
        future = FutureSpec(
            name="projected-peak", events=(traffic_scale(factor),),
            horizon_ms=self.horizon_ms,
        )
        try:
            result = self.cc.whatif([future])
        except Exception as e:
            LOG.warning("proactive what-if failed: %r", e)
            self._skip("whatif-failed")
            return False
        v = result.verdicts[0]
        if v["survivable"] and v["goalViolations"] == 0:
            self._skip("peak-survivable")
            return False
        reason = (
            "projected-unavailability" if not v["survivable"]
            else "projected-goal-violation"
        )
        events.emit(
            "proactive.trigger", severity="WARNING", reason=reason,
            peakInMs=peak_in_ms, peakMultiplier=round(peak_mult, 4),
            overloadedBrokers=v["overloadedBrokers"],
            unavailablePartitions=v["unavailablePartitions"],
        )
        self._last_trigger_ms = now_ms
        self._last_skip_reason = None
        self.triggers += 1
        try:
            self.cc.rebalance(dryrun=False)
        except Exception as e:
            # the trigger stands in the journal; the failed attempt is
            # the analyzer's story (breaker, degradation) — retry lands
            # after the cooldown
            LOG.warning("proactive rebalance failed: %r", e)
            self._skip("rebalance-failed")
            return False
        return True

    def tick(self) -> bool:
        """Pull one sample (production mode) and decide."""
        if self._sample_fn is not None:
            try:
                value = float(self._sample_fn())
            except Exception as e:
                LOG.debug("proactive sample pull failed: %r", e)
                self._skip("sample-unavailable")
                return False
            self.record(self._now_ms(), value)
        return self.maybe_trigger()

    # ---- production daemon ------------------------------------------------------
    def start(self, interval_s: float = 60.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception as e:  # the daemon must outlive one bad tick
                    LOG.warning("proactive tick failed: %r", e)

        self._thread = threading.Thread(
            target=loop, name="whatif-proactive", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def state_summary(self) -> dict:
        return {
            "samples": len(self._samples),
            "triggers": self.triggers,
            "lastSkipReason": self._last_skip_reason,
            "running": self._thread is not None,
        }

"""Background proposal precomputation + degraded-mode serving machinery
(upstream GoalOptimizer's ``ProposalPrecomputingExecutor`` thread pool;
SURVEY.md §2.5 ◆, call stack §3.5).

Three pieces:

* :class:`CachedPlan` — one warm plan plus the provenance degraded-mode
  serving needs: the model generation it was computed against, the
  partition sizes for a later cached execution, and an invalidation
  reason once a model-generation bump / detector anomaly / execution
  declares it stale.  **A stale plan is kept, not dropped** — it is the
  last-good answer the server degrades to when the analyzer is saturated
  or the monitor window-starved, served with an explicit ``stale=true``
  + generation marker instead of a 503.

* :class:`CircuitBreaker` — classic closed → open → half-open guard in
  front of the analyzer.  ``failure_threshold`` consecutive optimize
  failures open it; while open every compute is refused
  (:class:`AnalyzerSaturatedError` → cached/shed-only serving) until
  ``reset_s`` passes, when ONE probe is let through — success closes,
  failure re-opens.  The clock is injectable so the scenario simulator
  can run it on virtual time.

* :class:`ProposalPrecomputingExecutor` — the refresh loop keeping the
  facade's warm plan fresh on an interval (each pass is also the natural
  half-open probe).  ``refresh_once`` is public and synchronous so the
  simulator can drive it deterministically without the thread.

With ``replan.enabled`` the refreshes this daemon triggers (and every
other proposal computation) route through the delta replanner
(:mod:`cruise_control_tpu_torch.replan`): a generation bump WARM-STARTS from
the previous plan — delta model build, dirty-row device upload, seeded
search, partial re-verification, zero-delta short-circuit — instead of
cold recomputing.  The daemon itself is unchanged: the routing lives
behind ``CruiseControl.get_proposals``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, Optional

from cruise_control_tpu_torch.telemetry import events
from cruise_control_tpu_torch.utils.locks import InstrumentedLock

logger = logging.getLogger(__name__)


class AnalyzerSaturatedError(RuntimeError):
    """The analyzer is unavailable for new work (circuit breaker open)
    and no acceptable cached plan exists.  Maps to 503 + Retry-After."""

    def __init__(self, message: str, retry_after_s: int = 2):
        super().__init__(message)
        self.retry_after_s = max(1, int(retry_after_s))


@dataclasses.dataclass
class CachedPlan:
    """A warm plan + the provenance stale-serving needs."""

    result: object                     # OptimizerResult
    generation: str                    # LoadMonitor.model_generation()
    partition_sizes: Dict[int, float]  # for a cached (non-dryrun) execution
    computed_monotonic: float
    computed_unix: float
    engine: str = ""
    #: None = fresh-at-compute; set once something declared it stale
    invalidated: Optional[str] = None

    def age_s(self) -> float:
        return max(0.0, time.monotonic() - self.computed_monotonic)


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe.

    Thread-safe; ``clock`` defaults to ``time.monotonic`` and is
    injectable (the simulator passes virtual time so trip/reset timing is
    deterministic).  State changes are journaled as ``analyzer.breaker``
    events — an overload postmortem reads open/probe/close straight from
    the journal.
    """

    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"

    def __init__(self, failure_threshold: int = 3, reset_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None):
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_s = max(0.0, float(reset_s))
        self._clock = clock or time.monotonic
        self._lock = InstrumentedLock("precompute.state")
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._last_error: Optional[str] = None
        self.trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """True when a compute may proceed.  While OPEN, returns True at
        most once per ``reset_s`` window — the half-open probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN:
                # one probe at a time: further calls stay shed until the
                # probe reports success/failure
                return False
            if (self._clock() - self._opened_at) < self.reset_s:
                return False
            self._state = self.HALF_OPEN
        # journal OFF the breaker lock: emit appends to the event file,
        # and `allow()` sits on every precompute poll
        events.emit("analyzer.breaker", severity="WARNING",
                    state=self.HALF_OPEN, probe=True)
        return True

    def retry_after_s(self) -> int:
        with self._lock:
            if self._state == self.CLOSED or self._opened_at is None:
                return 1
            left = self.reset_s - (self._clock() - self._opened_at)
            return max(1, int(left) + 1)

    def record_success(self) -> None:
        with self._lock:
            was = self._state
            self._consecutive_failures = 0
            self._state = self.CLOSED
            self._opened_at = None
        if was != self.CLOSED:
            events.emit("analyzer.breaker", state=self.CLOSED,
                        recoveredFrom=was)

    def record_failure(self, error: Optional[str] = None) -> None:
        with self._lock:
            self._last_error = error
            self._consecutive_failures += 1
            tripping = (
                self._state == self.HALF_OPEN
                or (self._state == self.CLOSED
                    and self._consecutive_failures >= self.failure_threshold)
            )
            if tripping:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.trips += 1
                failures = self._consecutive_failures
        if tripping:
            events.emit("analyzer.breaker", severity="ERROR",
                        state=self.OPEN, consecutiveFailures=failures,
                        error=error)

    def state_summary(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutiveFailures": self._consecutive_failures,
                "failureThreshold": self.failure_threshold,
                "resetS": self.reset_s,
                "trips": self.trips,
                "lastError": self._last_error,
            }


class ProposalPrecomputingExecutor:
    """Keeps the facade's warm plan fresh on an interval.

    Skips quietly when the model is not ready or an execution is ongoing
    (the next tick retries); every successful pass refreshes the warm
    plan the degraded-serving path falls back on, and every pass through
    an OPEN breaker doubles as its half-open probe."""

    def __init__(self, cruise_control, interval_s: float = 30.0,
                 engine: Optional[str] = None):
        self.cc = cruise_control
        self.interval_s = interval_s
        self.engine = engine
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.runs = 0
        self.errors = 0
        self.skipped = 0
        self.last_run_s: Optional[float] = None
        self.last_error: Optional[str] = None

    def refresh_once(self) -> bool:
        """One precompute pass; False when skipped or failed.

        A pass is skipped (not an error) only when EVERY warm artifact is
        still fresh — the plan (generation unchanged, not invalidated)
        AND the precomputed what-if verdict set, which carries its own
        per-generation freshness.  The probe used to cover present state
        only, so a model-generation bump could leave stale counterfactual
        verdicts serving from cache; now each stale half is refreshed
        independently and an idle cluster still costs one generation
        probe per tick, not one full optimization."""
        try:
            fresh = getattr(self.cc, "proposal_cache_fresh", None)
            plan_fresh = fresh is not None and fresh()
            wfresh = getattr(self.cc, "whatif_cache_fresh", None)
            # facades without a what-if engine (test doubles) have
            # nothing to refresh there — treat that half as fresh
            whatif_fresh = wfresh is None or wfresh()
            if plan_fresh and whatif_fresh:
                self.skipped += 1
                return False
            did = False
            if not plan_fresh:
                # NO breaker pre-check here: the facade's gate is the
                # single arbiter, and its half-open allow() must be
                # consumed by the compute itself — this pass IS the probe
                self.cc.get_proposals(engine=self.engine, ignore_cache=True)
                did = True
            if not whatif_fresh:
                self.cc.refresh_whatif_precompute()
                did = True
            if did:
                self.runs += 1
                self.last_run_s = time.time()
            return did
        except Exception as exc:  # model not ready, ongoing execution, ...
            self.errors += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
            logger.debug("proposal precompute skipped: %s", self.last_error)
            return False

    def start(self, tick_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        interval = tick_s if tick_s is not None else self.interval_s

        def loop() -> None:
            while not self._stop.wait(interval):
                self.refresh_once()

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="proposal-precompute", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self._thread = None

    def state_summary(self) -> dict:
        out = {
            "runs": self.runs,
            "errors": self.errors,
            "skipped": self.skipped,
            "lastRunSecondsAgo": (
                round(time.time() - self.last_run_s, 1)
                if self.last_run_s else None
            ),
            "lastError": self.last_error,
            "running": self._thread is not None,
        }
        out.update(self.cc.proposal_cache_state())
        return out

"""Engine degradation ladder + plan sanity gate (ISSUE 13 front 3).

The facade has always had ONE engine-failure fallback: a *warm* replan
that fails falls back to one cold attempt (``facade._replan_operation``).
This module generalizes that into a ladder that also covers **cold**
TPU-engine failures — an XLA OOM, a compile error, a non-finite
objective — which previously surfaced straight to the caller (or the
detector's fix path) as a hard failure even though the greedy engine
could have served the operation:

    warm TPU  →  cold TPU  →  greedy  →  (operation fails)

* :class:`EngineDegradation` is the breaker-style state: a cold TPU
  failure opens a cooldown during which every operation that would have
  used the TPU engine goes straight to greedy (no per-request failure
  tax); once the cooldown expires the next operation probes the TPU
  engine again — success closes the ladder (``analyzer.engine_recovered``
  journaled), failure re-opens it for a fresh cooldown.  The clock is
  injectable (the chaos simulator runs it on virtual time).
* :func:`plan_sanity_reason` is the last-line output gate: no
  ``OptimizerResult`` with a non-finite violation score, non-finite
  final-state loads, or a HARD-goal violation score worse than the
  pre-plan state may leave the facade — a poisoned model or a buggy
  engine must fail loudly (``analyzer.plan_rejected``), never ship a
  plan that makes the cluster worse.  The worse-score check is scoped to
  hard goals on purpose: soft-goal scores legitimately end worse when a
  safety operation forces it (a FIX_OFFLINE_REPLICAS evacuation trades
  distribution balance for getting replicas off dead disks), but a hard
  violation appearing where none existed is an engine malfunction by
  definition (both engines raise ``OptimizationFailure`` rather than
  emit one).  A sanity rejection counts as an engine failure and rides
  the same ladder.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Iterable, Optional

from cruise_control_tpu_torch.utils.locks import InstrumentedLock


class PlanSanityError(RuntimeError):
    """An engine produced a plan the sanity gate refuses to emit."""

    def __init__(self, engine: str, reason: str):
        super().__init__(f"{engine} plan rejected: {reason}")
        self.engine = engine
        self.reason = reason


def _intrinsic_hard_goals() -> set:
    from cruise_control_tpu_torch.analyzer.goal_optimizer import GOAL_CLASSES

    return {name for name, cls in GOAL_CLASSES.items() if cls.is_hard}


def plan_sanity_reason(result,
                       hard_goals: Optional[Iterable[str]] = None
                       ) -> Optional[str]:
    """None when ``result`` may be emitted; otherwise the categorical
    reject reason.  ``hard_goals`` scopes the worse-score comparison
    (None = each goal class's intrinsic hardness).  Cheap by
    construction — scalar checks plus one vectorized finiteness pass
    over the final loads."""
    import numpy as np

    try:
        before = float(result.violation_score_before)
        after = float(result.violation_score_after)
    except (TypeError, ValueError):
        return "non-numeric-violation-score"
    if not (math.isfinite(before) and math.isfinite(after)):
        return "non-finite-violation-score"
    hard = set(hard_goals) if hard_goals is not None \
        else _intrinsic_hard_goals()
    hard_before = sum(
        v for g, v in result.violations_before.items() if g in hard
    )
    hard_after = sum(
        v for g, v in result.violations_after.items() if g in hard
    )
    if hard_after > hard_before:
        return "hard-score-worse-than-pre-plan"
    final_state = result.final_state
    if final_state is not None:
        loads = np.asarray(final_state.leader_load)
        if not bool(np.isfinite(loads).all()):
            return "non-finite-final-loads"
    return None


class EngineDegradation:
    """Breaker-style cooldown for the TPU→greedy engine ladder.

    Plain two-state machine (healthy / degraded-until-T): inside the
    cooldown :meth:`active` is True and the facade picks greedy without
    touching the TPU engine; past it the next TPU attempt IS the
    half-open probe — re-failure re-arms the cooldown, success clears
    the state.  Thread-safe; ``clock`` is injectable for virtual-time
    chaos runs (defaults to ``time.monotonic``).
    """

    def __init__(self, cooldown_s: float = 300.0,
                 clock: Optional[Callable[[], float]] = None):
        self.cooldown_s = float(cooldown_s)
        self.clock = clock or time.monotonic
        self._lock = InstrumentedLock("engine.degradation")
        self._degraded_until: Optional[float] = None
        self._last_error: Optional[str] = None
        self.degradations = 0

    def active(self) -> bool:
        """True while operations should skip the TPU engine."""
        with self._lock:
            return (self._degraded_until is not None
                    and self.clock() < self._degraded_until)

    def record_failure(self, error: str) -> None:
        """A TPU attempt failed: (re-)arm the cooldown."""
        with self._lock:
            self._degraded_until = self.clock() + self.cooldown_s
            self._last_error = error
            self.degradations += 1

    def record_success(self) -> bool:
        """A TPU attempt succeeded; returns True when this success
        RECOVERED the ladder (the caller journals it)."""
        with self._lock:
            recovered = self._degraded_until is not None
            self._degraded_until = None
            self._last_error = None
            return recovered

    def state_summary(self) -> dict:
        with self._lock:
            degraded = (self._degraded_until is not None
                        and self.clock() < self._degraded_until)
            return {
                "state": "DEGRADED" if degraded else "OK",
                "cooldownS": self.cooldown_s,
                "degradations": self.degradations,
                "lastError": self._last_error,
                "retryInS": (
                    round(max(0.0, self._degraded_until - self.clock()), 3)
                    if degraded else None
                ),
            }

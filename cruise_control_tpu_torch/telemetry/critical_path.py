"""End-to-end critical-path decomposition (ISSUE 18) — EXACT phase
partitions of the two walls operators actually page on:

* **per-request** — the HTTP server threads a :class:`PhaseClock` through
  dispatch: consecutive ``perf_counter`` marks split the request wall
  into ``parse`` (routing + params + body cap), ``auth`` (deadline
  header + authentication), ``admissionQueue`` (slot wait at the front
  door), ``facade`` (proposal lookup/compute, when the handler crosses
  it), ``handler`` (endpoint work), ``serialize`` (JSON encode +
  headers) and ``flush`` (socket write).  Because each phase is the time
  *since the previous mark*, the phases sum to the measured wall by
  construction — reconciliation is arithmetic, not luck.

* **per-heal** — :func:`heal_episodes` re-reads the event journal and
  partitions each fault→recovery episode by its anchor events:
  ``detection`` (``sim.fault`` → ``detector.anomaly``), ``admission``
  (anomaly → cooldown record), ``cooldownWait`` (cooldown record →
  ``optimize.start``), ``planCompute`` (``optimize.start`` →
  ``optimize.end``), ``executionPrep`` (plan → ``executor.start``) and
  ``executionTicks`` (``executor.start`` → ``executor.end``).  Anchors
  are consecutive, so the same exactness holds.

The per-request store is always-on and bounded (a ring of recent
decompositions per endpoint); it feeds ``GET /diagnostics`` and the
``cc-tpu-critical-path/1`` artifact that ``benchmarks/critical_path.py``
commits as ``CRITICAL_PATH_r18.json``.  Nothing here journals or
samples — the stores are memory-only, so scenario/soak fingerprints
cannot move.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

SCHEMA = "cc-tpu-critical-path/1"

#: ring size per endpoint — enough for a serve-load run's full request
#: stream while bounding memory (one dict of ~8 floats per request)
_KEEP = 4096


class PhaseClock:
    """Consecutive-mark phase splitter for ONE request.  ``mark(name)``
    attributes the time since the previous mark to ``name``; repeated
    names accumulate.  Single-thread use (the request's handler thread);
    not locked."""

    __slots__ = ("_clock", "_t0", "_last", "endpoint", "_phases")

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._last = self._t0
        self.endpoint = "unknown"
        self._phases: List[tuple] = []

    def mark(self, phase: str) -> None:
        now = self._clock()
        self._phases.append((phase, now - self._last))
        self._last = now

    def wall_s(self) -> float:
        return self._last - self._t0

    def phases(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for phase, dt in self._phases:
            out[phase] = out.get(phase, 0.0) + dt
        return out


# ---- thread-local plumbing (the HTTP server's dispatch scope) --------------------
_LOCAL = threading.local()


def current() -> Optional[PhaseClock]:
    return getattr(_LOCAL, "clock", None)


def mark(phase: str) -> None:
    """Mark a phase boundary on this thread's active request clock (safe
    no-op outside a request scope — the facade calls this whether or not
    HTTP is above it)."""
    clock = getattr(_LOCAL, "clock", None)
    if clock is not None:
        clock.mark(phase)


def set_endpoint(endpoint: str) -> None:
    clock = getattr(_LOCAL, "clock", None)
    if clock is not None:
        clock.endpoint = endpoint


@contextlib.contextmanager
def request_scope(store: Optional["CriticalPathStore"] = None):
    """Open a per-request phase clock on this thread; on exit the
    decomposition is recorded into ``store`` (default: the process-wide
    :data:`STORE`)."""
    clock = PhaseClock()
    prev = getattr(_LOCAL, "clock", None)
    _LOCAL.clock = clock
    try:
        yield clock
    finally:
        _LOCAL.clock = prev
        (store if store is not None else STORE).record(clock)


# ---- the per-request store -------------------------------------------------------
class CriticalPathStore:
    """Bounded ring of per-request phase decompositions, per endpoint."""

    def __init__(self, keep: int = _KEEP) -> None:
        self._lock = threading.Lock()
        self._keep = int(keep)
        self._rings: Dict[str, deque] = {}
        self.recorded = 0

    def record(self, clock: PhaseClock) -> None:
        wall = clock.wall_s()
        if wall <= 0.0:  # no marks ever fired (e.g. /ui short-circuit)
            return
        entry = {"wallS": wall, "phases": clock.phases()}
        with self._lock:
            ring = self._rings.get(clock.endpoint)
            if ring is None:
                ring = self._rings[clock.endpoint] = deque(
                    maxlen=self._keep)
            ring.append(entry)
            self.recorded += 1

    def endpoints(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def decompose(self, endpoint: str) -> Optional[dict]:
        """The endpoint's decomposition block: wall percentiles, the p99
        sample request's own exact phase split, and the mean split."""
        with self._lock:
            ring = self._rings.get(endpoint)
            entries = list(ring) if ring else []
        if not entries:
            return None
        by_wall = sorted(entries, key=lambda e: e["wallS"])
        n = len(by_wall)

        def pick(q: float) -> dict:
            return by_wall[min(int(q * n), n - 1)]

        p99 = pick(0.99)
        mean_phases: Dict[str, float] = {}
        recon_sum = 0.0
        for e in entries:
            covered = 0.0
            for phase, dt in e["phases"].items():
                mean_phases[phase] = mean_phases.get(phase, 0.0) + dt
                covered += dt
            recon_sum += covered / e["wallS"] if e["wallS"] else 1.0
        return {
            "endpoint": endpoint,
            "requests": n,
            "wallP50Ms": round(pick(0.50)["wallS"] * 1000.0, 3),
            "wallP99Ms": round(p99["wallS"] * 1000.0, 3),
            "p99": {
                "wallMs": round(p99["wallS"] * 1000.0, 3),
                "phasesMs": {
                    ph: round(dt * 1000.0, 3)
                    for ph, dt in sorted(p99["phases"].items())
                },
                "reconciliationPct": _recon_pct(
                    p99["phases"], p99["wallS"]),
            },
            "meanPhasesMs": {
                ph: round(total / n * 1000.0, 3)
                for ph, total in sorted(mean_phases.items())
            },
            "reconciliationPct": round(recon_sum / n * 100.0, 2),
        }

    def snapshot(self) -> dict:
        """{endpoint: decomposition} — the GET /diagnostics block."""
        return {
            ep: block for ep in self.endpoints()
            if (block := self.decompose(ep)) is not None
        }

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self.recorded = 0


#: process-wide default (the HTTP server records into it)
STORE = CriticalPathStore()


def _recon_pct(phases: Dict[str, float], wall_s: float) -> float:
    if wall_s <= 0.0:
        return 100.0
    return round(sum(phases.values()) / wall_s * 100.0, 2)


# ---- per-heal decomposition (journal reader) -------------------------------------
#: the anchor sequence: each phase runs from its event to the next one
_HEAL_ANCHORS = (
    ("sim.fault", None),
    ("detector.anomaly", "detection"),
    ("detector.recovery_cooldown", "admission"),
    ("optimize.start", "cooldownWait"),
    ("optimize.end", "planCompute"),
    ("executor.start", "executionPrep"),
    ("executor.end", "executionTicks"),
)


def heal_episodes(entries: List[dict]) -> List[dict]:
    """Partition each complete fault→recovery episode in a journal-entry
    stream (``cc-tpu-events/1`` dicts, any order) into its exact phase
    split.  The ``detector.recovery_cooldown`` anchor is optional — when
    absent its ``admission`` segment folds into ``cooldownWait`` (the
    anomaly handler went straight to the analyzer).  Episodes missing a
    terminal ``executor.end`` (heal still in flight, or a no-move plan)
    are skipped."""
    events = sorted(
        (e for e in entries if isinstance(e, dict) and "ts" in e),
        key=lambda e: e["ts"],
    )
    episodes: List[dict] = []
    i = 0
    while i < len(events):
        if events[i].get("kind") != "sim.fault":
            i += 1
            continue
        t_fault = float(events[i]["ts"])
        phases: Dict[str, float] = {}
        last_ts = t_fault
        cursor = i + 1
        ok = True
        for kind, phase in _HEAL_ANCHORS[1:]:
            found = None
            for j in range(cursor, len(events)):
                k = events[j].get("kind")
                if k == "sim.fault":  # next episode began first
                    break
                if k == kind:
                    found = j
                    break
            if found is None:
                if kind == "detector.recovery_cooldown":
                    continue  # optional anchor: fold into the next phase
                ok = False
                break
            ts = float(events[found]["ts"])
            phases[phase] = phases.get(phase, 0.0) + (ts - last_ts)
            last_ts = ts
            cursor = found + 1
        if not ok:
            i += 1
            continue
        wall = last_ts - t_fault
        episodes.append({
            "faultTs": round(t_fault, 3),
            "wallS": round(wall, 3),
            "phasesS": {
                ph: round(dt, 3) for ph, dt in phases.items()
            },
            "reconciliationPct": _recon_pct(phases, wall),
        })
        i = cursor
    return episodes


# ---- the committed artifact ------------------------------------------------------
def build_artifact(serve: Optional[dict] = None,
                   heal: Optional[List[dict]] = None,
                   metrics_scrape: Optional[dict] = None,
                   now: Optional[float] = None) -> dict:
    """Assemble ``cc-tpu-critical-path/1`` (``CRITICAL_PATH_r18.json``):
    the serve-load p99 decomposition, the soak heal episodes, and the
    GET /metrics before/after contention evidence.  The artifact-level
    ``reconciliationPct`` is the WORST of its parts — the ≥95% gate
    holds only if every decomposition accounts for its wall."""
    recons = []
    if serve is not None:
        recons.append(serve["reconciliationPct"])
        recons.append(serve["p99"]["reconciliationPct"])
    for ep in heal or ():
        recons.append(ep["reconciliationPct"])
    return {
        "schema": SCHEMA,
        "generatedUnix": round(time.time() if now is None else now, 3),
        "serve": serve,
        "heal": list(heal or ()),
        "metricsScrape": metrics_scrape,
        "reconciliationPct": round(min(recons), 2) if recons else 0.0,
    }

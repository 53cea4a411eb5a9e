"""Instrumented locks — wait-vs-hold contention telemetry for the host's
named hot locks (ISSUE 18; the lock-level analog of the span tracer).

Every serving-path stall the sampling profiler can only see as "thread
blocked in ``acquire``" is attributable here: :class:`InstrumentedLock`
(and :class:`InstrumentedSemaphore`) are drop-in stdlib replacements that
measure, per named lock,

* **wait** — time a thread spent blocked acquiring (the contention cost
  other threads imposed), and
* **hold** — time the lock was held (the budget the owner spent while
  everyone else queued),

into the process-wide :data:`CONTENTION` registry.  The exposition layer
renders the totals as ``cc_lock_wait_ms{lock=}`` / ``cc_lock_hold_ms{lock=}``
counter families, ``GET /diagnostics`` carries the full snapshot, and the
SLO engine's maintenance pass calls :meth:`ContentionRegistry.check_pending`
so SUSTAINED contention (wait above the threshold for two consecutive
windows) becomes one ``contention.hot_lock`` journal event instead of a
silent tail-latency regression.

Overhead discipline: the uncontended fast path is one non-blocking
``acquire`` probe + two ``perf_counter`` reads; the per-stats lock is held
for a handful of float adds.  The wrapper is deliberately NOT used on the
per-metric locks inside ``utils/metrics.py`` (millions of acquisitions per
rebalance) — only on the named coordination locks where waits are
milliseconds, not nanoseconds.

Acquisition-order witness (ISSUE 19, opt-in via
``telemetry.host.lock.order.witness``): when enabled, the registry also
records every *nested* acquisition — thread holds named lock A, acquires
named lock B → edge ``A → B`` — into a bounded edge map.
:meth:`ContentionRegistry.order_witness` snapshots it, and the lock-graph
reconciliation test asserts every runtime-observed edge is present in the
committed static ``cc-tpu-lock-graph/1`` artifact (cclint's lock-order
rule).  Off by default; the off path is a single attribute check.

``Condition`` interop: :class:`InstrumentedLock` implements ``_is_owned``
(owner-thread tracking), so ``threading.Condition(InstrumentedLock(...))``
never falls back to the stdlib's ``acquire(False)`` probe — probe noise
would otherwise pollute the acquisition counts.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "CONTENTION",
    "ContentionRegistry",
    "InstrumentedLock",
    "InstrumentedSemaphore",
    "LockStats",
]


class LockStats:
    """Aggregated wait/hold accounting for ONE named lock (all instances
    sharing the name — e.g. every EventJournal — fold into one row)."""

    def __init__(self, name: str) -> None:
        self.name = name
        # a RAW lock on purpose: instrumenting the stats lock would recurse
        self._lock = threading.Lock()
        self.acquisitions = 0
        self.contended = 0
        self.wait_total_s = 0.0
        self.wait_max_s = 0.0
        self.hold_total_s = 0.0
        self.hold_max_s = 0.0
        # window accumulators, drained by the contention check
        self._window_wait_s = 0.0
        self._window_acquisitions = 0

    # ---- recording (called from the wrappers) -----------------------------------
    def record_acquire(self, waited_s: float) -> None:
        with self._lock:
            self.acquisitions += 1
            self._window_acquisitions += 1
            if waited_s > 0.0:
                self.contended += 1
                self.wait_total_s += waited_s
                self._window_wait_s += waited_s
                if waited_s > self.wait_max_s:
                    self.wait_max_s = waited_s

    def record_wait_abandoned(self, waited_s: float) -> None:
        """A bounded acquire timed out: the wait was real, the acquisition
        never happened (queue-timeout sheds land here)."""
        with self._lock:
            self.contended += 1
            self.wait_total_s += waited_s
            self._window_wait_s += waited_s
            if waited_s > self.wait_max_s:
                self.wait_max_s = waited_s

    def record_release(self, held_s: float) -> None:
        with self._lock:
            self.hold_total_s += held_s
            if held_s > self.hold_max_s:
                self.hold_max_s = held_s

    # ---- reading ----------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "acquisitions": self.acquisitions,
                "contended": self.contended,
                "waitMs": round(self.wait_total_s * 1000.0, 3),
                "waitMaxMs": round(self.wait_max_s * 1000.0, 3),
                "holdMs": round(self.hold_total_s * 1000.0, 3),
                "holdMaxMs": round(self.hold_max_s * 1000.0, 3),
            }

    def drain_window(self) -> Tuple[float, int]:
        """(window wait seconds, window acquisitions) since last drain."""
        with self._lock:
            out = (self._window_wait_s, self._window_acquisitions)
            self._window_wait_s = 0.0
            self._window_acquisitions = 0
            return out


class ContentionRegistry:
    """All named lock stats + the sustained-contention detector.

    The detector is PULL-based: :meth:`check_pending` runs on the SLO
    engine's maintenance thread (never on a request thread, never in the
    sim — the scenario/soak drivers don't pump it, so the pinned journal
    fingerprints can't grow nondeterministic contention events).  A lock
    is *hot* when one check window accumulates more than
    ``threshold_ms`` of wait; ``contention.hot_lock`` is journaled only
    after ``sustain_windows`` consecutive hot windows, with a per-lock
    cooldown so a pathological lock emits one event per cooldown, not one
    per check.
    """

    def __init__(
        self,
        threshold_ms: float = 250.0,
        sustain_windows: int = 2,
        cooldown_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, LockStats] = {}
        self.threshold_ms = float(threshold_ms)
        self.sustain_windows = int(sustain_windows)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._hot_streak: Dict[str, int] = {}
        self._last_emit: Dict[str, float] = {}
        self.hot_events = 0
        # ---- acquisition-order witness (off by default) ----------------------
        # A plain bool on purpose: the wrappers' fast path is ONE attribute
        # load + branch when the witness is off — no lock, no thread-local
        # touch, no allocation (the bench gate asserts the overhead).
        self.order_witness_enabled = False
        self._witness_local = threading.local()
        self._witness_edges: Dict[Tuple[str, str], int] = {}
        self._witness_bound = 256
        self._witness_dropped = 0

    def configure(self, threshold_ms: Optional[float] = None,
                  sustain_windows: Optional[int] = None,
                  cooldown_s: Optional[float] = None) -> None:
        if threshold_ms is not None:
            self.threshold_ms = float(threshold_ms)
        if sustain_windows is not None:
            self.sustain_windows = int(sustain_windows)
        if cooldown_s is not None:
            self.cooldown_s = float(cooldown_s)

    def stats(self, name: str) -> LockStats:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = LockStats(name)
            return st

    def _all(self) -> List[LockStats]:
        with self._lock:
            return list(self._stats.values())

    def snapshot(self) -> dict:
        """{lock name: stats} — the GET /diagnostics block."""
        return {st.name: st.snapshot() for st in self._all()}

    def families(self) -> List[tuple]:
        """``extra_families`` rows for the exposition layer:
        cc_lock_wait_ms / cc_lock_hold_ms / cc_lock_acquisitions_total,
        one ``lock`` label per named lock."""
        stats = sorted(self._all(), key=lambda st: st.name)
        snaps = [(st.name, st.snapshot()) for st in stats]
        return [
            ("cc_lock_wait_ms", "counter",
             "Cumulative time threads spent blocked acquiring the named "
             "lock (ms)",
             [({"lock": name}, s["waitMs"]) for name, s in snaps]),
            ("cc_lock_hold_ms", "counter",
             "Cumulative time the named lock was held (ms)",
             [({"lock": name}, s["holdMs"]) for name, s in snaps]),
            ("cc_lock_acquisitions_total", "counter",
             "Acquisitions of the named lock (contended or not)",
             [({"lock": name}, s["acquisitions"]) for name, s in snaps]),
        ]

    # ---- sustained-contention detection (maintenance-thread only) ----------------
    def check_pending(self) -> int:
        """Drain every lock's window and journal ``contention.hot_lock``
        for locks hot ``sustain_windows`` checks in a row (cooldown-
        limited).  Returns the number of events emitted (the SLO engine's
        maintenance-hook contract ignores it; tests read it)."""
        emitted = 0
        now = self.clock()
        for st in self._all():
            window_wait_s, window_acq = st.drain_window()
            wait_ms = window_wait_s * 1000.0
            if wait_ms < self.threshold_ms:
                self._hot_streak[st.name] = 0
                continue
            streak = self._hot_streak.get(st.name, 0) + 1
            self._hot_streak[st.name] = streak
            if streak < self.sustain_windows:
                continue
            last = self._last_emit.get(st.name)
            if last is not None and now - last < self.cooldown_s:
                continue
            self._last_emit[st.name] = now
            self._hot_streak[st.name] = 0
            self.hot_events += 1
            emitted += 1
            snap = st.snapshot()
            # lazy import: utils must not import telemetry at module load
            # (telemetry.events itself locks through this module)
            from cruise_control_tpu_torch.telemetry import events

            events.emit(
                "contention.hot_lock", severity="WARNING",
                lock=st.name,
                windowWaitMs=round(wait_ms, 3),
                windowAcquisitions=window_acq,
                sustainedWindows=self.sustain_windows,
                totalWaitMs=snap["waitMs"],
                totalHoldMs=snap["holdMs"],
            )
        return emitted

    # ---- acquisition-order witness ------------------------------------------------
    def enable_order_witness(self, bound: int = 256) -> None:
        """Start recording observed acquisition-order edges: whenever a
        thread acquires named lock B while already holding named lock A,
        the edge ``A → B`` is counted.  Bounded: at most ``bound``
        DISTINCT edges are kept (overflow increments ``dropped`` — counts
        on known edges keep accumulating).  Enable/disable while no named
        lock is held: a thread's held-stack is only maintained while the
        witness is on, so toggling mid-hold can leave a stale entry on
        that thread (docs/OBSERVABILITY.md)."""
        with self._lock:
            self._witness_edges.clear()
            self._witness_dropped = 0
            self._witness_bound = int(bound)
            # published last, under the lock: no recorder can observe
            # enabled=True with a half-cleared edge map
            self.order_witness_enabled = True

    def disable_order_witness(self) -> None:
        with self._lock:
            self.order_witness_enabled = False

    def order_witness(self) -> dict:
        """Snapshot of the observed order edges — the runtime side the
        lock-graph reconciliation test checks against the committed
        static ``cc-tpu-lock-graph/1`` artifact."""
        with self._lock:
            edges = [
                {"from": a, "to": b, "count": n}
                for (a, b), n in sorted(self._witness_edges.items())
            ]
            return {"enabled": self.order_witness_enabled,
                    "edges": edges, "dropped": self._witness_dropped}

    def _witness_stack(self) -> List[str]:
        stack = getattr(self._witness_local, "stack", None)
        if stack is None:
            stack = self._witness_local.stack = []
        return stack

    def _witness_acquired(self, name: str) -> None:
        """Called by the wrappers AFTER a successful acquire, only while
        the witness is enabled."""
        stack = self._witness_stack()
        if stack:
            with self._lock:
                for held in stack:
                    if held == name:
                        continue  # re-entry on a same-named sibling
                    key = (held, name)
                    n = self._witness_edges.get(key)
                    if n is None and \
                            len(self._witness_edges) >= self._witness_bound:
                        self._witness_dropped += 1
                        continue
                    self._witness_edges[key] = (n or 0) + 1
        stack.append(name)

    def _witness_released(self, name: str) -> None:
        stack = getattr(self._witness_local, "stack", None)
        if stack:
            # LIFO in the common case; reverse search tolerates
            # out-of-order hand-releases
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._witness_edges.clear()
            self._witness_dropped = 0
            self.order_witness_enabled = False
        self._hot_streak.clear()
        self._last_emit.clear()
        self.hot_events = 0


#: process-wide default registry (constructor injection overrides it)
CONTENTION = ContentionRegistry()


class InstrumentedLock:
    """``threading.Lock`` drop-in that reports wait/hold to a named
    :class:`LockStats` row.  API-compatible with the stdlib lock
    (``acquire(blocking, timeout)`` / ``release`` / context manager /
    ``locked``) plus ``_is_owned`` for ``threading.Condition``."""

    def __init__(self, name: str,
                 registry: Optional[ContentionRegistry] = None) -> None:
        self.name = name
        self._inner = threading.Lock()
        self._reg = registry if registry is not None else CONTENTION
        self._stats = self._reg.stats(name)
        self._owner: Optional[int] = None
        self._acquired_at = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        waited = 0.0
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            t0 = time.perf_counter()
            got = self._inner.acquire(True, timeout)
            waited = time.perf_counter() - t0
            if not got:
                self._stats.record_wait_abandoned(waited)
                return False
        self._stats.record_acquire(waited)
        if self._reg.order_witness_enabled:
            self._reg._witness_acquired(self.name)
        self._owner = threading.get_ident()
        self._acquired_at = time.perf_counter()
        return True

    def release(self) -> None:
        held = time.perf_counter() - self._acquired_at
        if self._reg.order_witness_enabled:
            self._reg._witness_released(self.name)
        # clear ownership BEFORE the inner release: the next owner writes
        # its own ident after acquiring, and must not be clobbered
        self._owner = None
        self._inner.release()
        self._stats.record_release(held)

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        """Condition support: owner tracking instead of the stdlib's
        non-blocking probe fallback (which would count phantom
        acquisitions here)."""
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedSemaphore:
    """``threading.Semaphore`` drop-in with the same wait/hold telemetry
    (hold is tracked per acquiring thread; a permit released by a
    different thread records no hold rather than a wrong one)."""

    def __init__(self, value: int = 1, name: str = "semaphore",
                 registry: Optional[ContentionRegistry] = None) -> None:
        self.name = name
        self._inner = threading.Semaphore(value)
        self._reg = registry if registry is not None else CONTENTION
        self._stats = self._reg.stats(name)
        self._meta = threading.Lock()
        self._held_since: Dict[int, List[float]] = {}

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        waited = 0.0
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            t0 = time.perf_counter()
            got = self._inner.acquire(True, timeout)
            waited = time.perf_counter() - t0
            if not got:
                self._stats.record_wait_abandoned(waited)
                return False
        self._stats.record_acquire(waited)
        if self._reg.order_witness_enabled:
            self._reg._witness_acquired(self.name)
        ident = threading.get_ident()
        with self._meta:
            self._held_since.setdefault(ident, []).append(
                time.perf_counter())
        return True

    def release(self, n: int = 1) -> None:
        if self._reg.order_witness_enabled:
            self._reg._witness_released(self.name)
        ident = threading.get_ident()
        now = time.perf_counter()
        with self._meta:
            stack = self._held_since.get(ident)
            t0 = stack.pop() if stack else None
            if stack is not None and not stack:
                del self._held_since[ident]
        self._inner.release(n)
        if t0 is not None:
            self._stats.record_release(now - t0)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

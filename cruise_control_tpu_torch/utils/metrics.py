"""Dropwizard-style metric registry (upstream wires a
``com.codahale.metrics.MetricRegistry`` through every subsystem and exposes
it via JMX; SURVEY.md §5.1).  Timers, histograms, meters, counters and
gauges with a JSON snapshot — the TPU build's observability spine, surfaced
through ``GET /state`` instead of JMX, scraped via ``GET /metrics``, and
retained as time series by the flight recorder (``telemetry/recorder.py``).

Thread-safe: the registry is shared by the servlet worker threads, the
detector scheduler, the fetcher manager, the executor and the flight
recorder's sampling thread.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from cruise_control_tpu_torch.utils.locks import InstrumentedLock

#: Fixed log-spaced duration buckets (seconds): 3 per decade, 1ms → 100s.
#: Fixed — not per-instance — so bucket series from different processes and
#: different runs line up in dashboards, and the exposition layer can emit
#: one stable ``le`` label set per family.
DEFAULT_DURATION_BUCKETS: tuple = tuple(
    round(10.0 ** (e / 3.0), 9) for e in range(-9, 7)
)


class Counter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def snapshot(self) -> dict:
        return {"count": self.count}


class Meter(Counter):
    """Counter + event rate over the process lifetime and a recent window.

    The recent window is tracked in coarse per-second buckets in a bounded
    deque — ``mark(n)`` is O(1) and memory is bounded by the window length
    regardless of burst size (the previous per-event timestamp list was
    O(n) per mark and unbounded under bursty ``mark(n)``).
    """

    _WINDOW_S = 300

    def __init__(self) -> None:
        super().__init__()
        self._start = time.time()
        #: [second, count] pairs, newest last; ≤ one entry per second, the
        #: deque maxlen bounds memory to the window even if snapshots never
        #: run
        self._buckets: deque = deque(maxlen=self._WINDOW_S)

    def mark(self, n: int = 1) -> None:
        sec = int(time.time())
        with self._lock:
            self.count += n
            if self._buckets and self._buckets[-1][0] == sec:
                self._buckets[-1][1] += n
            else:
                self._buckets.append([sec, n])

    def snapshot(self) -> dict:
        elapsed = max(time.time() - self._start, 1e-9)
        cutoff = int(time.time()) - self._WINDOW_S
        with self._lock:
            recent = sum(c for s, c in self._buckets if s >= cutoff)
        return {
            "count": self.count,
            "meanRatePerSec": round(self.count / elapsed, 4),
            "fiveMinCount": recent,
        }


class Histogram:
    """Fixed-bucket histogram (log-spaced bounds, thread-safe).

    Observations land in the first bucket whose upper bound is >= the
    value; anything beyond the last bound counts only toward ``+Inf``.
    Snapshot buckets are CUMULATIVE (Prometheus ``le`` semantics), so the
    exposition layer emits them verbatim as ``_bucket``/``_sum``/``_count``
    families.
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None) -> None:
        self._lock = threading.Lock()
        self.bounds: tuple = tuple(bounds or DEFAULT_DURATION_BUCKETS)
        self._counts = [0] * (len(self.bounds) + 1)  # last slot: > max bound
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def update(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.sum += value
            if value > self.max:
                self.max = value

    def cumulative_buckets(self) -> List[tuple]:
        """[(upper_bound, cumulative_count), ...] — +Inf is the total."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for bound, c in zip(self.bounds, counts):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def snapshot(self) -> dict:
        with self._lock:
            count, total, mx = self.count, self.sum, self.max
        return {
            "count": count,
            "sum": round(total, 6),
            "max": round(mx, 6),
            "meanSec": round(total / count, 6) if count else 0.0,
            "buckets": {
                ("+Inf" if b == float("inf") else repr(b)): c
                for b, c in self.cumulative_buckets()
            },
        }


class Timer:
    """Duration histogram; use as a context manager or record seconds.

    Keeps a bounded reservoir for JSON p50/p99 AND fixed log-spaced bucket
    counts, so the exposition layer renders a true Prometheus histogram
    (``_bucket``/``_sum``/``_count``) instead of unaggregatable quantile
    summaries.
    """

    _KEEP = 1024

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._samples: List[float] = []
        self.bounds: tuple = DEFAULT_DURATION_BUCKETS
        self._bucket_counts = [0] * (len(self.bounds) + 1)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.update(time.perf_counter() - self._t0)

    def update(self, seconds: float) -> None:
        idx = bisect.bisect_left(self.bounds, seconds)
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)
            self._bucket_counts[idx] += 1
            self._samples.append(seconds)
            if len(self._samples) > self._KEEP:
                self._samples = self._samples[-self._KEEP:]

    def _percentile(self, q: float) -> float:
        # copy under the lock, SORT OFF-LOCK: a scrape sorting 1024
        # samples while holding the lock stalls every request thread's
        # update() behind it (the GET /metrics contention ISSUE 18 fixed)
        with self._lock:
            if not self._samples:
                return 0.0
            s = list(self._samples)
        s.sort()
        idx = min(int(q * len(s)), len(s) - 1)
        return s[idx]

    def cumulative_buckets(self) -> List[tuple]:
        """[(upper_bound, cumulative_count), ...] — +Inf is the total."""
        with self._lock:
            counts = list(self._bucket_counts)
        out, acc = [], 0
        for bound, c in zip(self.bounds, counts):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def snapshot(self) -> dict:
        # one locked copy, one off-lock sort, both percentiles from it —
        # not two _percentile() calls (two copies + two sorts per
        # snapshot, and the pre-ISSUE-18 version sorted under the lock)
        with self._lock:
            count, total, mx = self.count, self.total_s, self.max_s
            samples = list(self._samples)
        samples.sort()

        def pct(q: float) -> float:
            if not samples:
                return 0.0
            return samples[min(int(q * len(samples)), len(samples) - 1)]

        return {
            "count": count,
            "sumSec": round(total, 6),
            "meanSec": round(total / count, 6) if count else 0.0,
            "maxSec": round(mx, 6),
            "p50Sec": round(pct(0.50), 6),
            "p99Sec": round(pct(0.99), 6),
        }


class MetricRegistry:
    def __init__(self) -> None:
        # instrumented (ISSUE 18): every request thread's timer(name)
        # lookup serializes here, so its wait series is the scrape-vs-
        # serve contention evidence (cc_lock_wait_ms{lock="metric.registry"})
        self._lock = InstrumentedLock("metric.registry")
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._meters: Dict[str, Meter] = {}
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds)
            return h

    def meter(self, name: str) -> Meter:
        with self._lock:
            return self._meters.setdefault(name, Meter())

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = fn

    def scrape_parts(self) -> tuple:
        """(counters, meters, gauges, timers, histograms) — ONE locked
        table copy for the exposition layer, which then reads the live
        objects off-lock.  ``snapshot()`` would render timer/histogram
        JSON the scrape discards (re-sorting every reservoir twice)."""
        with self._lock:
            return (dict(self._counters), dict(self._meters),
                    dict(self._gauges), dict(self._timers),
                    dict(self._histograms))

    def timers(self) -> Dict[str, Timer]:
        with self._lock:
            return dict(self._timers)

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._histograms)

    def snapshot(self) -> dict:
        with self._lock:
            timers = dict(self._timers)
            histograms = dict(self._histograms)
            meters = dict(self._meters)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        out: dict = {
            "timers": {n: t.snapshot() for n, t in timers.items()},
            "histograms": {n: h.snapshot() for n, h in histograms.items()},
            "meters": {n: m.snapshot() for n, m in meters.items()},
            "counters": {n: c.snapshot() for n, c in counters.items()},
        }
        # a raising gauge callable must never 500 the JSON surface (GET
        # /state) — the exposition path skips non-numerics the same way
        gvals = {}
        for n, fn in gauges.items():
            try:
                gvals[n] = fn()
            except Exception as exc:  # cclint: disable=swallowed-exception -- not silent: the error string becomes the gauge's snapshot value, visible on GET /state
                gvals[n] = f"error: {exc}"
        out["gauges"] = gvals
        return out


#: process-wide default (constructor injection overrides it everywhere)
DEFAULT_REGISTRY = MetricRegistry()

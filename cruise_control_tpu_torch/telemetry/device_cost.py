"""Per-executable device-cost telemetry — the kernel budget, always on.

The port's counterpart of the reference's ``telemetry/device_cost.py``,
with its public names, its ``cc_device_*`` families and its
``deviceCost`` block.  The port has no compiler to ask for a cost
analysis; its "executables" are what it builds once and calls many
times:

* a **captured step chunk** (``analyzer/step_graph.py``), as the logical
  function ``analyzer.scan_fn``, keyed by its step loop's key.  Bytes and
  operations a call (one chunk replay): the chunk's captured launches
  times each kernel's work model at the loop's shapes (the ``*_work``
  functions beside each wrapper, recorded at capture).  Memory: the
  loop's static buffers (``argBytes``), its output and carry
  (``outputBytes``), and the allocator's growth across the capture, the
  graph's private pool (``tempBytes``);
* the score-only **round** (``analyzer.round_fn``) and the what-if
  verdict call (``whatif.verdict_fn``, K12), each keyed by its shapes,
  with the work its first call launched.

A build records a **pending capture** (a zero-argument source that
returns the cost), materialized off the request path by
:meth:`DeviceCostMonitor.capture_pending` on the SLO observatory's tick.
Every call marks a per-function **call-rate** bucket, so the captured
per-call bytes become a live **HBM-bandwidth utilization estimate**:
``Σ_fn bytes(fn) × rate(fn) / bandwidth``, with the bandwidth from
``telemetry.device.cost.hbm.gbps`` (the card's 3 350 GB/s by default).

Thread-safe: one lock; the per-call path touches only the rate buckets.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("device_cost")

#: assumed HBM bandwidth for the utilization estimate (overridden by
#: telemetry.device.cost.hbm.gbps): an H100 SXM's 3.35 TB/s of HBM3
_DEFAULT_HBM_GBPS = 3350.0

#: rate window for the live utilization estimate (seconds)
_RATE_WINDOW_S = 60

#: pending-capture bound: builds are rare; a burst beyond this simply
#: drops the oldest uncaptured executable
_MAX_PENDING = 32

#: distinct executables retained per logical function
_MAX_PER_FN = 8

#: the fields a cost source returns (ExecutableCost's, snake case)
COST_FIELDS = ("flops", "bytes_accessed", "arg_bytes", "output_bytes",
               "temp_bytes", "alias_bytes", "code_bytes")


def work_source(work: Dict[str, List[float]], **memory) -> Callable[[], dict]:
    """A cost source from a work-ledger table (stem → [launches, bytes,
    operations], ``ops/kernels.py: WORK``) and the executable's memory
    fields (``arg_bytes`` …): its bytes and operations a call are the
    table's sums.  Holds numbers only."""
    fields = {"flops": float(sum(r[2] for r in work.values())),
              "bytes_accessed": float(sum(r[1] for r in work.values())),
              **memory}
    return lambda: dict(fields)


class ExecutableCost:
    """Cost/memory of one built executable."""

    __slots__ = ("signature", "flops", "bytes_accessed", "arg_bytes",
                 "output_bytes", "temp_bytes", "code_bytes", "alias_bytes",
                 "captured_unix", "num_devices", "per_device")

    def __init__(self, signature: tuple):
        self.signature = signature
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.arg_bytes = 0
        self.output_bytes = 0
        self.temp_bytes = 0
        self.code_bytes = 0
        #: outputs written into their inputs' buffers (the step loop's
        #: static buffers are updated in place: 0, nothing aliased apart)
        self.alias_bytes = 0
        self.captured_unix = 0.0
        #: cards the executable runs on (one until a mesh exists)
        self.num_devices = 1
        #: per-device cost rows (empty on one card)
        self.per_device: list = []

    def to_json(self) -> dict:
        out = {
            "flops": self.flops,
            "bytesAccessed": self.bytes_accessed,
            "argBytes": self.arg_bytes,
            "outputBytes": self.output_bytes,
            "tempBytes": self.temp_bytes,
            "aliasBytes": self.alias_bytes,
            "codeBytes": self.code_bytes,
            "devices": self.num_devices,
        }
        if self.per_device:
            out["perDevice"] = list(self.per_device)
        return out


class DeviceCostMonitor:
    """Process-wide per-executable cost state (module singleton below,
    reconfigured once by bootstrap)."""

    def __init__(self, enabled: bool = True,
                 hbm_gbps: float = _DEFAULT_HBM_GBPS):
        self.enabled = enabled
        self.hbm_gbps = float(hbm_gbps)
        self._lock = threading.Lock()
        #: fn name → {signature: ExecutableCost}
        self._costs: Dict[str, Dict[tuple, ExecutableCost]] = {}
        #: fn name → deque of [second, calls] buckets (Meter-style O(1))
        self._call_buckets: Dict[str, deque] = {}
        self._call_totals: Dict[str, int] = {}
        #: builds waiting for a cost capture: (name, signature, source)
        self._pending: deque = deque(maxlen=_MAX_PENDING)
        self.captures = 0
        self.capture_failures = 0

    # ---- configuration ----------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  hbm_gbps: Optional[float] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if hbm_gbps is not None:
                self.hbm_gbps = max(1e-9, float(hbm_gbps))

    def reset(self) -> None:
        with self._lock:
            self._costs.clear()
            self._call_buckets.clear()
            self._call_totals.clear()
            self._pending.clear()
            self.captures = 0
            self.capture_failures = 0

    # ---- recording hooks --------------------------------------------------------
    def note_call(self, name: str, n: int = 1) -> None:
        """``n`` calls of executable ``name`` (chunk replays, rounds,
        verdict calls)."""
        if not self.enabled:
            return
        sec = int(time.time())
        with self._lock:
            buckets = self._call_buckets.get(name)
            if buckets is None:
                buckets = self._call_buckets[name] = deque(
                    maxlen=_RATE_WINDOW_S)
            if buckets and buckets[-1][0] == sec:
                buckets[-1][1] += n
            else:
                buckets.append([sec, n])
            self._call_totals[name] = self._call_totals.get(name, 0) + n

    def known(self, name: str, signature: tuple) -> bool:
        """Whether ``name`` at ``signature`` was captured or is queued."""
        with self._lock:
            return (signature in self._costs.get(name, {})
                    or any(p[0] == name and p[1] == signature
                           for p in self._pending))

    def note_compile(self, name: str, signature: tuple,
                     source: Callable[[], Dict[str, float]]) -> None:
        """A build was made: queue a cost capture for later.  ``source``
        returns the :data:`COST_FIELDS` it knows (held small: no tensor
        of the call is kept alive by it)."""
        if not self.enabled:
            return
        with self._lock:
            if signature in self._costs.get(name, {}):
                return
            self._pending.append((name, signature, source))

    # ---- capture (off the hot path) ---------------------------------------------
    def capture_pending(self, max_captures: int = 1) -> int:
        """Materialize up to ``max_captures`` queued cost captures.  Pumped
        from the SLO observatory's maintenance tick, never a request
        thread.  Returns the number captured; never raises."""
        done = 0
        while done < max_captures:
            with self._lock:
                if not self._pending or not self.enabled:
                    return done
                name, signature, source = self._pending.popleft()
            cost = self._capture_one(name, signature, source)
            with self._lock:
                if cost is None:
                    self.capture_failures += 1
                    continue
                per_fn = self._costs.setdefault(name, {})
                if len(per_fn) < _MAX_PER_FN:
                    per_fn[signature] = cost
                self.captures += 1
            done += 1
        return done

    @staticmethod
    def _capture_one(name: str, signature: tuple,
                     source: Callable[[], Dict[str, float]],
                     ) -> Optional[ExecutableCost]:
        try:
            fields = source()
            cost = ExecutableCost(signature)
            for key in COST_FIELDS:
                if key in fields:
                    setattr(cost, key, type(getattr(cost, key))(fields[key]))
            cost.captured_unix = round(time.time(), 3)
            return cost
        except Exception:
            # cost capture is best-effort observability: it must not break
            # the server
            LOG.exception("device-cost capture failed for %s", name)
            return None

    # ---- readers ----------------------------------------------------------------
    def _rate_per_s(self, name: str, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        cutoff = int(now) - _RATE_WINDOW_S
        buckets = self._call_buckets.get(name)
        if not buckets:
            return 0.0
        calls = sum(c for s, c in buckets if s >= cutoff)
        return calls / float(_RATE_WINDOW_S)

    def per_function(self, detail: bool = False) -> Dict[str, dict]:
        """fn → aggregated cost view (worst-case executable per metric,
        call totals, live rate).  ``detail`` adds the per-executable
        breakdown (``perExecutable`` rows keyed by signature) — the ``GET
        /diagnostics`` surface, beside the measured kernel budget."""
        with self._lock:
            names = sorted(set(self._costs) | set(self._call_totals))
            out = {}
            for name in names:
                per = self._costs.get(name, {})
                entry: Dict[str, Any] = {
                    "executables": len(per),
                    "calls": self._call_totals.get(name, 0),
                    "callRatePerS": round(self._rate_per_s(name), 4),
                }
                if per:
                    entry["flops"] = max(c.flops for c in per.values())
                    entry["bytesAccessed"] = max(
                        c.bytes_accessed for c in per.values())
                    entry["argBytes"] = max(
                        c.arg_bytes for c in per.values())
                    entry["outputBytes"] = max(
                        c.output_bytes for c in per.values())
                    entry["tempBytes"] = max(
                        c.temp_bytes for c in per.values())
                    entry["aliasBytes"] = max(
                        c.alias_bytes for c in per.values())
                    if detail:
                        entry["perExecutable"] = [
                            {
                                "signature": repr(c.signature)[:240],
                                "capturedUnix": c.captured_unix,
                                **c.to_json(),
                            }
                            for c in per.values()
                        ]
                out[name] = entry
            return out

    def hbm_utilization(self) -> float:
        """Live HBM-bandwidth utilization estimate in [0, ∞): captured
        per-call bytes × the live call rate over the assumed bandwidth.
        0.0 until both a capture and calls exist."""
        per = self.per_function()
        bandwidth = self.hbm_gbps * 1e9
        total = 0.0
        for entry in per.values():
            total += entry.get("bytesAccessed", 0.0) * entry["callRatePerS"]
        return total / bandwidth

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def summary(self, detail: bool = False) -> dict:
        """JSON view (flight-recorder artifact, diagnostics).  ``detail``
        includes the per-executable breakdown."""
        return {
            "enabled": self.enabled,
            "hbmGbps": self.hbm_gbps,
            "captures": self.captures,
            "captureFailures": self.capture_failures,
            "pendingCaptures": self.pending(),
            "hbmUtilization": round(self.hbm_utilization(), 6),
            "functions": self.per_function(detail=detail),
        }

    def families(self) -> List[tuple]:
        """``extra_families`` rows for the Prometheus exposition:
        per-``fn`` ``cc_device_*`` gauges."""
        per = self.per_function()
        if not per:
            return []
        fams = []
        for fam, field, help_ in (
            ("cc_device_flops", "flops",
             "Work-model operations per call of the built executable "
             "(a captured step chunk, a round, a what-if call)"),
            ("cc_device_bytes_accessed", "bytesAccessed",
             "Work-model HBM bytes per call"),
            ("cc_device_hbm_arg_bytes", "argBytes",
             "Static input buffer bytes resident per call"),
            ("cc_device_hbm_output_bytes", "outputBytes",
             "Output buffer bytes per call"),
            ("cc_device_hbm_temp_bytes", "tempBytes",
             "Allocator growth across the build (a captured graph's "
             "private pool)"),
            ("cc_device_hbm_alias_bytes", "aliasBytes",
             "Output bytes aliased into separate input buffers per call "
             "(0: the step loop updates its buffers in place)"),
            ("cc_device_call_rate_per_s", "callRatePerS",
             "Calls per second (60s window)"),
        ):
            rows = [({"fn": name}, float(entry.get(field, 0.0)))
                    for name, entry in per.items() if field in entry]
            if rows:
                fams.append((fam, "gauge", help_, rows))
        fams.append((
            "cc_device_hbm_utilization_estimate", "gauge",
            "Estimated HBM bandwidth utilization (work-model bytes/call x "
            "live call rate / assumed bandwidth)",
            [({}, float(self.hbm_utilization()))],
        ))
        return fams

    def install_gauges(self, registry) -> None:
        """Registry gauges (GET /state JSON + flight-recorder series)."""
        registry.gauge("device.cost.hbm.utilization",
                       lambda: float(self.hbm_utilization()))
        registry.gauge("device.cost.pending.captures",
                       lambda: float(self.pending()))


#: process-wide default (bootstrap reconfigures it from the
#: telemetry.device.cost.* keys)
MONITOR = DeviceCostMonitor()


# module-level conveniences bound to the default instance -------------------------
def configure(enabled: Optional[bool] = None,
              hbm_gbps: Optional[float] = None) -> None:
    MONITOR.configure(enabled, hbm_gbps)


def enabled() -> bool:
    return MONITOR.enabled


def capture_pending(max_captures: int = 1) -> int:
    return MONITOR.capture_pending(max_captures)


def install_gauges(registry) -> None:
    MONITOR.install_gauges(registry)


def reset() -> None:
    MONITOR.reset()

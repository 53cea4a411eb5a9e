"""Build / capture / retrace / live-buffer observability.

The port's counterpart of the reference's ``telemetry/device_stats.py``
(XLA compiles), with its public names and its ``cc_jit_*`` families.  The
port's "compiles" are the two things that make a cold first plan slow:

* **a kernel library's build or load** (``ops/kernels.py: load``), as
  the logical function ``ops.kernels.<name>``, timed with its ``nvcc``
  seconds; a library already in ``build/torch_kernels/`` when the
  process first loads it is a persistent-cache hit
  (:meth:`DeviceStatsMonitor.note_persistent_get`), a library the process
  builds is a miss and a put.  The loader tells its listeners
  (``ops/kernels.py: LISTENERS``); this module registers its probe there
  at import (:func:`install_kernel_probe`), as the reference installs its
  persistent-cache probe;
* **a step-chunk capture** (``analyzer/step_graph.py``), as the logical
  function ``analyzer.scan_fn``: the eager first step and the CUDA-graph
  capture, timed.  Its signature is the step loop's key (the
  ``_LOOPS`` key: device, shapes, config, chunk), so the **retrace
  detector** counts the distinct loop keys a process captured for: more
  than ``retrace_threshold`` is shape churn, surfaced as a warn log and
  ``cc_jit_retraces_total``.

The **live-buffer gauges** read the card's caching allocator: the bytes
held by live tensors (``torch.cuda.memory_allocated``) and the count of
its active blocks (``memory_stats()["active.all.current"]``), registered
under the reference's names ``jax.live.buffer.bytes`` /
``jax.live.buffers``, so the SLO objective ``memory.live.buffer.mb`` and
the flight recorder read them unchanged.  Both are 0 without a card.

A disabled monitor costs one attribute check per recording site.
Thread-safe: one small lock around the per-function tables.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("device_stats")

_DEFAULT_RETRACE_THRESHOLD = 8


class FunctionCompileStats:
    """Per-logical-function compile accounting."""

    __slots__ = ("name", "compiles", "compile_s", "signatures",
                 "retraces", "warned")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.compile_s = 0.0
        self.signatures: set = set()
        self.retraces = 0
        self.warned = False

    def to_json(self) -> dict:
        return {
            "compiles": self.compiles,
            "compileSec": round(self.compile_s, 6),
            "distinctShapes": len(self.signatures),
            "retraces": self.retraces,
        }


class DeviceStatsMonitor:
    """Process-wide build/capture/retrace/live-buffer state (module
    singleton below, reconfigured once by bootstrap — the recording sites
    are module-level code that never sees a constructor)."""

    def __init__(self, enabled: bool = True,
                 retrace_threshold: int = _DEFAULT_RETRACE_THRESHOLD):
        self.enabled = enabled
        self.retrace_threshold = max(2, int(retrace_threshold))
        self._lock = threading.Lock()
        self._fns: Dict[str, FunctionCompileStats] = {}
        self.persistent_cache_hits = 0
        self.persistent_cache_misses = 0
        self.persistent_cache_puts = 0

    # ---- configuration ----------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  retrace_threshold: Optional[int] = None) -> None:
        # record_compile() reads retrace_threshold under the lock from
        # whatever thread compiles — configuration takes it too
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if retrace_threshold is not None:
                self.retrace_threshold = max(2, int(retrace_threshold))

    def reset(self) -> None:
        with self._lock:
            self._fns.clear()
            self.persistent_cache_hits = 0
            self.persistent_cache_misses = 0
            self.persistent_cache_puts = 0

    # ---- recording --------------------------------------------------------------
    def record_compile(self, name: str, seconds: float,
                       signature: tuple) -> None:
        """One build, load or capture of logical function ``name`` that
        took ``seconds``; ``signature`` keys its distinct shapes."""
        if not self.enabled:
            return
        with self._lock:
            st = self._fns.get(name)
            if st is None:
                st = self._fns[name] = FunctionCompileStats(name)
            st.compiles += 1
            st.compile_s += seconds
            st.signatures.add(signature)
            retrace = len(st.signatures) > self.retrace_threshold
            if retrace:
                st.retraces += 1
            warn = retrace and not st.warned
            if warn:
                st.warned = True
            distinct = len(st.signatures)
        if warn:
            LOG.warning(
                "retrace churn: %s was captured for %d distinct step-loop "
                "keys (threshold %d) — callers are feeding varying shapes "
                "or configs into one search; pad or bucket them "
                "(cc_jit_retraces_total{fn=\"%s\"} is counting)",
                name, distinct, self.retrace_threshold, name,
            )

    def note_persistent_get(self, hit: bool) -> None:
        if not self.enabled:
            return
        with self._lock:
            if hit:
                self.persistent_cache_hits += 1
            else:
                self.persistent_cache_misses += 1

    def note_persistent_put(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.persistent_cache_puts += 1

    # ---- readers ----------------------------------------------------------------
    def summary(self) -> dict:
        """JSON view (flight-recorder artifact, diagnostics)."""
        with self._lock:
            fns = {n: st.to_json() for n, st in sorted(self._fns.items())}
            hits, misses, puts = (self.persistent_cache_hits,
                                  self.persistent_cache_misses,
                                  self.persistent_cache_puts)
        live_n, live_b = self.live_buffer_stats()
        return {
            "enabled": self.enabled,
            "retraceThreshold": self.retrace_threshold,
            "functions": fns,
            "persistentCache": {"hits": hits, "misses": misses,
                                "puts": puts},
            "liveBuffers": live_n,
            "liveBufferBytes": live_b,
        }

    def totals(self) -> Dict[str, float]:
        """Cumulative counters for rate sampling (flight recorder)."""
        with self._lock:
            compiles = sum(st.compiles for st in self._fns.values())
            compile_s = sum(st.compile_s for st in self._fns.values())
            retraces = sum(st.retraces for st in self._fns.values())
        return {
            "jit.compiles": float(compiles),
            "jit.compile.seconds": round(compile_s, 6),
            "jit.retraces": float(retraces),
        }

    def per_function(self) -> Dict[str, dict]:
        with self._lock:
            return {n: st.to_json() for n, st in sorted(self._fns.items())}

    def live_buffer_stats(self) -> Tuple[int, int]:
        """(active allocator blocks, allocated bytes) on the current card;
        (0, 0) without one or when disabled."""
        if not self.enabled:
            return 0, 0
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return 0, 0
        stats = torch.cuda.memory_stats()
        return (int(stats.get("active.all.current", 0)),
                int(torch.cuda.memory_allocated()))

    def install_gauges(self, registry) -> None:
        """Register live-buffer gauges on the shared registry (GET /state
        JSON + /metrics gauge families + flight-recorder series), under
        the reference's names."""
        registry.gauge("jax.live.buffers",
                       lambda: float(self.live_buffer_stats()[0]))
        registry.gauge("jax.live.buffer.bytes",
                       lambda: float(self.live_buffer_stats()[1]))


#: process-wide default (bootstrap reconfigures it from the
#: telemetry.device.stats.* keys)
MONITOR = DeviceStatsMonitor()


# module-level conveniences bound to the default instance -------------------------
def configure(enabled: Optional[bool] = None,
              retrace_threshold: Optional[int] = None) -> None:
    MONITOR.configure(enabled, retrace_threshold)


def enabled() -> bool:
    return MONITOR.enabled


def install_gauges(registry) -> None:
    MONITOR.install_gauges(registry)


def reset() -> None:
    MONITOR.reset()


class _KernelProbe:
    """The kernel loader's listener: counts into whatever :data:`MONITOR`
    is at the time of the build or load."""

    @staticmethod
    def on_kernel_put(name: str) -> None:
        MONITOR.note_persistent_put()

    @staticmethod
    def on_kernel_load(name: str, seconds: float, library: str,
                       built: bool) -> None:
        MONITOR.note_persistent_get(hit=not built)
        MONITOR.record_compile(f"ops.kernels.{name}", seconds, (library,))


_PROBE = _KernelProbe()


def install_kernel_probe() -> None:
    """Count the kernel libraries' builds and loads (idempotent)."""
    kernels.add_listener(_PROBE)


install_kernel_probe()

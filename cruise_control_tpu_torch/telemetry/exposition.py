"""Prometheus text-format exposition of the metric registry + span-derived
phase timers (upstream exposes its Dropwizard ``MetricRegistry`` through
JMX; the operational analog here is ``GET /metrics`` in the format every
scraper already speaks — text/plain; version=0.0.4).

Rendering rules (one metric family per registry entry):

* Counter   -> ``<name>_total`` counter
* Meter     -> ``<name>_total`` counter + ``<name>_rate_per_s`` gauge
* Timer     -> ``<name>_seconds`` HISTOGRAM (log-spaced ``_bucket`` series
  + ``_sum``/``_count``) + ``<name>_seconds_max`` gauge.  Histograms, not
  quantile summaries: buckets aggregate across instances and admit
  ``histogram_quantile()``; precomputed p50/p99 stay on the JSON surface.
* Histogram -> ``<name>`` histogram (``_bucket``/``_sum``/``_count``)
* Gauge     -> gauge (non-numeric callables are skipped — a broken gauge
  must not corrupt the whole scrape)
* Phases    -> ``cc_phase_seconds_total`` / ``cc_phase_self_seconds_total``
  / ``cc_phase_count_total`` with a ``phase`` label per span path
* Device    -> ``cc_jit_compile_total`` / ``cc_jit_compile_seconds_total``
  / ``cc_jit_retraces_total`` (``fn`` label per logical function — a
  kernel library's build or load, ``ops.kernels.<name>``, and the step
  chunk's CUDA-graph capture, ``analyzer.scan_fn`` — + an ``all``
  aggregate) + the kernel build cache's counters, from
  :mod:`telemetry.device_stats` (rendered whenever the span layer is —
  i.e. on the server path)
* Cost      -> ``cc_device_flops`` / ``cc_device_bytes_accessed`` /
  ``cc_device_hbm_{arg,output,temp}_bytes`` / ``cc_device_call_rate_per_s``
  (``fn`` label) + ``cc_device_hbm_utilization_estimate``, from
  :mod:`telemetry.device_cost` — already-captured costs only, a scrape
  never computes one
* Kernel    -> ``cc_kernel_busy_ms/count/bytes{category=}`` +
  ``cc_kernel_hbm_utilization_measured`` + ``cc_shard_busy_ms{device=}``
  / ``cc_shard_skew``, from :mod:`telemetry.kernel_budget`'s latest
  PARSED capture — a scrape never parses a trace
* Mesh      -> ``cc_collective_*`` / ``cc_transfer_*`` / ``cc_mesh_*``
  from :mod:`telemetry.mesh_budget`'s latest parsed capture and audit
* Locks     -> ``cc_lock_wait_ms`` / ``cc_lock_hold_ms`` /
  ``cc_lock_acquisitions_total`` from :mod:`utils.locks`' contention
  counters
* Host      -> ``cc_host_*`` summary gauges of :mod:`telemetry.host_profile`'s
  sampling profiler (rendered beside the lock families while it is enabled)

Registry names like ``proposal-computation-timer`` or ``http.GET.state``
are sanitized to the ``[a-zA-Z_:][a-zA-Z0-9_:]*`` metric grammar and
prefixed ``cc_`` so the scrape namespace is unambiguous.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.telemetry import (
    device_cost,
    device_stats,
    host_profile,
    kernel_budget,
    mesh_budget,
    profile,
)
from cruise_control_tpu_torch.telemetry.tracing import Telemetry
from cruise_control_tpu_torch.utils import locks
from cruise_control_tpu_torch.utils.metrics import MetricRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

#: (family_name, type, help, [(labels, value), ...]) — the shape callers
#: (the HTTP server's anomaly-action counters) pass as ``extra_families``
ExtraFamily = Tuple[str, str, str, Sequence[Tuple[Dict[str, str], float]]]


def _metric_name(raw: str, suffix: str = "") -> str:
    name = _NAME_BAD.sub("_", raw)
    if not re.match(r"[a-zA-Z_:]", name):
        name = "_" + name
    return f"cc_{name}{suffix}"


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt(value: float) -> str:
    # Prometheus accepts full-precision floats; repr keeps them exact and
    # round-trippable
    return repr(float(value))


def _le(bound: float) -> str:
    return "+Inf" if bound == float("inf") else repr(float(bound))


def _histogram_lines(lines: List[str], name: str, help_: str,
                     buckets, total: float, count: int) -> None:
    """Emit one ``<name>`` histogram family from cumulative buckets."""
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} histogram")
    for bound, cum in buckets:
        lines.append(f'{name}_bucket{{le="{_le(bound)}"}} {_fmt(cum)}')
    lines.append(f"{name}_sum {_fmt(total)}")
    lines.append(f"{name}_count {_fmt(count)}")


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _device_stats_lines(lines: List[str]) -> None:
    mon = device_stats.MONITOR
    per = mon.per_function()
    for metric, field, help_ in (
        ("cc_jit_compile_total", "compiles",
         "Kernel library builds or loads (ops.kernels.<name>) and step "
         "chunk captures (analyzer.scan_fn) per logical function"),
        ("cc_jit_compile_seconds_total", "compileSec",
         "Wall-clock spent building (nvcc) or loading a kernel library, "
         "or running a chunk's eager first step and capture, per logical "
         "function"),
        ("cc_jit_retraces_total", "retraces",
         "Captures beyond the distinct step-loop key threshold (shape "
         "churn) per logical function"),
    ):
        lines.append(f"# HELP {metric} {help_}")
        lines.append(f"# TYPE {metric} counter")
        total = 0.0
        for fn, st in per.items():
            total += st[field]
            lines.append(
                f'{metric}{{fn="{_escape_label(fn)}"}} {_fmt(st[field])}'
            )
        lines.append(f'{metric}{{fn="all"}} {_fmt(total)}')
    if per:
        lines.append("# HELP cc_jit_distinct_shapes Distinct libraries or "
                     "step-loop keys built per logical function")
        lines.append("# TYPE cc_jit_distinct_shapes gauge")
        for fn, st in per.items():
            lines.append(
                f'cc_jit_distinct_shapes{{fn="{_escape_label(fn)}"}} '
                f"{_fmt(st['distinctShapes'])}"
            )
    for metric, value, help_ in (
        ("cc_jit_persistent_cache_hits_total", mon.persistent_cache_hits,
         "Kernel libraries found built on disk at first load"),
        ("cc_jit_persistent_cache_misses_total", mon.persistent_cache_misses,
         "Kernel libraries this process built before first load"),
        ("cc_jit_persistent_cache_puts_total", mon.persistent_cache_puts,
         "Kernel libraries built into the build cache"),
    ):
        lines.append(f"# HELP {metric} {help_}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(value)}")


def render_prometheus(
    registry: MetricRegistry,
    telemetry: Optional[Telemetry] = None,
    extra_families: Optional[Sequence[ExtraFamily]] = None,
) -> str:
    """Render the registry (+ phase timers and device/compile stats when
    ``telemetry`` is given) as Prometheus text exposition format 0.0.4.

    Snapshot-then-render discipline (ISSUE 18): ONE locked table copy
    (``scrape_parts``), then every per-metric read happens off the
    registry lock and every reservoir is copied under its own lock and
    sorted OFF it.  The previous shape called ``registry.snapshot()`` —
    rendering (and discarding) timer/histogram JSON, then re-snapshotting
    every timer — so each scrape sorted every 1024-sample reservoir four
    times with request threads' ``update()`` calls blocked behind the
    in-lock sorts."""
    counters, meters, gauges, timers, histograms = registry.scrape_parts()
    lines: List[str] = []

    for raw in sorted(counters):
        name = _metric_name(raw, "_total")
        lines.append(f"# HELP {name} Counter {raw}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(counters[raw].count)}")

    for raw in sorted(meters):
        m = meters[raw].snapshot()
        name = _metric_name(raw, "_total")
        lines.append(f"# HELP {name} Meter {raw}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(m['count'])}")
        rate = _metric_name(raw, "_rate_per_s")
        lines.append(f"# HELP {rate} Lifetime mean rate of {raw}")
        lines.append(f"# TYPE {rate} gauge")
        lines.append(f"{rate} {_fmt(m['meanRatePerSec'])}")

    # live Timer/Histogram objects, not their JSON snapshots: the bucket
    # emission needs the cumulative counts, which the JSON surface rounds
    # into a {le: count} dict keyed by repr
    for raw, timer in sorted(timers.items()):
        t = timer.snapshot()
        name = _metric_name(raw, "_seconds")
        _histogram_lines(lines, name, f"Timer {raw}",
                         timer.cumulative_buckets(), t["sumSec"], t["count"])
        mx = _metric_name(raw, "_seconds_max")
        lines.append(f"# HELP {mx} Max duration of {raw}")
        lines.append(f"# TYPE {mx} gauge")
        lines.append(f"{mx} {_fmt(t['maxSec'])}")

    for raw, hist in sorted(histograms.items()):
        h = hist.snapshot()
        _histogram_lines(lines, _metric_name(raw), f"Histogram {raw}",
                         hist.cumulative_buckets(), h["sum"], h["count"])

    for raw in sorted(gauges):
        try:
            v = gauges[raw]()
        except Exception:  # cclint: disable=swallowed-exception -- a broken gauge must not corrupt the scrape; GET /state surfaces its error string
            continue
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue  # error strings / non-numerics are unrepresentable
        name = _metric_name(raw)
        lines.append(f"# HELP {name} Gauge {raw}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(v)}")

    if telemetry is not None:
        tree = profile.phase_tree(telemetry)
        if tree:
            for metric, field, help_ in (
                ("cc_phase_seconds_total", "total_s",
                 "Cumulative wall-clock per traced phase"),
                ("cc_phase_self_seconds_total", "self_s",
                 "Cumulative wall-clock per traced phase excluding "
                 "traced children"),
                ("cc_phase_count_total", "count",
                 "Completed spans per traced phase"),
            ):
                lines.append(f"# HELP {metric} {help_}")
                lines.append(f"# TYPE {metric} counter")
                for path, ent in tree.items():
                    lines.append(
                        f'{metric}{{phase="{_escape_label(path)}"}} '
                        f"{_fmt(ent[field])}"
                    )
        _device_stats_lines(lines)
        # per-executable device-cost gauges (cc_device_*): rendered only
        # from ALREADY-captured analyses — a scrape never compiles
        device_families = device_cost.MONITOR.families() \
            if device_cost.MONITOR.enabled else ()
        # measured kernel-budget gauges (cc_kernel_* / cc_shard_*): the
        # latest PARSED capture only — a scrape never parses a trace
        kernel_families = kernel_budget.CAPTURE.families() \
            if kernel_budget.CAPTURE.enabled else ()
        # mesh-observatory gauges (cc_collective_* / cc_transfer_* /
        # cc_mesh_*): latest parsed mesh capture + replication audit
        mesh_families = mesh_budget.MESH.families() \
            if mesh_budget.MESH.enabled else ()
        # host observatory: named-lock contention counters
        # (cc_lock_wait_ms / cc_lock_hold_ms / cc_lock_acquisitions_total)
        # + the sampling profiler's summary gauges (cc_host_*)
        lock_families = locks.CONTENTION.families()
        host_families = host_profile.PROFILER.families() \
            if host_profile.PROFILER.enabled else ()
        device_families = (tuple(device_families) + tuple(kernel_families)
                           + tuple(mesh_families) + tuple(lock_families)
                           + tuple(host_families))
    else:
        device_families = ()

    for fam_name, fam_type, fam_help, rows in (
            tuple(device_families) + tuple(extra_families or ())):
        lines.append(f"# HELP {fam_name} {fam_help}")
        lines.append(f"# TYPE {fam_name} {fam_type}")
        for labels, value in rows:
            lines.append(f"{fam_name}{_labels(labels)} {_fmt(value)}")

    return "\n".join(lines) + "\n"

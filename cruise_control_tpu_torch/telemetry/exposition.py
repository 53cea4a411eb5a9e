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
* Locks     -> ``cc_lock_wait_ms`` / ``cc_lock_hold_ms`` /
  ``cc_lock_acquisitions_total`` from :mod:`utils.locks`' contention
  counters (rendered whenever the span layer is — i.e. on the server path)
* Host      -> ``cc_host_*`` summary gauges of :mod:`telemetry.host_profile`'s
  sampling profiler (rendered beside the lock families while it is enabled)

The reference's device families (compile counts, per-executable device
cost, measured kernel and mesh budgets) are not ported yet (ROADMAP.md A10
(device telemetry)).

Registry names like ``proposal-computation-timer`` or ``http.GET.state``
are sanitized to the ``[a-zA-Z_:][a-zA-Z0-9_:]*`` metric grammar and
prefixed ``cc_`` so the scrape namespace is unambiguous.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.telemetry import host_profile, profile
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


def render_prometheus(
    registry: MetricRegistry,
    telemetry: Optional[Telemetry] = None,
    extra_families: Optional[Sequence[ExtraFamily]] = None,
) -> str:
    """Render the registry (+ phase timers and lock contention when
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
        # host observatory: named-lock contention counters
        # (cc_lock_wait_ms / cc_lock_hold_ms / cc_lock_acquisitions_total)
        # + the sampling profiler's summary gauges (cc_host_*)
        host_families = host_profile.PROFILER.families() \
            if host_profile.PROFILER.enabled else ()
        families = (tuple(locks.CONTENTION.families())
                    + tuple(host_families))
    else:
        families = ()

    for fam_name, fam_type, fam_help, rows in (
            families + tuple(extra_families or ())):
        lines.append(f"# HELP {fam_name} {fam_help}")
        lines.append(f"# TYPE {fam_name} {fam_type}")
        for labels, value in rows:
            lines.append(f"{fam_name}{_labels(labels)} {_fmt(value)}")

    return "\n".join(lines) + "\n"

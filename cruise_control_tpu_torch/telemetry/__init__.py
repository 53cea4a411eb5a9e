"""Telemetry subsystem: structured tracing spans (:mod:`tracing`),
phase-tree profiling artifacts (:mod:`profile`), Prometheus text
exposition of the metric registry + span timers (:mod:`exposition`),
JAX compile/retrace/live-buffer observability (:mod:`device_stats`),
per-executable device-cost capture (:mod:`device_cost`), the flight
recorder's retained time series + event journal (:mod:`recorder`,
``GET /diagnostics``), end-to-end trace correlation (:mod:`trace`,
``GET /trace?id=``), and the journal-driven SLO engine (:mod:`slo`,
``GET /slo``).

The upstream analog is the Dropwizard ``MetricRegistry`` wired through
every subsystem and exposed via JMX plus the ``AnomalyDetectorState``
history (SURVEY.md §5.1); this build keeps ``utils/metrics.py`` as the
counter/timer/histogram registry and adds the span, compile-attribution
and recorded-history layers on top so every perf claim ships with its own
phase breakdown and every incident leaves a crash-readable artifact.
"""

from cruise_control_tpu_torch.telemetry.tracing import (  # noqa: F401
    NOOP,
    TELEMETRY,
    SpanRecord,
    Telemetry,
    annotate,
    configure,
    device_span,
    enabled,
    recent_roots,
    reset,
    span,
    traced,
)

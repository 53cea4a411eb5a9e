"""Counterfactual what-if engine, on the card.

Compiles hypothetical futures — broker/rack loss, traffic ×k, planned
maintenance, topic growth, expressed in the timeline-DSL vocabulary —
into perturbed model batches and evaluates every future in ONE kernel
call (hand kernel K12 over a stacked leading futures axis, padded to a
power of two so request sizes share a handful of shapes).  The
proactive scheduler projects the workload's diurnal peak and rebalances
*before* the projected breach (``proactive.*`` journal kinds).
"""

from cruise_control_tpu_torch.whatif.cache import WhatifCache
from cruise_control_tpu_torch.whatif.compiler import FutureBatch, compile_futures
from cruise_control_tpu_torch.whatif.engine import evaluate_batch, verdicts
from cruise_control_tpu_torch.whatif.futures import (
    FutureEvent,
    FutureSpec,
    broker_loss,
    hot_partitions,
    likely_futures,
    maintenance,
    parse_future,
    rack_loss,
    topic_growth,
    traffic_scale,
)
from cruise_control_tpu_torch.whatif.proactive import ProactiveScheduler

__all__ = [
    "FutureBatch",
    "FutureEvent",
    "FutureSpec",
    "ProactiveScheduler",
    "WhatifCache",
    "broker_loss",
    "compile_futures",
    "evaluate_batch",
    "hot_partitions",
    "likely_futures",
    "maintenance",
    "parse_future",
    "rack_loss",
    "topic_growth",
    "traffic_scale",
    "verdicts",
]

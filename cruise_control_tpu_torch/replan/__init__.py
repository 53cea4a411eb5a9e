"""Incremental re-optimization — the delta-replan subsystem.

A production Cruise Control re-plans continuously as metric windows roll
and brokers come and go (SURVEY.md §3.3/§3.5); cold-starting every
optimization re-derives a world that is ~99% identical to the previous
one.  This package closes the loop the precompute daemon drives:

* :mod:`delta` — the structured :class:`ModelDelta` the monitor exposes
  alongside ``model_generation()`` (dirty partitions/brokers across
  window rolls and topology changes), plus the :class:`WarmStart` /
  :class:`ReplanCarry` records the engines consume;
* :mod:`planner` — :class:`DeltaReplanner`, which turns a generation
  bump into a delta model build (patch the previous ``ClusterState``
  rows in place), a warm-started search (seeded from the previous
  plan's placement, riding the previous device context and pool row
  tables), and a partial re-verification (per-goal input signatures),
  falling back to the cold path whenever the delta exceeds its budget
  or the model shape drifts.
"""

from cruise_control_tpu_torch.replan.delta import (  # noqa: F401
    ModelDelta,
    ReplanCarry,
    WarmStart,
)
from cruise_control_tpu_torch.replan.planner import (  # noqa: F401
    DeltaReplanner,
    ReplanConfig,
    ReplanSnapshot,
)

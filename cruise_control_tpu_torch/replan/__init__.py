"""Incremental re-optimization — the delta-replan subsystem.

:mod:`delta` holds the structured :class:`ModelDelta` the monitor exposes
alongside ``model_generation()`` (dirty partitions/brokers across window
rolls and topology changes), plus the :class:`WarmStart` /
:class:`ReplanCarry` records the engines consume.  The replanner itself
(``planner.DeltaReplanner``) is not ported yet (ROADMAP.md A7 (replan));
until then every proposal computation cold-starts.
"""

from cruise_control_tpu_torch.replan.delta import (  # noqa: F401
    ModelDelta,
    ReplanCarry,
    WarmStart,
)

"""Delta-replan data contracts.

Deliberately dependency-free (numpy + stdlib only): the monitor produces
a :class:`ModelDelta`, the analyzer engines consume a :class:`WarmStart`,
and neither package needs to import the other — the planner wires them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ModelDelta:
    """What changed between the previous model and the one just built.

    Exposed by ``LoadMonitor.cluster_model_delta`` alongside the model
    generation: the monitor diffs the new aggregate means and the fresh
    topology snapshot against the previous model's rows, so ``full=False``
    guarantees the new state was produced by patching the previous
    state's arrays — untouched rows are BIT-IDENTICAL, which is what lets
    the engine refresh only dirty rows of its resident pool tables.
    """

    generation: str
    prev_generation: str
    #: True = no usable delta (universe drift, disk modeling, window
    #: series, broker reindexing...) — the state was rebuilt from scratch
    #: and every consumer must treat every row as dirty.
    full: bool
    #: why the delta degraded to full ("" when it did not)
    reason: str = ""
    #: bool [P] rows whose loads/placement/offline flags changed (None
    #: when ``full``)
    dirty_partitions: Optional[np.ndarray] = None
    #: bool [P] rows whose PLACEMENT/offline flags changed (a subset of
    #: ``dirty_partitions``): the cluster itself moved them, so a warm
    #: seed must take their live placement, not the previous plan's
    dirty_topology: Optional[np.ndarray] = None
    #: bool [B] brokers whose aliveness/capacity/rack changed (None when
    #: ``full``); sized to the NEW broker axis
    dirty_brokers: Optional[np.ndarray] = None
    #: external ids appended to the broker axis (prefix-compatible adds)
    added_brokers: tuple = ()
    #: external ids that left the alive set since the previous model
    removed_brokers: tuple = ()
    #: any placement/leader/offline drift vs the previous model
    topology_changed: bool = False
    load_changed: bool = False
    #: the broker axis grew (P-axis growth always degrades to ``full``)
    shape_changed: bool = False

    @property
    def n_dirty_partitions(self) -> int:
        if self.dirty_partitions is None:
            return -1
        return int(self.dirty_partitions.sum())

    def summary(self) -> dict:
        return {
            "generation": self.generation,
            "prevGeneration": self.prev_generation,
            "full": self.full,
            "reason": self.reason or None,
            "dirtyPartitions": self.n_dirty_partitions,
            "dirtyBrokers": (
                -1 if self.dirty_brokers is None
                else int(self.dirty_brokers.sum())
            ),
            "addedBrokers": list(self.added_brokers),
            "removedBrokers": list(self.removed_brokers),
            "topologyChanged": self.topology_changed,
            "loadChanged": self.load_changed,
            "shapeChanged": self.shape_changed,
        }


@dataclasses.dataclass
class ReplanCarry:
    """Device context retained across plans (the TPU engine's half of the
    warm start).  ``model`` is the engine's :class:`DeviceModel` resynced
    to the previous plan's FINAL placement (``assignment``/``leader_slot``
    keep host copies of that placement so the next run can verify the
    carry matches its seed without a device fetch); ``tables`` the pool
    row tables returned by the last device call; ``pending_touched`` the
    partitions whose rows may have changed after those tables were
    captured (host rejections, polish, swap repair) — the next warm call
    folds them into its refresh set so the carried tables stay exact."""

    model: object = None                      # DeviceModel | None
    assignment: Optional[np.ndarray] = None   # int32 [P, S] host copy
    leader_slot: Optional[np.ndarray] = None  # int32 [P] host copy
    tables: Optional[tuple] = None            # (size [P,S], base [P,S])
    pending_touched: Optional[np.ndarray] = None  # bool [P]
    #: bool [P] rows that still carried must-move (offline) flags when the
    #: carry was captured — their pool-table repair bonuses depend on
    #: those flags, so the next warm start refreshes them unconditionally
    had_must_move: Optional[np.ndarray] = None
    valid: bool = False

    def invalidate(self) -> None:
        self.model = None
        self.assignment = None
        self.leader_slot = None
        self.tables = None
        self.pending_touched = None
        self.had_must_move = None
        self.valid = False


@dataclasses.dataclass
class WarmStart:
    """Engine-facing warm-start bundle (duck-typed by both engines).

    ``assignment``/``leader_slot``/``replica_disk`` seed the search at the
    previous plan's final placement; ``prev_actions`` are the actions that
    produced that placement from the (unchanged) initial one, prepended to
    the new search's actions so the result's accounting stays complete;
    ``dirty_partitions`` marks the rows whose model inputs changed (the
    device carry refreshes exactly those pool-table rows); the signature
    fields drive the exact partial re-verification."""

    assignment: np.ndarray
    leader_slot: np.ndarray
    replica_disk: Optional[np.ndarray] = None
    prev_actions: List = dataclasses.field(default_factory=list)
    dirty_partitions: Optional[np.ndarray] = None
    prev_signatures: Optional[Dict[str, str]] = None
    prev_violations: Optional[Dict[str, int]] = None
    #: the ``replan.full.verify`` safety net: recompute every goal even
    #: when its input signature matched
    full_verify: bool = False

"""Balancing-action vocabulary (upstream ``analyzer/BalancingAction.java``,
``ActionType.java``, ``ActionAcceptance.java``; SURVEY.md §2.5).

An action is the unit both optimizers reason about.  The greedy baseline
handles one action at a time; the TPU optimizer scores *batches* of encoded
actions, so the canonical encoding is columnar (struct-of-arrays), not
object-per-action.
"""

from __future__ import annotations

import dataclasses
import enum


class ActionType(enum.IntEnum):
    INTER_BROKER_REPLICA_MOVEMENT = 0
    LEADERSHIP_MOVEMENT = 1
    INTER_BROKER_REPLICA_SWAP = 2
    # Intra-broker (JBOD disk) actions arrive with the disk model.
    INTRA_BROKER_REPLICA_MOVEMENT = 3
    INTRA_BROKER_REPLICA_SWAP = 4


class ActionAcceptance(enum.IntEnum):
    """Upstream's three-valued verdict.  REPLICA_REJECT: retry this replica
    elsewhere; BROKER_REJECT: stop considering this destination broker."""

    ACCEPT = 0
    REPLICA_REJECT = 1
    BROKER_REJECT = 2


@dataclasses.dataclass(frozen=True)
class BalancingAction:
    """One concrete action (host-side; used by the greedy baseline and logs).

    For ``LEADERSHIP_MOVEMENT`` the destination is the follower *slot* taking
    leadership (its broker is ``dest_broker``).  For swaps, the second replica
    is (``swap_partition``, ``swap_slot``) on ``dest_broker``.
    """

    action_type: ActionType
    partition: int
    slot: int
    source_broker: int
    dest_broker: int
    dest_slot: int = -1
    swap_partition: int = -1
    swap_slot: int = -1
    #: JBOD: disk indices on the (single) broker for intra-broker moves
    source_disk: int = -1
    dest_disk: int = -1
    #: decision provenance: the goal (or engine phase) that generated this
    #: action and the pass/round it was committed in.  compare=False keeps
    #: action equality/hashing purely positional — provenance is metadata,
    #: two identical moves from different goals are still the same move.
    goal: str = dataclasses.field(default="", compare=False)
    round: int = dataclasses.field(default=-1, compare=False)

    def __str__(self) -> str:
        if self.action_type == ActionType.LEADERSHIP_MOVEMENT:
            return (
                f"Leadership(P{self.partition}: b{self.source_broker}"
                f"->b{self.dest_broker})"
            )
        if self.action_type == ActionType.INTER_BROKER_REPLICA_SWAP:
            return (
                f"Swap(P{self.partition}[s{self.slot}]@b{self.source_broker} <-> "
                f"P{self.swap_partition}[s{self.swap_slot}]@b{self.dest_broker})"
            )
        if self.action_type == ActionType.INTRA_BROKER_REPLICA_MOVEMENT:
            return (
                f"IntraMove(P{self.partition}[s{self.slot}]@b{self.source_broker}: "
                f"d{self.source_disk}->d{self.dest_disk})"
            )
        return (
            f"Move(P{self.partition}[s{self.slot}]: b{self.source_broker}"
            f"->b{self.dest_broker})"
        )

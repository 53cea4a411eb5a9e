"""Dense-tensor cluster model — the port's ``ClusterModel``.

The reference (``cruise_control_tpu.models.cluster_state``) keeps the
placement + workload as an immutable pytree of dense arrays; here it is a
frozen dataclass of torch tensors with the same field names and shapes:

* ``assignment[p, s]``       int32   broker id hosting replica slot ``s`` of
                                     partition ``p`` (``EMPTY_SLOT`` = -1).
* ``leader_slot[p]``         int32   which slot currently leads ``p``.
* ``leader_load[p, r]``      float32 load the leader replica puts on its broker.
* ``follower_load[p, r]``    float32 load each follower puts on its broker.
* ``partition_topic[p]``     int32   topic id.
* ``broker_capacity[b, r]``  float32 per-broker capacity.
* ``broker_rack[b]``         int32   rack id.
* ``broker_state[b]``        int8    :class:`BrokerState`.
* ``replica_offline[p, s]``  bool    replica must be evacuated.

Like the reference the state is host-first: array-likes passed to the
constructor (the builders hand it numpy arrays) become CPU tensors, and
:meth:`ClusterState.to` moves a state to a device.  The mutators are pure
functions returning a new state; the per-broker roll-ups are deterministic
segment sums (:mod:`cruise_control_tpu_torch.ops.segment`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    BrokerState,
    Resource,
)
from cruise_control_tpu_torch.ops.segment import segment_sum

#: fields that hold arrays (everything else is static metadata)
_ARRAY_FIELDS = (
    "assignment", "leader_slot", "leader_load", "follower_load",
    "partition_topic", "broker_capacity", "broker_rack", "broker_state",
    "replica_offline", "broker_host", "leader_load_windows",
    "follower_load_windows", "replica_disk", "disk_capacity", "disk_offline",
)


def _as_tensor(x):
    if x is None or isinstance(x, torch.Tensor):
        return x
    # a copy: numpy inputs may be read-only views, and a state must not
    # alias a caller's mutable buffer
    return torch.tensor(np.asarray(x))


@dataclasses.dataclass(frozen=True)
class ClusterState:
    """Immutable snapshot of a cluster's placement + workload (field
    semantics as in the reference; see the module doc)."""

    assignment: torch.Tensor       # int32 [P, S]
    leader_slot: torch.Tensor      # int32 [P]
    leader_load: torch.Tensor      # f32   [P, R]
    follower_load: torch.Tensor    # f32   [P, R]
    partition_topic: torch.Tensor  # int32 [P]
    broker_capacity: torch.Tensor  # f32   [B, R]
    broker_rack: torch.Tensor      # int32 [B]
    broker_state: torch.Tensor     # int8  [B]
    replica_offline: torch.Tensor  # bool  [P, S]
    broker_host: Optional[torch.Tensor] = None
    num_topics: int = 0
    broker_ids: tuple = ()
    partition_ids: tuple = ()
    topic_names: tuple = ()
    #: f32 [P, W, R] per-window load series (None = collapsed)
    leader_load_windows: Optional[torch.Tensor] = None
    follower_load_windows: Optional[torch.Tensor] = None
    #: capacity-estimation percentile over the window axis (0 = off)
    capacity_percentile: float = 0.0
    # JBOD
    replica_disk: Optional[torch.Tensor] = None
    disk_capacity: Optional[torch.Tensor] = None
    disk_offline: Optional[torch.Tensor] = None
    disk_names: tuple = ()

    def __post_init__(self):
        for name in _ARRAY_FIELDS:
            v = getattr(self, name)
            if v is not None and not isinstance(v, torch.Tensor):
                object.__setattr__(self, name, _as_tensor(v))

    def replace(self, **changes) -> "ClusterState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "ClusterState":
        """The same state with every array on ``device``."""
        return self.replace(**{
            n: getattr(self, n).to(device)
            for n in _ARRAY_FIELDS if getattr(self, n) is not None
        })

    @property
    def has_disks(self) -> bool:
        return self.disk_capacity is not None

    @property
    def max_disks(self) -> int:
        return 0 if self.disk_capacity is None else self.disk_capacity.shape[1]

    # ---- static shape accessors -------------------------------------------------
    @property
    def num_partitions(self) -> int:
        return self.assignment.shape[0]

    @property
    def max_replication_factor(self) -> int:
        return self.assignment.shape[1]

    @property
    def num_brokers(self) -> int:
        return self.broker_capacity.shape[0]

    @property
    def num_racks(self) -> int:
        return self.num_brokers

    # ---- masks ------------------------------------------------------------------
    def slot_exists(self) -> torch.Tensor:
        """bool [P, S] — true where a replica actually occupies the slot."""
        return self.assignment != EMPTY_SLOT

    def replication_factor(self) -> torch.Tensor:
        """int32 [P] — actual RF per partition."""
        return self.slot_exists().sum(dim=1).to(torch.int32)

    def broker_alive(self) -> torch.Tensor:
        """bool [B] — broker can *host* load (state != DEAD, REMOVED)."""
        return (self.broker_state != BrokerState.DEAD) & (
            self.broker_state != BrokerState.REMOVED
        )

    def broker_is_new(self) -> torch.Tensor:
        return self.broker_state == BrokerState.NEW

    def broker_is_demoted(self) -> torch.Tensor:
        return self.broker_state == BrokerState.DEMOTED

    def leader_broker(self) -> torch.Tensor:
        """int32 [P] — broker id of each partition's leader."""
        return torch.gather(
            self.assignment, 1, self.leader_slot.long()[:, None]
        )[:, 0]


# ---------------------------------------------------------------------------------
# Derived loads
# ---------------------------------------------------------------------------------

def capacity_loads(state: ClusterState):
    """(leader_cap_load, follower_cap_load) — f32 [P, R] loads capacity goals
    budget for: the per-partition percentile over the window series when
    ``capacity_percentile`` > 0, else the mean loads themselves (the same
    objects, which callers test with ``is``)."""
    if state.leader_load_windows is None or state.capacity_percentile <= 0:
        return state.leader_load, state.follower_load
    q = float(state.capacity_percentile)
    lw = state.leader_load_windows.cpu().numpy().astype(np.float32)
    fw = state.follower_load_windows.cpu().numpy().astype(np.float32)
    return (
        torch.from_numpy(np.percentile(lw, q, axis=1).astype(np.float32)),
        torch.from_numpy(np.percentile(fw, q, axis=1).astype(np.float32)),
    )


def replica_load(state: ClusterState) -> torch.Tensor:
    """f32 [P, S, R] — load each replica slot puts on its broker."""
    S = state.max_replication_factor
    is_leader = (
        torch.arange(S, device=state.assignment.device)[None, :]
        == state.leader_slot[:, None]
    )
    load = torch.where(
        is_leader[:, :, None],
        state.leader_load[:, None, :],
        state.follower_load[:, None, :],
    )
    return torch.where(state.slot_exists()[:, :, None], load,
                       torch.zeros((), dtype=load.dtype, device=load.device))


def _segment_sum_by_broker(
    values: torch.Tensor, assignment: torch.Tensor, num_brokers: int
) -> torch.Tensor:
    """Sum ``values[p, s, ...]`` into ``out[b, ...]`` grouped by
    ``assignment[p, s]``; empty slots go to a dump bucket that is dropped."""
    ids = torch.where(assignment >= 0, assignment,
                      torch.full_like(assignment, num_brokers)).reshape(-1)
    flat = values.reshape((ids.shape[0],) + tuple(values.shape[2:]))
    return segment_sum(flat, ids, num_brokers + 1)[:num_brokers]


def broker_load(
    state: ClusterState, rload: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """f32 [B, R] — total per-resource load on each broker."""
    if rload is None:
        rload = replica_load(state)
    return _segment_sum_by_broker(rload, state.assignment, state.num_brokers)


def broker_replica_count(state: ClusterState) -> torch.Tensor:
    """int32 [B] — number of replicas hosted per broker."""
    ones = state.slot_exists().to(torch.int32)[:, :, None]
    return _segment_sum_by_broker(ones, state.assignment,
                                  state.num_brokers)[:, 0]


def _leader_ids(state: ClusterState) -> torch.Tensor:
    lb = state.leader_broker()
    return torch.where(lb >= 0, lb, torch.full_like(lb, state.num_brokers))


def broker_leader_count(state: ClusterState) -> torch.Tensor:
    """int32 [B] — number of leader replicas per broker."""
    ids = _leader_ids(state)
    return segment_sum(torch.ones_like(ids), ids,
                       state.num_brokers + 1)[: state.num_brokers]


def broker_leader_load(state: ClusterState) -> torch.Tensor:
    """f32 [B, R] — load contributed only by leader replicas."""
    return segment_sum(state.leader_load, _leader_ids(state),
                       state.num_brokers + 1)[: state.num_brokers]


def broker_potential_nw_out(state: ClusterState) -> torch.Tensor:
    """f32 [B] — NW_OUT a broker would serve if it led every replica it
    hosts (upstream potential bytes-out)."""
    pot = state.leader_load[:, Resource.NW_OUT]
    per_slot = pot[:, None].expand(state.assignment.shape)
    per_slot = torch.where(state.slot_exists(), per_slot,
                           torch.zeros((), dtype=pot.dtype, device=pot.device))
    return _segment_sum_by_broker(
        per_slot[:, :, None], state.assignment, state.num_brokers
    )[:, 0]


def broker_topic_replica_count(state: ClusterState) -> torch.Tensor:
    """int32 [B, T] — replicas of each topic per broker."""
    B, T = state.num_brokers, state.num_topics
    exists = state.slot_exists()
    b = torch.where(exists, state.assignment,
                    torch.full_like(state.assignment, B)).long()
    t = state.partition_topic.long()[:, None].expand(b.shape)
    flat = (b * T + t).reshape(-1)
    out = segment_sum(torch.ones_like(flat, dtype=torch.int32), flat,
                      (B + 1) * T)
    return out[: B * T].reshape(B, T)


def broker_topic_leader_count(state: ClusterState) -> torch.Tensor:
    """int32 [B, T] — leaders of each topic per broker."""
    B, T = state.num_brokers, state.num_topics
    flat = _leader_ids(state).long() * T + state.partition_topic.long()
    out = segment_sum(torch.ones_like(flat, dtype=torch.int32), flat,
                      (B + 1) * T)
    return out[: B * T].reshape(B, T)


def replica_rack(state: ClusterState) -> torch.Tensor:
    """int32 [P, S] — rack id of each replica's broker (-1 for empty slots)."""
    a = state.assignment
    return torch.where(a >= 0, state.broker_rack[a.clamp_min(0).long()],
                       torch.full_like(a, -1))


# ---------------------------------------------------------------------------------
# Mutators → pure functions (upstream ClusterModel.relocateReplica / ...Leadership)
# ---------------------------------------------------------------------------------

def _functional_set(arr: torch.Tensor, idx, val) -> torch.Tensor:
    """Copy of ``arr`` with one element replaced."""
    out = arr.clone()
    out[idx] = val
    return out


def apply_move(state: ClusterState, partition, slot,
               dest_broker) -> ClusterState:
    """Inter-broker replica movement: move ``(partition, slot)`` to
    ``dest_broker``.  The offline flag clears: a moved replica lands on a
    healthy broker."""
    return state.replace(
        assignment=_functional_set(state.assignment, (partition, slot),
                                   int(dest_broker)),
        replica_offline=_functional_set(state.replica_offline,
                                        (partition, slot), False),
    )


def apply_leadership(state: ClusterState, partition,
                     new_leader_slot) -> ClusterState:
    """Leadership movement (upstream ``ClusterModel.relocateLeadership``)."""
    return state.replace(
        leader_slot=_functional_set(state.leader_slot, partition,
                                    int(new_leader_slot))
    )


def apply_swap(state: ClusterState, partition_a, slot_a, partition_b,
               slot_b) -> ClusterState:
    """Inter-broker replica swap: replica A and replica B trade brokers."""
    broker_a = int(state.assignment[partition_a, slot_a])
    broker_b = int(state.assignment[partition_b, slot_b])
    assignment = _functional_set(state.assignment, (partition_a, slot_a),
                                 broker_b)
    assignment[partition_b, slot_b] = broker_a
    offline = _functional_set(state.replica_offline, (partition_a, slot_a),
                              False)
    offline[partition_b, slot_b] = False
    return state.replace(assignment=assignment, replica_offline=offline)


def set_broker_state(state: ClusterState, broker,
                     new_state: BrokerState) -> ClusterState:
    """Upstream ``ClusterModel.setBrokerState``.  Marking a broker DEAD also
    marks its replicas offline."""
    bs = _functional_set(state.broker_state, broker, int(new_state))
    offline = state.replica_offline
    if new_state in (BrokerState.DEAD, BrokerState.REMOVED):
        offline = offline | (state.assignment == broker)
    return state.replace(broker_state=bs, replica_offline=offline)


# ---------------------------------------------------------------------------------
# Validation (host-side; upstream ClusterModel.sanityCheck)
# ---------------------------------------------------------------------------------

def sanity_check(state: ClusterState) -> None:
    """Host-side structural checks; raises AssertionError on violation."""
    a = state.assignment.cpu().numpy()
    p, s = a.shape
    assert tuple(state.leader_slot.shape) == (p,)
    assert tuple(state.leader_load.shape) == (p, NUM_RESOURCES)
    assert tuple(state.follower_load.shape) == (p, NUM_RESOURCES)
    assert tuple(state.partition_topic.shape) == (p,)
    assert tuple(state.replica_offline.shape) == (p, s)
    b = state.num_brokers
    assert tuple(state.broker_rack.shape) == (b,)
    assert tuple(state.broker_state.shape) == (b,)
    if a.size:
        assert a.max() < b, "assignment references unknown broker"
        assert a.min() >= EMPTY_SLOT
    ls = state.leader_slot.cpu().numpy()
    assert (ls >= 0).all() and (ls < s).all()
    if a.size:
        leader_brokers = np.take_along_axis(a, ls[:, None], axis=1)[:, 0]
        assert (leader_brokers != EMPTY_SLOT).all(), "leader on empty slot"
    for row in a:
        occ = row[row != EMPTY_SLOT]
        assert len(set(occ.tolist())) == len(occ), "duplicate broker in partition"
    topics = state.partition_topic.cpu().numpy()
    if p:
        assert topics.max() < max(state.num_topics, 1)


def dataclass_summary(state: ClusterState) -> str:
    return (
        f"ClusterState(P={state.num_partitions}, S={state.max_replication_factor}, "
        f"B={state.num_brokers}, T={state.num_topics})"
    )

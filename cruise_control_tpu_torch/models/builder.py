"""Object-level builder for readable ClusterState construction.

The tensor model (:mod:`cluster_state`) is the compute representation; tests,
fixtures, and the monitor assemble clusters through this builder (the role of
upstream ``ClusterModel.createBroker``/``createReplica`` incremental
construction, model/ClusterModel.java) and then snapshot to dense arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    FOLLOWER_CPU_RATIO,
    NUM_RESOURCES,
    BrokerState,
    Resource,
)
from cruise_control_tpu_torch.models.cluster_state import ClusterState


def _resource_vec(x: Dict[Resource, float] | Sequence[float]) -> np.ndarray:
    """Dict or sequence → f32[NUM_RESOURCES] vector."""
    if isinstance(x, dict):
        out = np.zeros(NUM_RESOURCES, np.float32)
        for r, v in x.items():
            out[int(r)] = v
        return out
    out = np.asarray(x, np.float32)
    assert out.shape == (NUM_RESOURCES,)
    return out


@dataclasses.dataclass
class _Broker:
    rack: int
    capacity: np.ndarray
    state: BrokerState = BrokerState.ALIVE
    #: JBOD: (name, capacity MB, offline) per disk; empty = no disk modeling
    disks: List[tuple] = dataclasses.field(default_factory=list)
    #: host id (upstream model/Host.java: rack → host → broker); -1 = the
    #: broker is its own host
    host: int = -1


@dataclasses.dataclass
class _Partition:
    topic: int
    brokers: List[int]
    leader_slot: int
    leader_load: np.ndarray
    follower_load: np.ndarray
    offline: List[bool]
    disks: Optional[List[int]] = None  # disk index per replica slot


def patch_cluster_state(
    prev_state: ClusterState,
    *,
    assignment: np.ndarray,
    leader_slot: np.ndarray,
    replica_offline: np.ndarray,
    load_dirty: np.ndarray,
    new_leader_load: np.ndarray,
    broker_state: np.ndarray,
    broker_ids: Sequence[int],
    added_capacity: Optional[np.ndarray] = None,
    added_racks: Optional[np.ndarray] = None,
) -> ClusterState:
    """Delta model build: produce the next :class:`ClusterState` by
    patching the previous one's arrays instead of re-running the
    per-partition builder loop (the monitor's ``cluster_model_delta``
    front half computes the diffs; this is the assemble step).

    The exactness contract the warm-start path relies on: rows NOT in
    ``load_dirty`` keep the previous load tables' bits verbatim (follower
    loads are re-derived only for dirty rows, with the same formula the
    full builder uses), so resident device tables refreshed for exactly
    the dirty rows equal a from-scratch rebuild bit-for-bit.  The broker
    axis may only ever grow by appending (``added_capacity`` /
    ``added_racks``) — an insert would shift internal indices, which the
    caller must detect and route to the full builder.
    """
    prev_load = np.asarray(prev_state.leader_load, np.float32)
    leader_load = np.where(
        load_dirty[:, None], new_leader_load.astype(np.float32), prev_load
    )
    fol = leader_load.copy()
    fol[:, Resource.NW_OUT] = 0.0
    fol[:, Resource.CPU] = leader_load[:, Resource.CPU] * FOLLOWER_CPU_RATIO
    follower_load = np.where(
        load_dirty[:, None], fol,
        np.asarray(prev_state.follower_load, np.float32),
    )
    capacity = np.asarray(prev_state.broker_capacity, np.float32)
    rack = np.asarray(prev_state.broker_rack, np.int32)
    if added_capacity is not None and len(added_capacity):
        capacity = np.concatenate([capacity, added_capacity.astype(
            np.float32)], axis=0)
        rack = np.concatenate([rack, added_racks.astype(np.int32)])
    return prev_state.replace(
        assignment=np.asarray(assignment, np.int32),
        leader_slot=np.asarray(leader_slot, np.int32),
        leader_load=leader_load,
        follower_load=follower_load,
        replica_offline=np.asarray(replica_offline, bool),
        broker_capacity=capacity,
        broker_rack=rack,
        broker_state=np.asarray(broker_state, np.int8),
        broker_ids=tuple(broker_ids),
    )


class ClusterModelBuilder:
    """Accumulates brokers/partitions, emits a dense :class:`ClusterState`."""

    def __init__(self) -> None:
        self._brokers: List[_Broker] = []
        self._broker_ids: List[int] = []
        self._partitions: List[_Partition] = []
        self._partition_ids: List[int] = []
        self._topics: Dict[str, int] = {}
        self._racks: Dict[str, int] = {}
        self._hosts: Dict[str, int] = {}

    # ---- topology ---------------------------------------------------------------
    def add_rack(self, name: str) -> int:
        return self._racks.setdefault(name, len(self._racks))

    def add_host(self, name: str) -> int:
        return self._hosts.setdefault(name, len(self._hosts))

    def add_broker(
        self,
        rack: str | int | None,
        capacity: Dict[Resource, float] | Sequence[float],
        state: BrokerState = BrokerState.ALIVE,
        broker_id: Optional[int] = None,
        disks: Optional[Sequence[tuple]] = None,
        host: str | int | None = None,
    ) -> int:
        """``broker_id`` is the *external* (Kafka) id; defaults to the dense
        internal index.  ``disks`` (JBOD): sequence of ``(name, capacity_mb)``
        or ``(name, capacity_mb, offline)``.  ``host`` places the broker on
        a physical host (upstream rack → host → broker topology,
        ``model/Host.java``); when ``rack`` is None the host stands in as
        the rack — upstream's exact fallback, so co-hosted brokers without
        rack info never share a partition's replicas.  Returns the internal
        index."""
        if rack is None:
            if host is None:
                raise ValueError("add_broker needs a rack or a host")
            rack_id = self.add_rack(f"host:{host}")
        else:
            rack_id = (
                self.add_rack(rack) if isinstance(rack, str) else int(rack)
            )
            if rack_id >= 1 << 24:
                # raw int rack ids must stay f32-exact: the device engine
                # rides rack ids through an f32 row-gather (pool-priority
                # fusion), where ids ≥ 2^24 would silently collide.  Use
                # string rack names (densified) for hashed/sparse ids.
                raise ValueError(
                    f"integer rack id {rack_id} >= 2^24; pass rack as a "
                    "string (names are densified to small ids)"
                )
        host_id = -1
        if host is not None:
            host_id = (
                self.add_host(host) if isinstance(host, str) else int(host)
            )
        internal = len(self._brokers)
        disk_list = [
            (d[0], float(d[1]), bool(d[2]) if len(d) > 2 else False)
            for d in (disks or [])
        ]
        self._brokers.append(
            _Broker(rack_id, _resource_vec(capacity), state, disk_list,
                    host=host_id)
        )
        self._broker_ids.append(internal if broker_id is None else int(broker_id))
        return internal

    def topic_id(self, topic: str) -> int:
        return self._topics.setdefault(topic, len(self._topics))

    def add_partition(
        self,
        topic: str,
        brokers: Sequence[int],
        leader_load: Dict[Resource, float] | Sequence[float],
        follower_load: Optional[Dict[Resource, float] | Sequence[float]] = None,
        leader_slot: int = 0,
        offline: Optional[Sequence[bool]] = None,
        partition_id: Optional[int] = None,
        disks: Optional[Sequence[int]] = None,
    ) -> int:
        # Default follower load per upstream semantics: replicates bytes-in
        # and disk, serves no bytes-out, and costs a fraction of leader CPU.
        ll = _resource_vec(leader_load)
        if follower_load is None:
            fl = ll.copy()
            fl[Resource.NW_OUT] = 0.0
            fl[Resource.CPU] = ll[Resource.CPU] * FOLLOWER_CPU_RATIO
        else:
            fl = _resource_vec(follower_load)
        self._partitions.append(
            _Partition(
                topic=self.topic_id(topic),
                brokers=list(brokers),
                leader_slot=leader_slot,
                leader_load=ll,
                follower_load=fl,
                offline=list(offline) if offline is not None else [False] * len(brokers),
                disks=list(disks) if disks is not None else None,
            )
        )
        internal = len(self._partitions) - 1
        self._partition_ids.append(
            internal if partition_id is None else int(partition_id)
        )
        return internal

    def set_broker_state(self, broker: int, state: BrokerState) -> None:
        self._brokers[broker].state = state

    # ---- snapshot ---------------------------------------------------------------
    def build(self) -> ClusterState:
        for label, ids in (("broker", self._broker_ids),
                           ("partition", self._partition_ids)):
            if len(set(ids)) != len(ids):
                dupes = sorted({i for i in ids if ids.count(i) > 1})
                raise ValueError(f"duplicate external {label} ids: {dupes}")
        num_b = len(self._brokers)
        num_p = len(self._partitions)
        max_rf = max((len(p.brokers) for p in self._partitions), default=1)

        assignment = np.full((num_p, max_rf), EMPTY_SLOT, np.int32)
        leader_slot = np.zeros(num_p, np.int32)
        leader_load = np.zeros((num_p, NUM_RESOURCES), np.float32)
        follower_load = np.zeros((num_p, NUM_RESOURCES), np.float32)
        topic = np.zeros(num_p, np.int32)
        offline = np.zeros((num_p, max_rf), bool)

        for i, part in enumerate(self._partitions):
            assignment[i, : len(part.brokers)] = part.brokers
            leader_slot[i] = part.leader_slot
            leader_load[i] = part.leader_load
            follower_load[i] = part.follower_load
            topic[i] = part.topic
            offline[i, : len(part.brokers)] = part.offline

        # Dead brokers' replicas are offline by construction (upstream
        # ClusterModel marks replicas on dead brokers as immigrants to move).
        dead = np.array(
            [b.state in (BrokerState.DEAD, BrokerState.REMOVED) for b in self._brokers]
        )
        if dead.any():
            on_dead = np.isin(assignment, np.nonzero(dead)[0])
            offline |= on_dead

        # JBOD disk tensors (only when any broker declared disks)
        replica_disk = disk_capacity = disk_offline = None
        disk_names: tuple = ()
        if any(b.disks for b in self._brokers):
            D = max(len(b.disks) for b in self._brokers) or 1
            disk_capacity = np.zeros((num_b, D), np.float32)
            disk_offline_arr = np.zeros((num_b, D), bool)
            names = []
            for bi, b in enumerate(self._brokers):
                row = []
                for di, (name, cap_mb, off) in enumerate(b.disks):
                    disk_capacity[bi, di] = cap_mb
                    disk_offline_arr[bi, di] = off
                    row.append(name)
                names.append(tuple(row))
            disk_names = tuple(names)
            replica_disk = np.full((num_p, max_rf), -1, np.int32)
            default_disk_counts: dict = {}
            for i, part in enumerate(self._partitions):
                if part.disks is not None:
                    replica_disk[i, : len(part.disks)] = part.disks
                else:
                    # default placement: healthy disk with the fewest
                    # replicas so far (never an offline disk)
                    for s, bi in enumerate(part.brokers):
                        healthy = [
                            di for di, (_, _, off) in
                            enumerate(self._brokers[bi].disks) if not off
                        ]
                        if healthy:
                            counts = default_disk_counts.setdefault(
                                bi, dict.fromkeys(healthy, 0)
                            )
                            di = min(healthy, key=lambda d: counts[d])
                            counts[di] += 1
                            replica_disk[i, s] = di
            # replicas on offline disks are offline (same immigrant semantics
            # as dead brokers)
            for i in range(num_p):
                for s in range(max_rf):
                    bi, di = assignment[i, s], replica_disk[i, s]
                    if bi != EMPTY_SLOT and di >= 0 and disk_offline_arr[bi, di]:
                        offline[i, s] = True
            disk_offline = disk_offline_arr

        return ClusterState(
            assignment=np.asarray(assignment),
            leader_slot=np.asarray(leader_slot),
            leader_load=np.asarray(leader_load),
            follower_load=np.asarray(follower_load),
            partition_topic=np.asarray(topic),
            broker_capacity=np.asarray(
                np.stack([b.capacity for b in self._brokers])
                if self._brokers
                else np.zeros((0, NUM_RESOURCES), np.float32)
            ),
            broker_rack=np.asarray(
                np.array([b.rack for b in self._brokers], np.int32)
            ),
            broker_state=np.asarray(
                np.array([int(b.state) for b in self._brokers], np.int8)
            ),
            broker_host=(
                np.array([b.host for b in self._brokers], np.int32)
                if any(b.host >= 0 for b in self._brokers) else None
            ),
            replica_offline=np.asarray(offline),
            num_topics=max(len(self._topics), 1),
            topic_names=tuple(self._topics),
            broker_ids=tuple(self._broker_ids),
            partition_ids=tuple(self._partition_ids),
            replica_disk=(
                None if replica_disk is None else np.asarray(replica_disk)
            ),
            disk_capacity=(
                None if disk_capacity is None else np.asarray(disk_capacity)
            ),
            disk_offline=(
                None if disk_offline is None else np.asarray(disk_offline)
            ),
            disk_names=disk_names,
        )

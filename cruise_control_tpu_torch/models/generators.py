"""Synthetic cluster generators — the test/bench workload fixtures.

Equivalents of the reference's ``RandomCluster`` and ``DeterministicCluster``
test fixtures (upstream
``cruise-control/src/test/java/com/linkedin/kafka/cruisecontrol/analyzer/RandomCluster.java``
and ``DeterministicCluster.java``; SURVEY.md §4) — seeded, so every test and
benchmark is reproducible.  Generation is host-side numpy (it feeds fixtures,
not the hot path).

Workload shapes mirror upstream ``TestConstants.Distribution``:

* ``UNIFORM``     — iid uniform loads per partition.
* ``LINEAR``      — load grows linearly with partition index.
* ``EXPONENTIAL`` — a few hot partitions dominate (load ∝ exp decay).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    FOLLOWER_CPU_RATIO,
    NUM_RESOURCES,
    BrokerState,
    Resource,
)
from cruise_control_tpu_torch.models.builder import ClusterModelBuilder
from cruise_control_tpu_torch.models.cluster_state import ClusterState


class Distribution(enum.Enum):
    UNIFORM = "uniform"
    LINEAR = "linear"
    EXPONENTIAL = "exponential"


#: Capacity of every broker in generated clusters, in upstream units
#: (CPU %, NW KB/s, DISK MB) — mirrors TestConstants broker capacity.
DEFAULT_CAPACITY = np.array(
    [100.0, 200_000.0, 200_000.0, 1_000_000.0], np.float32
)


def random_cluster(
    seed: int,
    num_brokers: int = 50,
    num_racks: int = 10,
    num_topics: int = 20,
    num_partitions: int = 1000,
    replication_factor: int = 3,
    distribution: Distribution = Distribution.UNIFORM,
    capacity: Optional[np.ndarray] = None,
    mean_utilization: float = 0.35,
    dead_brokers: int = 0,
    new_brokers: int = 0,
    rack_aware: bool = False,
    hot_partitions: int = 0,
    hot_factor: float = 8.0,
) -> ClusterState:
    """Generate a random-but-seeded cluster in upstream RandomCluster's spirit.

    Placement is random-but-legal (no duplicate broker per partition); loads
    are scaled so mean broker utilization ≈ ``mean_utilization`` per resource.
    ``dead_brokers`` marks the *last* k brokers DEAD (their replicas become
    offline) and ``new_brokers`` marks the preceding k NEW — the self-healing
    fixtures in BASELINE.json config #4.

    ``rack_aware=True`` places each partition's replicas on distinct racks
    (the fault-injection simulator needs RackAwareGoal-clean initial
    placements, so rack-loss timelines start from a legal cluster).
    ``hot_partitions``/``hot_factor`` multiply the load of a seeded random
    partition subset — the skew knob for hot-partition scenarios.  All knobs
    are seed-stable: the same arguments yield a bit-identical ClusterState.
    """
    rng = np.random.default_rng(seed)
    rf = min(replication_factor, num_brokers)
    cap = np.asarray(
        capacity if capacity is not None else DEFAULT_CAPACITY, np.float32
    )

    # topology: brokers round-robin across racks
    broker_rack = np.arange(num_brokers, dtype=np.int32) % num_racks
    # capacity may be [R] (homogeneous) or [B, R] (heterogeneous brokers)
    broker_capacity = np.broadcast_to(cap, (num_brokers, NUM_RESOURCES)).copy()

    # placement: per-partition random RF-subset of brokers, vectorized
    # (a per-partition Python loop dominates generation at 1M partitions).
    # Rack-aware regime: a uniform permutation of racks per row picks rf
    # distinct racks, then a uniform member within each — no two replicas
    # share a rack.  Dense regime (rf close to num_brokers): random-keys
    # argsort — a uniform permutation per row, first rf entries.  Sparse
    # regime: rejection sampling (resample rows with duplicate brokers) —
    # uniform over distinct tuples like choice(replace=False), geometric
    # convergence when collisions are rare.
    if rack_aware:
        if rf > num_racks:
            raise ValueError(
                f"rack_aware placement needs rf <= num_racks "
                f"(rf={rf}, num_racks={num_racks})"
            )
        members = [
            np.flatnonzero(broker_rack == r).astype(np.int32)
            for r in range(num_racks)
        ]
        width = max(m.size for m in members)
        table = np.zeros((num_racks, width), np.int32)
        counts = np.zeros(num_racks, np.int64)
        for r, m in enumerate(members):
            table[r, : m.size] = m
            counts[r] = m.size
        rack_keys = rng.random((num_partitions, num_racks))
        racks_sel = np.argsort(rack_keys, axis=1)[:, :rf]       # [P, rf]
        within = rng.integers(0, 1 << 30, size=(num_partitions, rf))
        assignment = table[
            racks_sel, within % counts[racks_sel]
        ].astype(np.int32)
    elif 2 * rf >= num_brokers:
        keys = rng.random((num_partitions, num_brokers))
        assignment = np.argsort(keys, axis=1)[:, :rf].astype(np.int32)
    else:
        def _dup_rows(a: np.ndarray) -> np.ndarray:
            srt = np.sort(a, axis=1)
            return (srt[:, 1:] == srt[:, :-1]).any(axis=1)

        assignment = rng.integers(
            0, num_brokers, size=(num_partitions, rf)
        ).astype(np.int32)
        bad = _dup_rows(assignment)
        while bad.any():
            assignment[bad] = rng.integers(
                0, num_brokers, size=(int(bad.sum()), rf)
            )
            still = _dup_rows(assignment[bad])
            nxt = np.zeros_like(bad)
            nxt[np.flatnonzero(bad)[still]] = True
            bad = nxt
    leader_slot = np.zeros(num_partitions, np.int32)

    # workload shape across partitions
    if distribution is Distribution.UNIFORM:
        shape = rng.uniform(0.5, 1.5, size=num_partitions)
    elif distribution is Distribution.LINEAR:
        shape = np.linspace(0.1, 2.0, num_partitions)
    else:  # EXPONENTIAL
        shape = np.exp(-np.linspace(0.0, 5.0, num_partitions)) * 5.0
    shape = shape / shape.mean()
    if hot_partitions:
        hot = rng.choice(num_partitions, size=min(hot_partitions,
                                                  num_partitions),
                         replace=False)
        shape = shape.copy()
        shape[hot] *= hot_factor

    # per-resource leader load, scaled to hit the target mean broker utilization:
    # sum_p load[p] * contribution ≈ mean_util * sum_b capacity[b, r]
    leader_load = np.empty((num_partitions, NUM_RESOURCES), np.float32)
    noise = rng.uniform(0.8, 1.2, size=(num_partitions, NUM_RESOURCES))
    for r in Resource:
        # replicas contributing to resource r per partition
        if r == Resource.NW_OUT:
            contrib = 1.0  # leader only
        elif r == Resource.CPU:
            contrib = 1.0 + FOLLOWER_CPU_RATIO * (rf - 1)
        else:
            contrib = float(rf)  # disk/nw_in replicated to all
        total = mean_utilization * float(broker_capacity[:, r].sum())
        leader_load[:, r] = shape * noise[:, r] * total / (num_partitions * contrib)

    follower_load = leader_load.copy()
    follower_load[:, Resource.NW_OUT] = 0.0
    follower_load[:, Resource.CPU] *= FOLLOWER_CPU_RATIO

    partition_topic = rng.integers(0, num_topics, size=num_partitions).astype(np.int32)

    broker_state = np.zeros(num_brokers, np.int8)
    if new_brokers:
        broker_state[num_brokers - dead_brokers - new_brokers : num_brokers - dead_brokers] = (
            BrokerState.NEW
        )
    if dead_brokers:
        broker_state[num_brokers - dead_brokers :] = BrokerState.DEAD
    dead_mask = broker_state == BrokerState.DEAD
    replica_offline = dead_mask[assignment] & (assignment != EMPTY_SLOT)

    return ClusterState(
        assignment=np.asarray(assignment),
        leader_slot=np.asarray(leader_slot),
        leader_load=np.asarray(leader_load),
        follower_load=np.asarray(follower_load),
        partition_topic=np.asarray(partition_topic),
        broker_capacity=np.asarray(broker_capacity),
        broker_rack=np.asarray(broker_rack),
        broker_state=np.asarray(broker_state),
        replica_offline=np.asarray(replica_offline),
        num_topics=num_topics,
    )


def small_deterministic_cluster() -> ClusterState:
    """Hand-built 2-rack / 3-broker / 2-topic fixture for exact assertions
    (upstream DeterministicCluster's role)."""
    b = ClusterModelBuilder()
    cap = {Resource.CPU: 100.0, Resource.NW_IN: 100.0, Resource.NW_OUT: 100.0, Resource.DISK: 1000.0}
    b0 = b.add_broker("r0", cap)
    b1 = b.add_broker("r0", cap)
    b2 = b.add_broker("r1", cap)
    load = {Resource.CPU: 10.0, Resource.NW_IN: 10.0, Resource.NW_OUT: 10.0, Resource.DISK: 50.0}
    b.add_partition("T1", [b0, b1], load)
    b.add_partition("T1", [b1, b2], load)
    b.add_partition("T2", [b2, b0], load)
    b.add_partition("T2", [b0, b1], load)
    return b.build()


def rack_unaware_cluster() -> ClusterState:
    """Fixture whose partitions violate rack-awareness (both replicas share a
    rack) — the RackAwareGoal unit-test case."""
    b = ClusterModelBuilder()
    cap = {Resource.CPU: 100.0, Resource.NW_IN: 100.0, Resource.NW_OUT: 100.0, Resource.DISK: 1000.0}
    b0 = b.add_broker("r0", cap)
    b1 = b.add_broker("r0", cap)
    b2 = b.add_broker("r1", cap)
    b3 = b.add_broker("r1", cap)
    load = {Resource.CPU: 5.0, Resource.NW_IN: 5.0, Resource.NW_OUT: 5.0, Resource.DISK: 20.0}
    b.add_partition("T1", [b0, b1], load)  # both in r0 → violation
    b.add_partition("T1", [b2, b3], load)  # both in r1 → violation
    b.add_partition("T2", [b0, b2], load)  # ok
    return b.build()

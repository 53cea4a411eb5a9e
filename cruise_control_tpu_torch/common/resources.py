"""Resource and broker-state vocabulary.

TPU-native re-expression of the reference's resource model
(upstream ``cruise-control/src/main/java/com/linkedin/kafka/cruisecontrol/common/Resource.java``
and ``model/Broker.java`` broker states; paths per SURVEY.md §2.4 — the reference
mount was empty, so citations are canonical upstream paths, unverified).

Resources are a *static axis* of every load/capacity tensor rather than an enum
switched over at runtime: ``load[..., Resource.CPU]`` etc.  Order matches the
upstream enum declaration order (CPU, NW_IN, NW_OUT, DISK) so capacity-file
parsing and docs line up.
"""

from __future__ import annotations

import enum


class Resource(enum.IntEnum):
    """Index into the trailing resource axis of load/capacity tensors.

    Mirrors upstream ``Resource`` (CPU %, network in KB/s, network out KB/s,
    disk MB).  ``isHostResource``/``isBrokerResource`` distinctions from
    upstream collapse here: all four are broker resources; CPU and NW are also
    host resources (used only by host-level balancing, handled in goals).
    """

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3


NUM_RESOURCES = len(Resource)

#: Upstream Resource.expectedUtilizationMargin / epsilon semantics: capacity
#: goals leave this much headroom when deciding broker overload.
DEFAULT_CAPACITY_THRESHOLD = {
    Resource.CPU: 0.7,
    Resource.NW_IN: 0.8,
    Resource.NW_OUT: 0.8,
    Resource.DISK: 0.8,
}

#: Upstream <resource>.balance.threshold defaults (AnalyzerConfig): a broker is
#: balanced when its utilization is within [avg/threshold, avg*threshold].
DEFAULT_BALANCE_THRESHOLD = {
    Resource.CPU: 1.1,
    Resource.NW_IN: 1.1,
    Resource.NW_OUT: 1.1,
    Resource.DISK: 1.1,
}

#: Upstream <resource>.low.utilization.threshold defaults: below this fraction
#: of capacity a broker is considered under-utilized and excluded from
#: balancing pressure.
DEFAULT_LOW_UTILIZATION_THRESHOLD = {
    Resource.CPU: 0.0,
    Resource.NW_IN: 0.0,
    Resource.NW_OUT: 0.0,
    Resource.DISK: 0.0,
}


class BrokerState(enum.IntEnum):
    """Mirrors upstream ``Broker.State`` (model/Broker.java).

    Stored as an int8 tensor ``broker_state[B]`` in :class:`ClusterState`.
    ``ALIVE``-ness for load-bearing math is ``state != DEAD and state != REMOVED``
    — NEW and DEMOTED brokers still carry load.
    """

    ALIVE = 0
    DEAD = 1
    NEW = 2
    REMOVED = 3
    DEMOTED = 4


# Sentinel broker id for an empty replica slot (partitions whose replication
# factor is below the padded slot axis length).
EMPTY_SLOT = -1

#: Fraction of leader CPU a follower replica costs — the default ratio of the
#: monitor's linear CPU model (upstream ModelUtils; overridden by trained
#: parameters once the monitor layer supplies them).  Single source of truth
#: for builder defaults and synthetic generators.
FOLLOWER_CPU_RATIO = 0.2

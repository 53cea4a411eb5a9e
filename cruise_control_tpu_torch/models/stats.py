"""Vectorized ``ClusterModelStats`` (upstream ``model/ClusterModelStats.java``).

Per-resource mean / stddev / coefficient-of-variation of broker utilization,
replica/leader/topic-replica count distributions, and potential NW-out — the
numbers the distribution goals balance and ``OptimizerResult`` reports
before/after.  Every statistic is a masked reduction over the dense broker
axis, computed on the device the state lives on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.models.cluster_state import (
    ClusterState,
    broker_leader_count,
    broker_load,
    broker_potential_nw_out,
    broker_replica_count,
    broker_topic_replica_count,
)


@dataclasses.dataclass(frozen=True)
class ClusterStats:
    """All fields are per-alive-broker statistics; ``resource_*`` tensors
    are indexed by :class:`Resource` on the last axis."""

    resource_mean: torch.Tensor        # f32 [R]
    resource_std: torch.Tensor         # f32 [R]
    resource_cv: torch.Tensor          # f32 [R]  std/mean
    utilization_mean: torch.Tensor     # f32 [R]  mean of load/capacity
    utilization_std: torch.Tensor      # f32 [R]
    replica_count_mean: torch.Tensor   # f32 []
    replica_count_std: torch.Tensor    # f32 []
    leader_count_mean: torch.Tensor    # f32 []
    leader_count_std: torch.Tensor     # f32 []
    topic_replica_std_mean: torch.Tensor  # f32 [] mean over topics of std
    potential_nw_out_mean: torch.Tensor   # f32 []
    potential_nw_out_std: torch.Tensor    # f32 []
    num_alive_brokers: torch.Tensor    # int32 []


def _masked_mean_std(values: torch.Tensor, mask: torch.Tensor):
    """Mean/std over axis 0 where ``mask`` (broadcastable) is true."""
    mask_f = mask.to(values.dtype)
    while mask_f.ndim < values.ndim:
        mask_f = mask_f[..., None]
    n = torch.clamp_min(mask_f.sum(dim=0), 1.0)
    mean = (values * mask_f).sum(dim=0) / n
    d = values - mean
    var = (d * d * mask_f).sum(dim=0) / n
    return mean, torch.sqrt(var)


def cluster_stats(state: ClusterState) -> ClusterStats:
    """Cluster statistics of ``state``, on the device its tensors live on."""
    alive = state.broker_alive()
    load = broker_load(state)                               # [B, R]
    cap = torch.clamp_min(state.broker_capacity, 1e-9)
    util = load / cap

    res_mean, res_std = _masked_mean_std(load, alive)
    util_mean, util_std = _masked_mean_std(util, alive)
    cv = res_std / torch.clamp_min(res_mean, 1e-9)

    rc = broker_replica_count(state).to(torch.float32)
    lc = broker_leader_count(state).to(torch.float32)
    rc_mean, rc_std = _masked_mean_std(rc, alive)
    lc_mean, lc_std = _masked_mean_std(lc, alive)

    trc = broker_topic_replica_count(state).to(torch.float32)  # [B, T]
    _, trc_std = _masked_mean_std(trc, alive)                  # [T]
    trc_std_mean = (
        trc_std.mean() if state.num_topics
        else torch.zeros((), dtype=torch.float32, device=load.device)
    )

    pot = broker_potential_nw_out(state)
    pot_mean, pot_std = _masked_mean_std(pot, alive)

    return ClusterStats(
        resource_mean=res_mean,
        resource_std=res_std,
        resource_cv=cv,
        utilization_mean=util_mean,
        utilization_std=util_std,
        replica_count_mean=rc_mean,
        replica_count_std=rc_std,
        leader_count_mean=lc_mean,
        leader_count_std=lc_std,
        topic_replica_std_mean=trc_std_mean,
        potential_nw_out_mean=pot_mean,
        potential_nw_out_std=pot_std,
        num_alive_brokers=alive.to(torch.int32).sum(),
    )


def stats_summary(stats: ClusterStats) -> dict:
    """Host-side dict for JSON responses (servlet/response parity).  One
    device-to-host copy: the fields are packed before they cross."""
    fields = [f.name for f in dataclasses.fields(stats)]
    leaves = [getattr(stats, n) for n in fields]
    packed = torch.cat(
        [x.reshape(-1).to(torch.float64) for x in leaves]
    ).cpu().numpy()
    vals, off = {}, 0
    for n, x in zip(fields, leaves):
        k = x.numel()
        vals[n] = packed[off:off + k].reshape(tuple(x.shape))
        off += k

    def f(x):
        return np.asarray(x, np.float32).tolist()

    return {
        "numAliveBrokers": int(vals["num_alive_brokers"]),
        "resources": {
            r.name: {
                "mean": f(vals["resource_mean"][r]),
                "std": f(vals["resource_std"][r]),
                "cv": f(vals["resource_cv"][r]),
                "utilizationMean": f(vals["utilization_mean"][r]),
                "utilizationStd": f(vals["utilization_std"][r]),
            }
            for r in Resource
        },
        "replicaCount": {
            "mean": f(vals["replica_count_mean"]),
            "std": f(vals["replica_count_std"]),
        },
        "leaderCount": {
            "mean": f(vals["leader_count_mean"]),
            "std": f(vals["leader_count_std"]),
        },
        "topicReplicaStdMean": f(vals["topic_replica_std_mean"]),
        "potentialNwOut": {
            "mean": f(vals["potential_nw_out_mean"]),
            "std": f(vals["potential_nw_out_std"]),
        },
    }

"""Provisioning analysis (upstream ``analyzer/ProvisionResponse.java`` +
``ProvisionRecommendation`` and the RIGHTSIZE endpoint; SURVEY.md §2.4).

Vectorized over the cluster tensors: total load vs total alive capacity per
resource decides UNDER/RIGHT/OVER_PROVISIONED, with a broker-count
recommendation sized so the binding resource lands back inside its capacity
threshold.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from cruise_control_tpu_torch.common.resources import (
    DEFAULT_CAPACITY_THRESHOLD,
    Resource,
)
from cruise_control_tpu_torch.models.cluster_state import ClusterState, broker_load


class ProvisionStatus:
    UNDER_PROVISIONED = "UNDER_PROVISIONED"
    RIGHT_SIZED = "RIGHT_SIZED"
    OVER_PROVISIONED = "OVER_PROVISIONED"
    UNDECIDED = "UNDECIDED"


@dataclasses.dataclass
class ProvisionRecommendation:
    num_brokers: int
    resource: str
    reason: str

    def to_json(self) -> dict:
        return {
            "numBrokers": self.num_brokers,
            "resource": self.resource,
            "reason": self.reason,
        }


@dataclasses.dataclass
class ProvisionResponse:
    status: str
    recommendation: Optional[ProvisionRecommendation] = None
    utilization: Optional[Dict[str, float]] = None

    def to_json(self) -> dict:
        return {
            "status": self.status,
            "recommendation": (
                self.recommendation.to_json() if self.recommendation else None
            ),
            "utilization": self.utilization,
        }


def analyze_provisioning(
    state: ClusterState,
    capacity_threshold: Optional[Dict[Resource, float]] = None,
    low_utilization: float = 0.2,
    min_brokers: int = 3,
) -> ProvisionResponse:
    return analyze_provisioning_arrays(
        np.asarray(state.broker_alive()),
        np.asarray(broker_load(state)),
        np.asarray(state.broker_capacity),
        capacity_threshold, low_utilization, min_brokers,
    )


def analyze_provisioning_arrays(
    alive: np.ndarray,          # bool [B]
    broker_load: np.ndarray,    # f32 [B, R]
    broker_capacity: np.ndarray,  # f32 [B, R]
    capacity_threshold: Optional[Dict[Resource, float]] = None,
    low_utilization: float = 0.2,
    min_brokers: int = 3,
) -> ProvisionResponse:
    """Host-array fast path: callers holding numpy copies (AnalyzerContext)
    skip the three device fetches of the state-based entry point."""
    thr = capacity_threshold or DEFAULT_CAPACITY_THRESHOLD
    n_alive = int(alive.sum())
    if n_alive == 0:
        return ProvisionResponse(ProvisionStatus.UNDECIDED)
    load = np.asarray(broker_load).sum(axis=0)                  # [R] total
    cap = np.asarray(broker_capacity)[alive].sum(axis=0)        # [R] alive
    cap = np.maximum(cap, 1e-9)
    util = load / cap
    utilization = {r.name: round(float(util[r]), 4) for r in Resource}

    # under-provisioned: some resource above its capacity threshold even if
    # spread perfectly — add brokers until it fits
    worst_r, deficit = None, 0.0
    for r in Resource:
        over = util[r] / thr[r]
        if over > 1.0 and over > deficit:
            worst_r, deficit = r, over
    if worst_r is not None:
        per_broker_cap = cap[worst_r] / n_alive
        needed_cap = load[worst_r] / thr[worst_r]
        extra = math.ceil((needed_cap - cap[worst_r]) / per_broker_cap)
        return ProvisionResponse(
            ProvisionStatus.UNDER_PROVISIONED,
            ProvisionRecommendation(
                num_brokers=max(extra, 1),
                resource=worst_r.name,
                reason=(
                    f"{worst_r.name} utilization {util[worst_r]:.2f} exceeds "
                    f"capacity threshold {thr[worst_r]:.2f}"
                ),
            ),
            utilization,
        )

    # over-provisioned: every resource far below threshold with brokers to spare
    if n_alive > min_brokers and all(
        util[r] < low_utilization * thr[r] for r in Resource
    ):
        # how many brokers could go while staying under the low-util bound
        removable = 0
        for k in range(1, n_alive - min_brokers + 1):
            scale = n_alive / (n_alive - k)
            if any(util[r] * scale >= thr[r] for r in Resource):
                break
            removable = k
        if removable > 0:
            return ProvisionResponse(
                ProvisionStatus.OVER_PROVISIONED,
                ProvisionRecommendation(
                    num_brokers=removable,
                    resource="ALL",
                    reason=(
                        f"all resources below {low_utilization:.0%} of their "
                        f"capacity thresholds"
                    ),
                ),
                utilization,
            )
    return ProvisionResponse(ProvisionStatus.RIGHT_SIZED, None, utilization)

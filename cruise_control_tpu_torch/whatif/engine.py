"""The batched verdict evaluator — N futures, one kernel call.

The stacked ``(dead[N, B], scale[N, P])`` perturbations the compiler
built go to the card with the shared base model, and hand kernel K12
(:func:`whatif.verdict_kernels.whatif_verdict`) computes every future's
verdict in one call; on the CPU its plain twin does.

A verdict is *dry-run semantics*, not a plan search: survivability
(every partition keeps ≥1 live replica; aggregate load still fits the
surviving capacity), goal-violation counts (per-broker capacity
breaches, rack co-location after loss), the projected plan cost of
healing the future (replica + leadership moves, data to shuttle), and
the top suggested actions.  That is what makes N=64 futures affordable
in well under one plan search's wall time.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cruise_control_tpu_torch.utils.device import resolve_device
from cruise_control_tpu_torch.whatif.compiler import FutureBatch
from cruise_control_tpu_torch.whatif.verdict_kernels import (
    TOP_ACTIONS,
    whatif_verdict,
)


def verdict_inputs(state, batch: FutureBatch, capacity_scale=None,
                   device="cuda"):
    """The nine tensors the verdict kernel takes, on ``device``: the base
    model (``capacity_scale`` applied to the capacity) and the batch's
    ``dead`` and ``scale``."""
    dev = resolve_device(device)
    f32 = torch.float32
    capacity = state.broker_capacity.to(dev, f32)
    if capacity_scale is not None:
        capacity = capacity * torch.as_tensor(
            np.asarray(capacity_scale, np.float32), device=dev)[None, :]
    return (
        state.assignment.to(dev).contiguous(),
        state.leader_slot.to(dev).contiguous(),
        state.leader_load.to(dev, f32).contiguous(),
        state.follower_load.to(dev, f32).contiguous(),
        capacity.contiguous(),
        state.broker_rack.to(dev).contiguous(),
        state.broker_alive().to(dev).contiguous(),
        torch.from_numpy(batch.dead).to(dev),
        torch.from_numpy(batch.scale).to(dev),
    )


def evaluate_batch(state, batch: FutureBatch, capacity_scale=None,
                   device="cuda") -> Dict[str, np.ndarray]:
    """Evaluate every future in ``batch`` in ONE kernel call on ``device``
    (the card unless the caller asks for ``"cpu"``; asking for the card
    without one raises).

    ``capacity_scale`` is an optional per-resource usable-fraction vector
    (the analyzer's capacity thresholds) applied to ``broker_capacity``
    before evaluation, so overload/infeasibility verdicts share the
    capacity goals' bar instead of raw hardware limits.

    Returns the stacked raw verdict arrays (padded rows included — use
    :func:`verdicts` for the per-future JSON view)."""
    out = whatif_verdict(*verdict_inputs(state, batch, capacity_scale,
                                         device))
    return {k: v.cpu().numpy() for k, v in out.items()}


def verdicts(batch: FutureBatch,
             raw: Dict[str, np.ndarray]) -> List[dict]:
    """Per-future JSON verdicts (valid rows only, padding dropped)."""
    out = []
    for i, future in enumerate(batch.futures):
        actions = []
        for k in range(TOP_ACTIONS):
            p = int(raw["topActionPartition"][i, k])
            if p < 0:
                continue
            actions.append({
                "partition": p,
                "from": int(raw["topActionSource"][i, k]),
                "to": int(raw["topActionDestination"][i, k]),
            })
        out.append({
            "future": future.name,
            "fingerprint": future.fingerprint(),
            "horizonMs": int(future.horizon_ms),
            "survivable": bool(raw["survivable"][i]),
            "unavailablePartitions": int(raw["unavailablePartitions"][i]),
            "underReplicated": int(raw["underReplicated"][i]),
            "capacityInfeasible": bool(raw["capacityInfeasible"][i]),
            "overloadedBrokers": int(raw["overloadedBrokers"][i]),
            "rackViolations": int(raw["rackViolations"][i]),
            "goalViolations": int(raw["overloadedBrokers"][i])
            + int(raw["rackViolations"][i]),
            "movesRequired": int(raw["movesRequired"][i]),
            "leadershipMoves": int(raw["leadershipMoves"][i]),
            "dataMoveMB": round(float(raw["dataMoveMB"][i]), 3),
            "maxBrokerUtilization": round(
                float(raw["maxBrokerUtilization"][i]), 4
            ),
            "topActions": actions,
        })
    return out

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

import contextlib
from typing import Dict, List

import numpy as np
import torch

from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.telemetry import device_cost, mesh_budget
from cruise_control_tpu_torch.utils.device import DEVICE_LOCK, resolve_device
from cruise_control_tpu_torch.whatif.compiler import FutureBatch
from cruise_control_tpu_torch.whatif.verdict_kernels import (
    TOP_ACTIONS,
    whatif_verdict,
)

#: the what-if call's name in the device-cost table
VERDICT_FN = "whatif.verdict_fn"


def verdict_inputs(state, batch: FutureBatch, capacity_scale=None,
                   device="cuda"):
    """The nine tensors the verdict kernel takes, on ``device``: the base
    model (``capacity_scale`` applied to the capacity) and the batch's
    ``dead`` and ``scale``."""
    dev = resolve_device(device)
    f32 = torch.float32

    def put(x):
        # the upload goes through the transfer ledger
        return mesh_budget.device_put(x, dev, fn="whatif.upload").contiguous()

    capacity = put(state.broker_capacity.to(f32))
    if capacity_scale is not None:
        capacity = capacity * put(
            np.asarray(capacity_scale, np.float32))[None, :]
    return (
        put(state.assignment),
        put(state.leader_slot),
        put(state.leader_load.to(f32)),
        put(state.follower_load.to(f32)),
        capacity.contiguous(),
        put(state.broker_rack),
        put(state.broker_alive()),
        put(torch.from_numpy(batch.dead)),
        put(torch.from_numpy(batch.scale)),
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
    :func:`verdicts` for the per-future JSON view).  Holds
    :data:`~cruise_control_tpu_torch.utils.device.DEVICE_LOCK` throughout."""
    with DEVICE_LOCK:
        inputs = verdict_inputs(state, batch, capacity_scale, device)
        # the call's cost, once a shape (telemetry/device_cost.py): the
        # launches' work, recorded on the first call of the shape
        sig = (str(inputs[0].device),) + tuple(tuple(t.shape)
                                               for t in inputs)
        cost = device_cost.MONITOR
        fresh = cost.enabled and not cost.known(VERDICT_FN, sig)
        with (kernels.WORK.recording() if fresh
              else contextlib.nullcontext({})) as work:
            out = whatif_verdict(*inputs)
        cost.note_call(VERDICT_FN)
        if fresh:
            cost.note_compile(VERDICT_FN, sig, device_cost.work_source(
                work, arg_bytes=sum(t.nbytes for t in inputs),
                output_bytes=sum(v.nbytes for v in out.values())))
        # the verdict reads through the transfer ledger
        return {k: mesh_budget.fetch(v, fn="whatif.verdict_fetch")
                for k, v in out.items()}


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

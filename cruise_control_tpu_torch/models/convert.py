"""Carry state across from numpy: build the port's ``ClusterState`` and
``DeviceModel`` from plain arrays (for example ``np.asarray`` of the JAX
reference's fields), so both packages can compute on the same placement
and loads.  Like every entry point of the port, both land on the card
unless the caller asks for the CPU, and raise when asked for a card that
is not there (``utils.device.resolve_device``)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from cruise_control_tpu_torch.models.cluster_state import ClusterState
from cruise_control_tpu_torch.utils.device import resolve_device


def cluster_state_from_numpy(fields: Dict[str, object],
                             device="cuda") -> ClusterState:
    """``ClusterState`` from a dict of its field values; arrays land on
    ``device``, static metadata (``num_topics``, id tuples, ...) passes
    through."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(ClusterState):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            v = torch.tensor(v, device=device)
        kw[f.name] = v
    return ClusterState(**kw)


def device_model_from_numpy(fields: Dict[str, np.ndarray], device="cuda"):
    """``DeviceModel`` from a dict of numpy arrays keyed by its field names
    (``None`` or missing optional fields stay ``None``)."""
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import DeviceModel

    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(DeviceModel):
        v = fields.get(f.name)
        kw[f.name] = None if v is None else torch.tensor(np.asarray(v),
                                                         device=device)
    return DeviceModel(**kw)

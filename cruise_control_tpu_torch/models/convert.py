"""Carry state across from numpy: build the port's ``ClusterState`` and
``DeviceModel`` from plain arrays (for example ``np.asarray`` of the JAX
reference's fields), so both packages can compute on the same placement
and loads."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from cruise_control_tpu_torch.models.cluster_state import ClusterState


def cluster_state_from_numpy(fields: Dict[str, object],
                             device="cpu") -> ClusterState:
    """``ClusterState`` from a dict of its field values; arrays land on
    ``device``, static metadata (``num_topics``, id tuples, ...) passes
    through."""
    kw = {}
    for f in dataclasses.fields(ClusterState):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            v = torch.tensor(v, device=device)
        kw[f.name] = v
    return ClusterState(**kw)


def device_model_from_numpy(fields: Dict[str, np.ndarray], device="cpu"):
    """``DeviceModel`` from a dict of numpy arrays keyed by its field names
    (``None`` or missing optional fields stay ``None``)."""
    from cruise_control_tpu_torch.analyzer.cuda_optimizer import DeviceModel

    kw = {}
    for f in dataclasses.fields(DeviceModel):
        v = fields.get(f.name)
        kw[f.name] = None if v is None else torch.tensor(np.asarray(v),
                                                         device=device)
    return DeviceModel(**kw)

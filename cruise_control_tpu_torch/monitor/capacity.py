"""Broker capacity resolution (upstream
``config/BrokerCapacityConfigFileResolver.java`` + ``BrokerCapacityInfo``;
SURVEY.md §2.3).  Reads the same JSON schema as the reference's
``config/capacity.json``: a ``brokerCapacities`` list with a ``-1`` default
entry and per-resource values (DISK MB, CPU %, NW_IN/NW_OUT KB/s); the JBOD
variant maps ``DISK`` to a dict of logdir → MB, which collapses to the sum
here (intra-broker disks become a future per-disk axis)."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource

DEFAULT_BROKER_ID = -1

_JSON_KEYS = {
    "CPU": Resource.CPU,
    "NW_IN": Resource.NW_IN,
    "NW_OUT": Resource.NW_OUT,
    "DISK": Resource.DISK,
}


@dataclasses.dataclass
class BrokerCapacityInfo:
    capacity: np.ndarray  # f32 [NUM_RESOURCES]
    num_cpu_cores: int = 1
    is_estimated: bool = False
    estimation_info: str = ""
    #: JBOD: logdir → capacity MB (None = single unnamed volume)
    disk_capacities: Optional[Dict[str, float]] = None


class BrokerCapacityConfigResolver:
    """SPI: per-broker capacities (upstream ``BrokerCapacityConfigResolver``)."""

    def capacity_for_broker(self, broker_id: int) -> BrokerCapacityInfo:
        raise NotImplementedError


class StaticCapacityResolver(BrokerCapacityConfigResolver):
    """Uniform capacity for every broker (tests / synthetic clusters)."""

    def __init__(self, capacity: Dict[Resource, float], num_cpu_cores: int = 1,
                 disk_capacities: Optional[Dict[str, float]] = None):
        vec = np.zeros(NUM_RESOURCES, np.float32)
        for r, v in capacity.items():
            vec[int(r)] = v
        if disk_capacities:
            vec[int(Resource.DISK)] = sum(disk_capacities.values())
        self._info = BrokerCapacityInfo(
            vec, num_cpu_cores, disk_capacities=disk_capacities
        )

    def capacity_for_broker(self, broker_id: int) -> BrokerCapacityInfo:
        return self._info


class BrokerCapacityConfigFileResolver(BrokerCapacityConfigResolver):
    """Reads the reference's ``capacity.json`` / ``capacityJBOD.json`` /
    ``capacityCores.json`` schema."""

    def __init__(self, path: str):
        with open(path) as f:
            doc = json.load(f)
        self._by_broker: Dict[int, BrokerCapacityInfo] = {}
        for entry in doc.get("brokerCapacities", []):
            broker_id = int(entry["brokerId"])
            cap = entry.get("capacity", {})
            vec = np.zeros(NUM_RESOURCES, np.float32)
            disk_caps: Optional[Dict[str, float]] = None
            for key, res in _JSON_KEYS.items():
                v = cap.get(key)
                if v is None:
                    continue
                if isinstance(v, dict):  # JBOD: logdir → MB
                    disk_caps = {d: float(x) for d, x in v.items()}
                    vec[int(res)] = sum(disk_caps.values())
                else:
                    vec[int(res)] = float(v)
            cores = int(entry.get("num.cores", cap.get("num.cores", 1)))
            self._by_broker[broker_id] = BrokerCapacityInfo(
                vec, cores, is_estimated=broker_id == DEFAULT_BROKER_ID,
                estimation_info="default capacity entry"
                if broker_id == DEFAULT_BROKER_ID else "",
                disk_capacities=disk_caps,
            )
        if DEFAULT_BROKER_ID not in self._by_broker:
            raise ValueError(
                f"capacity file {path} lacks the default (-1) entry"
            )

    def capacity_for_broker(self, broker_id: int) -> BrokerCapacityInfo:
        return self._by_broker.get(
            broker_id, self._by_broker[DEFAULT_BROKER_ID]
        )

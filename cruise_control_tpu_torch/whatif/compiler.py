"""Future → perturbation compiler.

Lowers a list of :class:`FutureSpec`\\ s against one built model into two
dense perturbation arrays the batched evaluator consumes:

* ``dead[N, B]``  — brokers offline in that future (loss, rack loss,
  maintenance),
* ``scale[N, P]`` — per-partition traffic multiplier (traffic ×k, topic
  growth, hot partitions); rates only — the evaluator applies it to
  CPU/NW and leaves DISK alone, matching the workload synthesizer's
  "disk is an integral" rule.

The futures axis is padded to a power of two (``valid`` masks the tail),
so a cluster sees a handful of batch shapes over its whole lifetime: an
operator's ad-hoc 3-future query rides the same shapes as the daemon's
precomputed 8.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.whatif.futures import FutureSpec

#: smallest futures-axis bucket; buckets go 8, 16, 32, … so the
#: batch-shape count stays O(log N) across every request mix
MIN_BUCKET = 8


def bucket_size(n: int) -> int:
    """Next power-of-two bucket ≥ ``n`` (≥ :data:`MIN_BUCKET`)."""
    n2 = MIN_BUCKET
    while n2 < n:
        n2 <<= 1
    return n2


@dataclasses.dataclass(frozen=True)
class FutureBatch:
    """Compiled perturbations for one batched dispatch."""

    futures: Tuple[FutureSpec, ...]
    dead: np.ndarray   # bool [N2, B]
    scale: np.ndarray  # f32  [N2, P]
    valid: np.ndarray  # bool [N2]

    @property
    def num_futures(self) -> int:
        return len(self.futures)

    @property
    def padded_size(self) -> int:
        return int(self.dead.shape[0])


def _topic_id(state, topic) -> int:
    if isinstance(topic, str):
        names = state.topic_names
        if topic in names:
            return names.index(topic)
        raise ValueError(f"unknown topic {topic!r}")
    t = int(topic)
    if not 0 <= t < max(1, state.num_topics):
        raise ValueError(f"topic id {t} out of range")
    return t


def _compile_one(state, future: FutureSpec, dead: np.ndarray,
                 scale: np.ndarray) -> None:
    """Fold one future's events into its ``dead[B]`` / ``scale[P]`` rows
    (events compound: two ×2 traffic events make ×4)."""
    racks = state.broker_rack.cpu().numpy()
    topics = state.partition_topic.cpu().numpy()
    B = dead.shape[0]
    for ev in future.events:
        if ev.kind == "kill_broker":
            b = int(ev.arg("broker"))
            if not 0 <= b < B:
                raise ValueError(f"broker {b} out of range")
            dead[b] = True
        elif ev.kind == "rack_loss":
            r = int(ev.arg("rack"))
            hit = racks == r
            if not hit.any():
                raise ValueError(f"no brokers on rack {r}")
            dead[hit] = True
        elif ev.kind == "maintenance_event":
            for b in ev.arg("brokers"):
                b = int(b)
                if not 0 <= b < B:
                    raise ValueError(f"broker {b} out of range")
                dead[b] = True
        elif ev.kind == "traffic_scale":
            scale *= float(ev.arg("factor"))
        elif ev.kind == "topic_growth":
            t = _topic_id(state, ev.arg("topic"))
            scale[topics == t] *= float(ev.arg("factor"))
        elif ev.kind == "hot_partition_skew":
            idx = np.asarray([int(p) for p in ev.arg("partitions")], int)
            if idx.size and (idx.min() < 0 or idx.max() >= scale.shape[0]):
                raise ValueError("hot_partition_skew partition out of range")
            scale[idx] *= float(ev.arg("factor"))
        else:
            raise ValueError(f"unknown future event kind {ev.kind!r}")


def compile_futures(state, futures: Sequence[FutureSpec]) -> FutureBatch:
    """Lower ``futures`` against ``state`` into one padded batch."""
    futures = tuple(futures)
    if not futures:
        raise ValueError("compile_futures needs at least one future")
    n = len(futures)
    n2 = bucket_size(n)
    B = state.num_brokers
    P = state.num_partitions
    dead = np.zeros((n2, B), bool)
    scale = np.ones((n2, P), np.float32)
    valid = np.zeros(n2, bool)
    for i, f in enumerate(futures):
        _compile_one(state, f, dead[i], scale[i])
        valid[i] = True
    return FutureBatch(futures=futures, dead=dead, scale=scale, valid=valid)

"""The hypothetical-future DSL.

A :class:`FutureSpec` is a tiny, deterministic description of a
counterfactual — "rack 2 dies", "traffic grows 1.8×", "topic `clicks`
triples" — built from the same event vocabulary the scenario timeline
speaks (``sim/timeline.py``), plus two load-shape kinds the timeline has
no need for (``traffic_scale`` / ``topic_growth``: the sim *synthesizes*
load, a what-if only *projects* it).

Every spec fingerprints to a stable hex id (sha256 over the canonical
event tuples), which — crossed with the monitor's ``model_generation()``
— keys the per-future verdict cache: a fingerprint never collides across
semantically different futures, and a generation bump silently retires
every cached verdict.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource

#: the closed kind vocabulary; the compiler rejects anything else
FUTURE_KINDS = (
    "kill_broker",
    "rack_loss",
    "maintenance_event",
    "traffic_scale",
    "topic_growth",
    "hot_partition_skew",
)

#: horizon a future defaults to when the caller names none (1 virtual hour)
DEFAULT_HORIZON_MS = 3_600_000


@dataclasses.dataclass(frozen=True)
class FutureEvent:
    """One hypothetical perturbation: ``kind`` + sorted ``(key, value)``
    args — hashable and canonical, mirroring ``TimelineEvent``."""

    kind: str
    args: tuple

    def arg(self, name, default=None):
        return dict(self.args).get(name, default)

    def to_json(self) -> dict:
        return {"kind": self.kind, **dict(self.args)}


def _event(kind: str, **args) -> FutureEvent:
    if kind not in FUTURE_KINDS:
        raise ValueError(f"unknown future event kind {kind!r}")
    return FutureEvent(kind, tuple(sorted(args.items())))


def broker_loss(broker: int) -> FutureEvent:
    """Broker ``broker`` (internal dense index) dies."""
    return _event("kill_broker", broker=int(broker))


def rack_loss(rack: int) -> FutureEvent:
    """Every broker on rack ``rack`` dies at once."""
    return _event("rack_loss", rack=int(rack))


def maintenance(*brokers: int) -> FutureEvent:
    """Planned maintenance: the named brokers are drained/offline for the
    future's horizon (same placement consequences as loss, different
    operator intent)."""
    if not brokers:
        raise ValueError("maintenance needs at least one broker")
    return _event("maintenance_event",
                  brokers=tuple(int(b) for b in brokers))


def traffic_scale(factor: float) -> FutureEvent:
    """Cluster-wide traffic multiplier ×``factor`` (rates only; disk is
    an integral, not a rate — matching the workload synthesizer)."""
    if factor <= 0:
        raise ValueError(f"traffic_scale factor must be > 0, got {factor}")
    return _event("traffic_scale", factor=round(float(factor), 6))


def topic_growth(topic, factor: float) -> FutureEvent:
    """Traffic on one topic (name or dense id) grows ×``factor``."""
    if factor <= 0:
        raise ValueError(f"topic_growth factor must be > 0, got {factor}")
    return _event("topic_growth", topic=topic,
                  factor=round(float(factor), 6))


def hot_partitions(partitions: Sequence[int], factor: float) -> FutureEvent:
    """A partition subset runs ×``factor`` hot (the timeline's
    ``hot_partition_skew``, projected instead of injected)."""
    return _event("hot_partition_skew",
                  partitions=tuple(int(p) for p in partitions),
                  factor=round(float(factor), 6))


@dataclasses.dataclass(frozen=True)
class FutureSpec:
    """One named hypothetical future: a composition of events projected
    over ``horizon_ms``."""

    name: str
    events: Tuple[FutureEvent, ...]
    horizon_ms: int = DEFAULT_HORIZON_MS

    def __post_init__(self):
        if not self.events:
            raise ValueError(f"future {self.name!r} has no events")
        object.__setattr__(self, "events", tuple(self.events))

    def fingerprint(self) -> str:
        """Stable id over the future's SEMANTICS (events + horizon; the
        display name is free to change without invalidating caches)."""
        doc = {
            "events": [e.to_json() for e in self.events],
            "horizonMs": int(self.horizon_ms),
        }
        blob = json.dumps(doc, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "horizonMs": int(self.horizon_ms),
            "events": [e.to_json() for e in self.events],
            "fingerprint": self.fingerprint(),
        }


def parse_future(obj: dict) -> FutureSpec:
    """``POST /whatif`` body element → :class:`FutureSpec` (strict: an
    unknown kind or missing arg is a 400 at the request boundary)."""
    if not isinstance(obj, dict):
        raise ValueError(f"future must be an object, got {type(obj).__name__}")
    raw_events = obj.get("events")
    if not isinstance(raw_events, list) or not raw_events:
        raise ValueError("future needs a non-empty 'events' list")
    events = []
    for ev in raw_events:
        if not isinstance(ev, dict) or "kind" not in ev:
            raise ValueError(f"future event needs a 'kind': {ev!r}")
        kind = ev["kind"]
        args = {k: v for k, v in ev.items() if k != "kind"}
        if kind == "kill_broker":
            events.append(broker_loss(args["broker"]))
        elif kind == "rack_loss":
            events.append(rack_loss(args["rack"]))
        elif kind == "maintenance_event":
            events.append(maintenance(*args["brokers"]))
        elif kind == "traffic_scale":
            events.append(traffic_scale(args["factor"]))
        elif kind == "topic_growth":
            events.append(topic_growth(args["topic"], args["factor"]))
        elif kind == "hot_partition_skew":
            events.append(hot_partitions(args["partitions"], args["factor"]))
        else:
            raise ValueError(f"unknown future event kind {kind!r}")
    horizon = int(obj.get("horizonMs", obj.get("horizon_ms",
                                               DEFAULT_HORIZON_MS)))
    name = str(obj.get("name") or f"future-{len(events)}ev")
    return FutureSpec(name=name, events=tuple(events), horizon_ms=horizon)


def likely_futures(state, k: int = 8) -> Tuple[FutureSpec, ...]:
    """The deterministic top-``k`` futures an operator most plausibly
    asks about, derived from the built model: rack losses ordered by
    hosted ingress (heaviest rack first), single-broker losses likewise,
    then cluster-wide traffic growth steps.  Ties break on the smaller
    id, so the list is stable for a given model — the precompute daemon
    keys its warm set on exactly this ordering."""
    k = max(0, int(k))
    if k == 0:
        return ()
    # the state's fields are tensors, possibly on the card
    assignment = state.assignment.cpu().numpy()
    lead_in = state.leader_load.cpu().numpy()[:, Resource.NW_IN]
    racks = state.broker_rack.cpu().numpy()
    num_brokers = int(state.num_brokers)
    # hosted ingress per broker: each existing replica slot contributes
    # the leader rate on the leader slot (followers replicate it too, but
    # the ordering heuristic only needs a stable, load-shaped ranking)
    hosted = np.zeros(num_brokers, np.float64)
    P, S = assignment.shape
    for s in range(S):
        col = assignment[:, s]
        ok = col >= 0
        np.add.at(hosted, col[ok], lead_in[ok])
    futures = []
    rack_ids = sorted(set(int(r) for r in racks.tolist()))
    rack_load = {r: float(hosted[racks == r].sum()) for r in rack_ids}
    for r in sorted(rack_ids, key=lambda r: (-rack_load[r], r)):
        futures.append(FutureSpec(
            name=f"rack-{r}-loss", events=(rack_loss(r),),
        ))
    for b in sorted(range(num_brokers),
                    key=lambda b: (-float(hosted[b]), b)):
        futures.append(FutureSpec(
            name=f"broker-{b}-loss", events=(broker_loss(b),),
        ))
    for factor in (1.5, 2.0):
        futures.append(FutureSpec(
            name=f"traffic-x{factor:g}", events=(traffic_scale(factor),),
        ))
    return tuple(futures[:k])


def parse_futures_param(
    raw: Optional[str], state=None, max_futures: int = 256, top_k: int = 8
) -> Tuple[FutureSpec, ...]:
    """The ``futures`` request parameter: a JSON list of future objects;
    absent → the model's :func:`likely_futures` (requires ``state``)."""
    if raw is None or raw == "":
        if state is None:
            raise ValueError(
                "no 'futures' parameter and no model to derive defaults"
            )
        return likely_futures(state, top_k)
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"futures parameter is not valid JSON: {e}") from None
    if isinstance(doc, dict):
        doc = [doc]
    if not isinstance(doc, list) or not doc:
        raise ValueError("futures parameter must be a non-empty JSON list")
    if len(doc) > max_futures:
        raise ValueError(
            f"{len(doc)} futures > cap {max_futures} (whatif.max.futures)"
        )
    return tuple(parse_future(d) for d in doc)

"""Seeded fault-schedule generator — a reproducible "production day".

The scenario suite scripts one fault per timeline by hand; a soak needs a
*composed* day: every fault class the stack has been hardened against, a
continuous HTTP traffic floor, and enough spacing that each heal can
finish before the next fault lands (a schedule that overlaps every fault
is a stress test of the generator, not of the system).  This module turns
a :class:`FaultScheduleConfig` into a :class:`~.timeline.Timeline` built
ONLY from the existing DSL constructors, drawn from one seeded
``random.Random`` — same seed ⇒ same schedule, byte for byte, which is
what makes a full simulated day assertable (and its smoke variant
bit-fingerprintable).

Layout invariants the generator enforces:

* **settle head** — no faults before ``settle_ms``: the monitor needs
  full metric windows before the first detection is meaningful;
* **quiet tail** — no faults after ``duration_ms - quiet_tail_ms``: the
  day must END healed, so the last heal gets room to complete (the
  terminal placement-convergence gate depends on it);
* **minimum spacing** — disruptive faults are placed on a jittered grid
  with at least ``min_spacing_ms`` between any two, so heal latencies
  measure the system, not fault pile-up.  Traffic events (polls, storms)
  are exempt — load is *supposed* to overlap everything;
* **bounded drift** — hot spells revert (factor then 1/factor on the
  same explicit partition set) and load perturbations alternate around
  1.0, so a day of faults doesn't monotonically inflate total cluster
  load into an unhealable capacity wall;
* **paired restores** — disk failures are always repaired, rack losses
  restored, and process crashes scheduled right after an
  execution-causing fault (the arm fires mid-heal) with their restart a
  few minutes later.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional

from cruise_control_tpu_torch.sim.timeline import (
    Timeline,
    TimelineEvent,
    analyzer_outage,
    crash_process,
    disk_failure,
    flap_broker,
    hot_partition_skew,
    http_request,
    kill_broker,
    metric_gap,
    perturb_broker_load,
    rack_loss,
    request_storm,
    restart_process,
    restore_analyzer,
    restore_broker,
    restore_disk,
    stall_execution,
)

MIN_MS = 60_000

#: fault classes that count toward the "distinct classes fired" gate —
#: the restores/pairs ride along with their primary
DISRUPTIVE_KINDS = (
    "kill_broker", "rack_loss", "disk_failure", "hot_partition_skew",
    "perturb_broker_load", "metric_gap", "crash_process", "flap_broker",
    "analyzer_outage", "stall_execution", "request_storm",
)


@dataclasses.dataclass
class FaultScheduleConfig:
    """Per-class counts over the horizon plus the layout constraints."""

    seed: int = 0
    duration_ms: int = 24 * 60 * MIN_MS
    #: cluster shape the victims are drawn from
    num_brokers: int = 1024
    num_racks: int = 16
    num_partitions: int = 4096
    # per-class event counts (0 disables a class)
    broker_deaths: int = 3
    rack_losses: int = 1
    disk_failures: int = 3
    hot_skews: int = 3
    load_perturbations: int = 4
    metric_gaps: int = 2
    process_crashes: int = 1
    broker_flaps: int = 1
    analyzer_outages: int = 1
    execution_stalls: int = 1
    request_storms: int = 2
    storm_clients: int = 12
    # layout constraints
    settle_ms: int = 20 * MIN_MS
    quiet_tail_ms: int = 100 * MIN_MS
    min_spacing_ms: int = 18 * MIN_MS
    #: bounded concurrent multi-fault PILE-UPS (ROADMAP item-5 leftover):
    #: when True, disruptive faults are laid out as clusters of up to
    #: ``pileup_max_cluster`` events one minute apart — the system sees
    #: genuinely overlapping heals — while the CLUSTERS keep the full
    #: ``min_spacing_ms`` guarantee (so pile-ups are a scripted burst,
    #: not an accident of density).  False keeps the historical
    #: one-fault-per-slot layout byte for byte.
    min_spacing_relaxed: bool = False
    #: maximum faults sharing one pile-up cluster (≥1; 1 ≡ not relaxed)
    pileup_max_cluster: int = 2
    #: paired-restore delay (disk replaced, rack powered back, ...)
    heal_ms: int = 10 * MIN_MS
    #: perturb_broker_load factor pool (drawn per event).  Factors > 1
    #: large enough to breach a capacity goal make the perturbation a
    #: goal-violation heal; mild ones are steady-state drift the warm
    #: replans absorb silently.  Alternating directions bound total load.
    perturb_factors: tuple = (4.5, 0.7, 1.5, 0.65)
    # the continuous traffic floor (0 disables)
    http_poll_interval_ms: int = 10 * MIN_MS

    def class_counts(self) -> Dict[str, int]:
        return {
            "kill_broker": self.broker_deaths,
            "rack_loss": self.rack_losses,
            "disk_failure": self.disk_failures,
            "hot_partition_skew": self.hot_skews,
            "perturb_broker_load": self.load_perturbations,
            "metric_gap": self.metric_gaps,
            "crash_process": self.process_crashes,
            "flap_broker": self.broker_flaps,
            "analyzer_outage": self.analyzer_outages,
            "stall_execution": self.execution_stalls,
            "request_storm": self.request_storms,
        }


class ScheduleError(ValueError):
    """The requested counts cannot satisfy the spacing constraints."""


def _slots(cfg: FaultScheduleConfig, rng: random.Random, n: int) -> List[int]:
    """``n`` fault timestamps on a jittered grid inside the fault window,
    minute-aligned.  Default layout: every slot ≥ ``min_spacing_ms``
    from its neighbors.  With ``min_spacing_relaxed``, slots group into
    pile-up clusters of up to ``pileup_max_cluster`` events one minute
    apart; the spacing guarantee then holds between CLUSTERS.  The
    ``k == 1`` path is byte-identical to the historical layout (same
    arithmetic, same rng draw sequence), so existing seeded schedules —
    and the soak fingerprints pinned on them — do not move."""
    if n <= 0:
        return []
    k = max(1, int(cfg.pileup_max_cluster)) if cfg.min_spacing_relaxed else 1
    clusters = -(-n // k)
    # whole-minute arithmetic: the grid guarantee (gap >= min_spacing)
    # must survive minute alignment, so jitter is drawn in minutes too
    start_m = -(-cfg.settle_ms // MIN_MS)
    end_m = (cfg.duration_ms - cfg.quiet_tail_ms) // MIN_MS
    spacing_m = -(-cfg.min_spacing_ms // MIN_MS)
    span_m = end_m - start_m
    if span_m < clusters * spacing_m + (k - 1):
        raise ScheduleError(
            f"{n} disruptive faults ({clusters} cluster(s) of ≤{k}) need "
            f"{clusters * spacing_m + (k - 1)} min of window but only "
            f"{span_m} min exist between the settle head and the quiet "
            "tail — lower the counts or the spacing"
        )
    pitch_m = span_m // clusters
    jitter_m = max(0, (pitch_m - spacing_m - (k - 1)) // 2)
    out: List[int] = []
    for i in range(clusters):
        base_m = (start_m + i * pitch_m + pitch_m // 2
                  + rng.randint(-jitter_m, jitter_m))
        for j in range(k):
            if len(out) < n:
                out.append((base_m + j) * MIN_MS)
    return out


def generate_timeline(cfg: FaultScheduleConfig) -> Timeline:
    """The composed day.  Deterministic in ``cfg`` (including the seed)."""
    rng = random.Random(cfg.seed)
    counts = cfg.class_counts()
    # interleave the classes across the day: a flat list of class names,
    # shuffled once, consumed against the slot grid in order
    classes: List[str] = []
    for kind, n in counts.items():
        classes.extend([kind] * max(0, int(n)))
    rng.shuffle(classes)
    slots = _slots(cfg, rng, len(classes))

    events: List[TimelineEvent] = []
    lost_rack = rng.randrange(cfg.num_racks) if cfg.rack_losses else None

    def pick_broker() -> int:
        # never a broker in the rack scheduled for rack loss (the rack's
        # heal must stay a single clean anomaly), assuming the generator
        # convention broker_rack = b % num_racks (models/generators)
        while True:
            b = rng.randrange(cfg.num_brokers)
            if lost_rack is None or b % cfg.num_racks != lost_rack:
                return b

    def pick_partitions(k: int) -> List[int]:
        return sorted(rng.sample(range(cfg.num_partitions),
                                 min(k, cfg.num_partitions)))

    for at, kind in zip(slots, classes):
        if kind == "kill_broker":
            b = pick_broker()
            events.append(kill_broker(at, broker=b))
            if rng.random() < 0.5:  # half the corpses come back (empty)
                events.append(restore_broker(at + cfg.heal_ms, broker=b))
        elif kind == "rack_loss":
            events.append(rack_loss(at, rack=lost_rack))
            # power restored after the evacuation settled
            for b in range(cfg.num_brokers):
                if b % cfg.num_racks == lost_rack:
                    events.append(restore_broker(at + cfg.heal_ms, broker=b))
        elif kind == "disk_failure":
            b = pick_broker()
            events.append(disk_failure(at, broker=b))
            events.append(restore_disk(at + cfg.heal_ms, broker=b))
        elif kind == "hot_partition_skew":
            # a hot spell: explicit partitions so the revert is exact
            parts = pick_partitions(max(2, cfg.num_partitions // 64))
            factor = rng.uniform(4.0, 7.0)
            events.append(hot_partition_skew(at, factor=factor,
                                             partitions=parts))
            events.append(hot_partition_skew(at + cfg.heal_ms,
                                             factor=1.0 / factor,
                                             partitions=parts))
        elif kind == "perturb_broker_load":
            # persistent drift the warm replans absorb; alternating
            # directions keep total load bounded over the day
            factor = rng.choice(cfg.perturb_factors)
            events.append(perturb_broker_load(at, broker=pick_broker(),
                                              factor=factor))
        elif kind == "metric_gap":
            # the gap must END before the next slot's fault needs healing
            # (a heal attempted on all-stale windows raises — realistic,
            # but a *scheduled* overlap tests the generator, not the stack)
            cap = max(2, cfg.min_spacing_ms // MIN_MS - 1)
            events.append(metric_gap(
                at, duration_ms=min(rng.randint(5, 9), cap) * MIN_MS))
        elif kind == "crash_process":
            # the arm fires once the NEXT execution has moves in flight, so
            # a skew right before guarantees a heal to crash into
            parts = pick_partitions(max(2, cfg.num_partitions // 64))
            factor = rng.uniform(4.0, 6.0)
            events.append(hot_partition_skew(at, factor=factor,
                                             partitions=parts))
            events.append(hot_partition_skew(at + cfg.heal_ms,
                                             factor=1.0 / factor,
                                             partitions=parts))
            events.append(crash_process(at, after_ticks=2))
            # the restart lands well after the heal the arm crashes into;
            # restart_process is a no-op while the process is up, so the
            # early one covers a fast heal and the backstop below covers a
            # crash that fired late
            events.append(restart_process(at + 14 * MIN_MS))
        elif kind == "flap_broker":
            parts = pick_partitions(max(2, cfg.num_partitions // 64))
            factor = rng.uniform(4.0, 6.0)
            events.append(hot_partition_skew(at, factor=factor,
                                             partitions=parts))
            events.append(hot_partition_skew(at + cfg.heal_ms,
                                             factor=1.0 / factor,
                                             partitions=parts))
            events.append(flap_broker(at, down_ticks=3, up_ticks=3,
                                      cycles=2))
        elif kind == "analyzer_outage":
            events.append(analyzer_outage(at))
            events.append(restore_analyzer(at + rng.randint(6, 10) * MIN_MS))
        elif kind == "stall_execution":
            parts = pick_partitions(max(2, cfg.num_partitions // 64))
            factor = rng.uniform(4.0, 6.0)
            events.append(hot_partition_skew(at, factor=factor,
                                             partitions=parts))
            events.append(hot_partition_skew(at + cfg.heal_ms,
                                             factor=1.0 / factor,
                                             partitions=parts))
            events.append(stall_execution(at, ticks=8, batches=1))
        elif kind == "request_storm":
            events.append(request_storm(at, n=cfg.storm_clients,
                                        endpoint="proposals"))
        else:  # pragma: no cover - class table and dispatch kept in sync
            raise ScheduleError(f"unhandled fault class {kind!r}")

    if cfg.process_crashes:
        # backstop: whatever state the crash arm left the day in, the
        # process is up for the quiet tail (no-op when already up)
        events.append(restart_process(
            cfg.duration_ms - cfg.quiet_tail_ms + 2 * MIN_MS
        ))

    # the traffic floor: paired proposals polls (the second of a pair
    # lands on the generation the first just validated, so the warm
    # cache's fresh-hit path — and its serve p99 — carries data all day)
    # with periodic state/health reads
    if cfg.http_poll_interval_ms > 0:
        i = 0
        t = cfg.settle_ms // 2
        while t < cfg.duration_ms - 2 * MIN_MS:
            if i % 7 == 5:
                events.append(http_request(t, "state"))
            elif i % 7 == 6:
                events.append(http_request(t, "health"))
            else:
                events.append(http_request(t, "proposals"))
                events.append(http_request(t, "proposals"))
            t += cfg.http_poll_interval_ms
            i += 1
    return Timeline(events)


def schedule_summary(timeline: Timeline,
                     cfg: Optional[FaultScheduleConfig] = None) -> dict:
    """The artifact's fault inventory: per-kind counts + layout bounds."""
    kinds = timeline.kinds()
    disruptive = {k: v for k, v in kinds.items() if k in DISRUPTIVE_KINDS}
    fault_times = [e.at_ms for e in timeline.events
                   if e.kind in DISRUPTIVE_KINDS]
    return {
        "events": len(timeline),
        "kinds": dict(sorted(kinds.items())),
        "distinctFaultClasses": len(disruptive),
        "firstFaultMs": min(fault_times) if fault_times else None,
        "lastFaultMs": max(fault_times) if fault_times else None,
        "seed": cfg.seed if cfg else None,
    }

"""Declarative fault timelines — the scenario DSL.

A timeline is an ordered list of :class:`TimelineEvent` records, each a
``(at_ms, kind, args)`` triple at a **virtual** timestamp.  The simulator
driver (:mod:`cruise_control_tpu_torch.sim.simulator`) pops due events every tick
and applies them to the scripted cluster backend / workload synthesizer —
the system under test (monitor → detector → analyzer → executor) only ever
sees their *consequences* through its normal interfaces, exactly like a real
deployment sees a broker vanish from metadata.

Event vocabulary (SURVEY.md §2.8's anomaly matrix, plus execution-level
faults the executor must survive):

``kill_broker`` / ``restore_broker``
    Broker death (leaders fail over to surviving ISR members) / recovery.
``kill_broker_mid_execution``
    Arms the backend: once the NEXT execution has reassignments in flight,
    the broker dies ``after_ticks`` backend ticks later — the
    broker-death-mid-rebalance case no fixed timestamp can script reliably.
``rack_loss``
    Kills every broker in a rack at once.
``disk_failure`` / ``restore_disk``
    JBOD log dirs go offline on an alive broker / the disk is replaced.
``hot_partition_skew``
    Multiplies the synthesized load of a partition subset (explicit ids, or
    "partitions currently led by broker N" resolved at fire time).
``perturb_broker_load``
    Scales the synthesized load of every partition HOSTED on one broker
    (replica membership resolved at fire time) — the canonical
    steady-state drift the delta-replan subsystem warm-starts over.
``add_broker``
    A new empty broker joins the cluster metadata.
``maintenance_event``
    Appends an operator event to the maintenance stream
    (:class:`~cruise_control_tpu_torch.detector.detectors.MaintenanceEventReader`).
``metric_gap``
    The metrics reporter goes dark for a duration — detectors must cope
    with stale windows.
``stall_execution``
    The next ``batches`` reassignment batches make no progress for
    ``ticks`` backend ticks (scripted executor stall → task timeout path).
``fail_partition``
    Reassignments for the partition are silently dropped by the backend
    (the executor's replica-mismatch/timeout DEAD path).
``crash_process`` / ``restart_process``
    Process death and rebirth of the WHOLE control plane.  ``crash_process``
    arms the backend: once the next execution has reassignments in flight,
    ``after_ticks`` backend ticks later a
    :class:`~cruise_control_tpu_torch.executor.journal.ProcessCrash` unwinds the
    executor mid-drive (no cleanup runs — exactly like a real SIGKILL; the
    execution checkpoint freezes at the crash point).  The cluster lives on
    while the process is down (moves keep progressing).  ``restart_process``
    rebuilds the monitor → detector → analyzer → executor stack and runs
    the facade's checkpoint recovery path.
``flap_broker``
    A broker repeatedly dies and recovers mid-execution (``down_ticks``
    dead / ``up_ticks`` alive, ``cycles`` times, starting once the next
    execution has moves in flight).  ``broker=None`` flaps whichever broker
    is catching up replicas when the flapping starts — the executor's
    timeout → retry-with-backoff path.
``http_request`` / ``request_storm`` / ``slow_client``
    Serving-layer chaos (ISSUE 8): real HTTP requests against the
    scenario's front door — one synchronous request, N concurrent
    clients, or a slow-loris connection probe.
``analyzer_outage`` / ``restore_analyzer``
    Scripted analyzer failure window: every optimization raises until
    restored — degraded-mode serving + circuit-breaker territory.
``corrupt_metrics``
    Byzantine metrics (ISSUE 13): for a window, the reporter's records
    for one broker are poisoned — NaN broker CPU (which upstream of the
    validation stage would flow reporter → topic → sampler → aggregator
    → model unchecked) plus a record for a broker metadata has never
    seen.  The monitor's quarantine stage must reject them.
``corrupt_checkpoint``
    Flips one byte mid-file in the durable execution checkpoint while
    the process is down — the restarted process's recovery must detect
    the damage via the per-record CRC (``executor.checkpoint_corrupt``)
    and reconcile from the last good record, never adopt a
    bit-flipped-but-parseable plan.
``fail_engine`` / ``restore_engine``
    Scripted TPU-engine failure (XLA OOM / compile error stand-in): TPU
    optimizations raise until restored while the greedy engine stays
    healthy — the engine degradation ladder's territory.
``foreign_reassignment``
    A concurrent writer (ISSUE 15): a reassignment the executor never
    planned lands on the cluster — immediately, or armed to fire
    mid-execution on a disjoint or conflicting partition.
``zombie_controller_resume``
    The crashed process's stale incarnation thaws and re-resumes the
    checkpoint a restarted process already owns — the fencing epoch must
    refuse it loudly (``executor.fenced``).
``create_topic`` / ``delete_topic``
    Topology drift mid-scenario: partitions appear in metadata, or
    vanish (optionally armed to land mid-execution — the per-batch
    precondition revalidation's territory).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.detector.anomalies import MaintenanceEvent

KINDS = (
    "kill_broker",
    "restore_broker",
    "kill_broker_mid_execution",
    "rack_loss",
    "disk_failure",
    "restore_disk",
    "hot_partition_skew",
    "perturb_broker_load",
    "add_broker",
    "maintenance_event",
    "metric_gap",
    "stall_execution",
    "fail_partition",
    "crash_process",
    "restart_process",
    "flap_broker",
    "http_request",
    "request_storm",
    "slow_client",
    "analyzer_outage",
    "restore_analyzer",
    "corrupt_metrics",
    "corrupt_checkpoint",
    "fail_engine",
    "restore_engine",
    "foreign_reassignment",
    "zombie_controller_resume",
    "create_topic",
    "delete_topic",
)


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    """One scripted fault at a virtual timestamp."""

    at_ms: int
    kind: str
    args: tuple  # sorted (key, value) pairs — hashable and deterministic

    def arg(self, name, default=None):
        return dict(self.args).get(name, default)

    def to_json(self) -> dict:
        return {"atMs": self.at_ms, "kind": self.kind, **dict(self.args)}


def _event(at_ms: int, kind: str, **args) -> TimelineEvent:
    if kind not in KINDS:
        raise ValueError(f"unknown timeline event kind {kind!r}")
    if at_ms < 0:
        raise ValueError(f"{kind}: at_ms must be >= 0, got {at_ms}")
    return TimelineEvent(int(at_ms), kind, tuple(sorted(args.items())))


# ---- constructors (the DSL surface) ---------------------------------------------
def kill_broker(at_ms: int, broker: int) -> TimelineEvent:
    return _event(at_ms, "kill_broker", broker=int(broker))


def restore_broker(at_ms: int, broker: int) -> TimelineEvent:
    return _event(at_ms, "restore_broker", broker=int(broker))


def kill_broker_mid_execution(
    at_ms: int, broker: Optional[int] = None, after_ticks: int = 2
) -> TimelineEvent:
    """``broker=None``: the backend kills whichever broker is catching up
    replicas when the countdown fires — the death is guaranteed to strand
    in-flight moves, whatever destinations the optimizer picked."""
    return _event(at_ms, "kill_broker_mid_execution",
                  broker=int(broker) if broker is not None else None,
                  after_ticks=int(after_ticks))


def rack_loss(at_ms: int, rack: int) -> TimelineEvent:
    return _event(at_ms, "rack_loss", rack=int(rack))


def disk_failure(at_ms: int, broker: int,
                 dirs: Sequence[str] = ("d0",)) -> TimelineEvent:
    return _event(at_ms, "disk_failure", broker=int(broker),
                  dirs=tuple(dirs))


def restore_disk(at_ms: int, broker: int) -> TimelineEvent:
    return _event(at_ms, "restore_disk", broker=int(broker))


def hot_partition_skew(
    at_ms: int,
    factor: float,
    partitions: Optional[Sequence[int]] = None,
    leader: Optional[int] = None,
) -> TimelineEvent:
    """Skew explicit ``partitions``, or the partitions led by ``leader`` at
    the moment the event fires (exactly one selector must be given)."""
    if (partitions is None) == (leader is None):
        raise ValueError(
            "hot_partition_skew needs exactly one of partitions= / leader="
        )
    return _event(
        at_ms, "hot_partition_skew", factor=float(factor),
        partitions=tuple(int(p) for p in partitions) if partitions else None,
        leader=int(leader) if leader is not None else None,
    )


def perturb_broker_load(
    at_ms: int, broker: int, factor: float
) -> TimelineEvent:
    """Scale the load of every partition hosted on ``broker`` (resolved
    from the live placement when the event fires) by ``factor``.  The
    scaled load follows the partitions through subsequent rebalances —
    this is persistent drift, not a transient spike."""
    return _event(at_ms, "perturb_broker_load", broker=int(broker),
                  factor=float(factor))


def add_broker(at_ms: int, broker: int, rack: int) -> TimelineEvent:
    return _event(at_ms, "add_broker", broker=int(broker), rack=int(rack))


def maintenance_event(at_ms: int, event_type: str,
                      brokers: Sequence[int] = ()) -> TimelineEvent:
    if event_type not in MaintenanceEvent.TYPES:
        raise ValueError(f"unknown maintenance event type {event_type!r}")
    return _event(at_ms, "maintenance_event", event_type=event_type,
                  brokers=tuple(int(b) for b in brokers))


def metric_gap(at_ms: int, duration_ms: int) -> TimelineEvent:
    return _event(at_ms, "metric_gap", duration_ms=int(duration_ms))


def stall_execution(at_ms: int, ticks: int, batches: int = 1) -> TimelineEvent:
    return _event(at_ms, "stall_execution", ticks=int(ticks),
                  batches=int(batches))


def fail_partition(at_ms: int, partition: int) -> TimelineEvent:
    return _event(at_ms, "fail_partition", partition=int(partition))


def crash_process(at_ms: int, after_ticks: int = 2) -> TimelineEvent:
    """Arm a process crash: the control plane dies ``after_ticks`` backend
    ticks after the NEXT execution puts reassignments in flight."""
    return _event(at_ms, "crash_process", after_ticks=int(after_ticks))


def restart_process(at_ms: int) -> TimelineEvent:
    """Rebuild the control plane and run checkpoint recovery (no-op when
    the process is not down)."""
    return _event(at_ms, "restart_process")


def flap_broker(
    at_ms: int,
    broker: Optional[int] = None,
    down_ticks: int = 8,
    up_ticks: int = 8,
    cycles: int = 2,
) -> TimelineEvent:
    """``broker=None``: flap whichever broker is catching up replicas when
    the flapping starts (guaranteed to hit in-flight moves)."""
    return _event(
        at_ms, "flap_broker",
        broker=int(broker) if broker is not None else None,
        down_ticks=int(down_ticks), up_ticks=int(up_ticks),
        cycles=int(cycles),
    )


# ---- serving-layer chaos (ISSUE 8): requests as timeline events -----------------
def http_request(
    at_ms: int,
    endpoint: str,
    method: str = "GET",
    params: Optional[Dict[str, str]] = None,
    deadline_ms: Optional[int] = None,
) -> TimelineEvent:
    """One REAL HTTP request against the scenario's front door, issued
    synchronously at the virtual timestamp (the spec must set
    ``serve_http=True``).  The response is journaled as ``sim.http``
    (status, Retry-After presence, cached/stale markers)."""
    return _event(
        at_ms, "http_request", endpoint=str(endpoint),
        method=method.upper(),
        params=tuple(sorted((params or {}).items())),
        deadline_ms=int(deadline_ms) if deadline_ms is not None else None,
    )


def request_storm(
    at_ms: int,
    n: int,
    endpoint: str,
    method: str = "GET",
    params: Optional[Dict[str, str]] = None,
) -> TimelineEvent:
    """``n`` concurrent clients hitting one endpoint at once.  Per-request
    results are aggregated into ONE ``sim.http_storm`` journal event
    (status counts, sheds with/without Retry-After, unhandled 5xx) —
    concurrency makes per-request journal order nondeterministic, so storm
    scenarios stay out of the bit-fingerprinted smoke set."""
    return _event(
        at_ms, "request_storm", n=int(n), endpoint=str(endpoint),
        method=method.upper(),
        params=tuple(sorted((params or {}).items())),
    )


def slow_client(at_ms: int, hold_s: float = 2.0) -> TimelineEvent:
    """A slow-loris probe: open a raw connection, trickle a partial
    request, and verify the server reaps the connection within its
    read timeout instead of pinning a handler thread (``hold_s`` bounds
    the wall-clock wait for the reap)."""
    return _event(at_ms, "slow_client", hold_s=float(hold_s))


def analyzer_outage(at_ms: int) -> TimelineEvent:
    """From this point every optimization raises (scripted analyzer
    failure): proposal serving must degrade to the last-good cached plan
    and the circuit breaker must trip after repeated failures."""
    return _event(at_ms, "analyzer_outage")


def restore_analyzer(at_ms: int) -> TimelineEvent:
    return _event(at_ms, "restore_analyzer")


# ---- data-integrity chaos (ISSUE 13) --------------------------------------------
def corrupt_metrics(at_ms: int, broker: int,
                    duration_ms: int) -> TimelineEvent:
    """Poison the metrics stream for ``broker`` for ``duration_ms``:
    every reporting interval inside the window also produces a NaN
    BROKER_CPU_UTIL record for the broker (overriding the honest one)
    and a record for a broker id metadata has never seen."""
    return _event(at_ms, "corrupt_metrics", broker=int(broker),
                  duration_ms=int(duration_ms))


def corrupt_checkpoint(at_ms: int, line: int = 1) -> TimelineEvent:
    """Flip one byte in the middle of non-empty line ``line`` of the
    execution checkpoint file (clipped to the penultimate line, so the
    damage is always MID-FILE — the torn-tail path is a different,
    already-tolerated animal).  Fire it while the process is down."""
    return _event(at_ms, "corrupt_checkpoint", line=int(line))


# ---- concurrent-controller chaos (ISSUE 15) -------------------------------------
def foreign_reassignment(
    at_ms: int,
    partition: Optional[int] = None,
    conflict: bool = False,
    after_ticks: Optional[int] = None,
) -> TimelineEvent:
    """A FOREIGN writer (second controller / kafka-reassign-partitions)
    issues a reassignment the executor did not plan.  With ``after_ticks``
    the alter is ARMED: it fires that many backend ticks after the next
    execution has moves in flight — ``conflict=True`` re-targets one of
    the execution's own in-flight partitions (the executor must yield or
    abort per policy), ``conflict=False`` picks a partition the plan does
    not touch (must be tolerated).  Without ``after_ticks`` the alter
    applies immediately to ``partition`` (or the lowest currently
    unreassigned partition)."""
    return _event(
        at_ms, "foreign_reassignment",
        partition=int(partition) if partition is not None else None,
        conflict=bool(conflict),
        after_ticks=int(after_ticks) if after_ticks is not None else None,
    )


def zombie_controller_resume(at_ms: int) -> TimelineEvent:
    """The CRASHED process's stale incarnation thaws and tries to resume
    the execution checkpoint it once owned — after a restarted process
    already took it over.  Its conditional epoch claim must be refused
    (``executor.fenced``) before it mutates anything; fire this after a
    ``crash_process`` + ``restart_process`` pair."""
    return _event(at_ms, "zombie_controller_resume")


def create_topic(at_ms: int, topic: str, partitions: int = 4,
                 replication_factor: int = 2) -> TimelineEvent:
    """A new topic appears in metadata mid-scenario (topology drift the
    monitor and any in-flight execution must absorb)."""
    return _event(at_ms, "create_topic", topic=str(topic),
                  partitions=int(partitions),
                  replication_factor=int(replication_factor))


def delete_topic(at_ms: int, topic: str,
                 after_ticks: Optional[int] = None) -> TimelineEvent:
    """A topic is deleted mid-scenario.  With ``after_ticks`` the
    deletion is ARMED: it lands that many backend ticks after the next
    execution has moves in flight — tasks touching the vanished
    partitions must cancel ``topology-drift:deleted``, not burn the
    retry budget as replica-mismatch failures."""
    return _event(
        at_ms, "delete_topic", topic=str(topic),
        after_ticks=int(after_ticks) if after_ticks is not None else None,
    )


def fail_engine(at_ms: int) -> TimelineEvent:
    """From this point every TPU-engine optimization raises (scripted
    XLA OOM); the greedy engine keeps working — the degradation ladder
    must serve operations on it."""
    return _event(at_ms, "fail_engine")


def restore_engine(at_ms: int) -> TimelineEvent:
    return _event(at_ms, "restore_engine")


class Timeline:
    """Sorted event schedule with a consume cursor (the driver pops due
    events once; re-running a scenario builds a fresh Timeline)."""

    def __init__(self, events: Sequence[TimelineEvent] = ()):
        # stable sort: same-timestamp events fire in authoring order
        self.events: List[TimelineEvent] = sorted(
            events, key=lambda e: e.at_ms
        )
        self._cursor = 0

    def __len__(self) -> int:
        return len(self.events)

    def pop_due(self, now_ms: int) -> List[TimelineEvent]:
        """Events with ``at_ms <= now_ms`` not yet returned, in order."""
        out: List[TimelineEvent] = []
        while (self._cursor < len(self.events)
               and self.events[self._cursor].at_ms <= now_ms):
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def reset(self) -> None:
        self._cursor = 0

    @property
    def end_ms(self) -> int:
        return self.events[-1].at_ms if self.events else 0

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

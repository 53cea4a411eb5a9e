"""ScriptedClusterBackend — the simulated cluster with timeline hooks.

Extends :class:`~cruise_control_tpu_torch.executor.backend.SimulatedClusterBackend`
(the deterministic state machine the executor drives) with the fault
machinery scenario timelines need:

* broker kill/restore with **leader failover** to a surviving ISR member
  (what the Kafka controller does the moment a broker session expires);
* rack topology + whole-rack loss;
* broker adds (a new empty broker joins metadata);
* scripted **stalls** of individual reassignment batches (in-flight moves
  make no progress for N ticks — the executor's timeout/DEAD path);
* an armed **mid-execution kill**: the broker dies a fixed number of ticks
  after the next execution puts reassignments in flight, which no absolute
  timestamp can script reliably.

It also fixes a liveness gap the base class doesn't need: a *new*
reassignment for a partition cancels the stale catching-up replicas of the
previous one (upstream ``alterPartitionReassignments`` semantics), so a
heal plan issued after a broker died mid-move is not blocked forever by the
dead broker's abandoned catch-up entry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from cruise_control_tpu_torch.executor.backend import SimulatedClusterBackend
from cruise_control_tpu_torch.executor.journal import ProcessCrash


class ScriptedClusterBackend(SimulatedClusterBackend):
    def __init__(
        self,
        assignment: Dict[int, Sequence[int]],
        leaders: Dict[int, int],
        brokers: Set[int],
        broker_racks: Dict[int, int],
        move_latency_ticks: int = 1,
    ):
        super().__init__(assignment, leaders,
                         move_latency_ticks=move_latency_ticks,
                         brokers=set(brokers))
        #: virtual-clock source the driver injects (sim.now_ms): armed
        #: kills/flaps journal the moment they actually FIRE — the arm
        #: marker alone charges heal latency from a countdown that may
        #: sit frozen for hours between executions (backend ticks only
        #: advance while moves are in flight)
        self.clock_ms = None
        #: broker → rack id; the metadata client shares this dict, so
        #: add_broker updates both views at once
        self.broker_racks: Dict[int, int] = dict(broker_racks)
        #: scripted stall: batches left to stall, and for how many ticks
        self._stall_batches_left = 0
        self._stall_ticks = 0
        self._stalled: Dict[int, int] = {}  # partition → ticks remaining
        #: armed mid-execution kill: (broker, ticks after first in-flight)
        self._armed_kill: Optional[tuple] = None
        self._armed_countdown: Optional[int] = None
        #: armed process crash: ticks after first in-flight reassignment
        self._armed_crash: Optional[int] = None
        self._crash_countdown: Optional[int] = None
        #: armed broker flapping: (broker|None, down, up, cycles)
        self._armed_flap: Optional[tuple] = None
        #: live flap state machine: [broker, phase_ticks_left, is_down,
        #: cycles_left, down_ticks, up_ticks]
        self._flap_state: Optional[list] = None
        #: armed foreign reassignment: (partition|None, conflict,
        #: ticks after first in-flight)
        self._armed_foreign: Optional[tuple] = None
        self._foreign_countdown: Optional[int] = None
        #: armed topic deletion: (partitions, ticks after first in-flight)
        self._armed_delete: Optional[tuple] = None
        self._delete_countdown: Optional[int] = None

    def _journal_fired(self, fault: str, **args) -> None:
        """The armed fault actually landed: a journal marker at the REAL
        virtual time (heal-latency pairing reads these; the arm-time
        sim.fault marker stays for schedule provenance)."""
        if self.clock_ms is None:
            return
        from cruise_control_tpu_torch.telemetry import events

        events.emit("sim.fault", fault=fault,
                    virtualMs=int(self.clock_ms()), args=args)

    # ---- timeline surface -------------------------------------------------------
    def kill_broker(self, broker: int) -> None:
        self.failed_brokers.add(broker)
        for st in self.partitions.values():
            if st.leader == broker:
                live = [b for b in st.isr if b not in self.failed_brokers]
                if live:
                    st.leader = live[0]

    def restore_broker(self, broker: int) -> None:
        self.failed_brokers.discard(broker)

    def kill_rack(self, rack: int) -> List[int]:
        killed = sorted(
            b for b, r in self.broker_racks.items()
            if r == rack and b in self.brokers
            and b not in self.failed_brokers
        )
        for b in killed:
            self.kill_broker(b)
        return killed

    def add_broker(self, broker: int, rack: int) -> None:
        self.brokers.add(broker)
        self.broker_racks[broker] = rack

    def fail_disk(self, broker: int, dirs: Sequence[str]) -> None:
        have = self.offline_dirs.setdefault(broker, [])
        for d in dirs:
            if d not in have:
                have.append(d)

    def restore_disk(self, broker: int) -> None:
        self.offline_dirs.pop(broker, None)

    def stall_next_batches(self, ticks: int, batches: int = 1) -> None:
        self._stall_ticks = int(ticks)
        self._stall_batches_left = int(batches)

    def arm_kill_mid_execution(self, broker: Optional[int],
                               after_ticks: int) -> None:
        """``broker=None`` kills whichever broker is catching up replicas
        when the countdown fires — guaranteeing the death strands in-flight
        moves regardless of what the optimizer chose as destinations."""
        self._armed_kill = (
            int(broker) if broker is not None else None,
            max(1, int(after_ticks)),
        )
        self._armed_countdown = None

    def arm_crash_mid_execution(self, after_ticks: int) -> None:
        """The control plane dies ``after_ticks`` ticks after the next
        execution puts reassignments in flight: ``tick()`` raises
        ProcessCrash, which unwinds the executor without any cleanup."""
        self._armed_crash = max(1, int(after_ticks))
        self._crash_countdown = None

    def arm_flap_mid_execution(
        self,
        broker: Optional[int],
        down_ticks: int,
        up_ticks: int,
        cycles: int,
    ) -> None:
        """``broker=None``: flap whichever broker is catching up replicas
        when the flapping starts (the executor's timeout/retry path)."""
        self._armed_flap = (
            int(broker) if broker is not None else None,
            max(1, int(down_ticks)), max(1, int(up_ticks)),
            max(1, int(cycles)),
        )
        self._flap_state = None

    def arm_foreign_reassignment(self, partition: Optional[int],
                                 conflict: bool, after_ticks: int) -> None:
        """A FOREIGN alter fires ``after_ticks`` ticks after the next
        execution puts reassignments in flight: ``conflict=True`` hijacks
        one of the execution's own in-flight partitions, otherwise a
        partition the execution is not touching is moved."""
        self._armed_foreign = (
            int(partition) if partition is not None else None,
            bool(conflict), max(1, int(after_ticks)),
        )
        self._foreign_countdown = None

    def arm_delete_partitions(self, partitions: Sequence[int],
                              after_ticks: int) -> None:
        """The listed partitions vanish from metadata ``after_ticks``
        ticks after the next execution has moves in flight (armed
        ``delete_topic``)."""
        self._armed_delete = (
            sorted(int(p) for p in partitions), max(1, int(after_ticks))
        )
        self._delete_countdown = None

    def foreign_reassign(self, partition: Optional[int] = None,
                         conflict: bool = False) -> Optional[dict]:
        """Apply one foreign alter NOW (deterministically): conflict picks
        the lowest in-flight partition and re-targets it; disjoint picks
        the lowest settled partition.  The new target replaces the last
        replica with the lowest-id alive broker not already hosting the
        partition.  Returns {partition, target} or None when no candidate
        exists (e.g. nothing in flight to conflict with)."""
        if partition is None:
            pool = (
                sorted(self._target) if conflict
                else sorted(p for p in self.partitions
                            if p not in self._target)
            )
            if not pool:
                return None
            partition = pool[0]
        st = self.partitions.get(partition)
        if st is None:
            return None
        candidates = sorted(
            b for b in self.brokers
            if b not in self.failed_brokers and b not in st.replicas
        )
        if not candidates:
            return None
        # target from the SETTLED replica set (mid-catch-up adds of an
        # in-flight move excluded), last member replaced — a real
        # kafka-reassign-partitions run targets a same-RF replica list
        base = [b for b in st.replicas if b not in st.catching_up] \
            or list(st.replicas)
        target = base[:-1] + [candidates[0]]
        # a foreign writer goes straight at the admin surface — no fencing
        # discipline, exactly like a raw kafka-reassign-partitions run
        self.alter_partition_reassignments({partition: target})
        self._journal_fired("foreign_reassignment", partition=partition,
                            target=target, conflict=conflict)
        return {"partition": partition, "target": target}

    def _first_catching_up(self) -> Optional[int]:
        catching = {
            b
            for p in self._target
            for b in self.partitions[p].catching_up
            if b not in self.failed_brokers
        }
        return min(catching) if catching else None

    # ---- admin overrides --------------------------------------------------------
    def alter_partition_reassignments(
        self, reassignments: Dict[int, Sequence[int]]
    ) -> None:
        # upstream semantics: a new reassignment for a partition cancels the
        # previous one's still-catching-up adds — drop them from the replica
        # set so a dead broker's abandoned catch-up can't block the heal
        for p, new in reassignments.items():
            st = self.partitions.get(p)
            if st is None:
                continue
            stale = {b for b in st.catching_up if b not in new}
            if stale:
                st.catching_up -= stale
                st.replicas = [b for b in st.replicas if b not in stale]
                self._promote_leader(st)
        super().alter_partition_reassignments(reassignments)
        if self._stall_batches_left > 0:
            self._stall_batches_left -= 1
            for p in reassignments:
                if p in self._target:
                    self._stalled[p] = self._stall_ticks

    # ---- simulation -------------------------------------------------------------
    def tick(self) -> None:
        if self._armed_crash is not None:
            if self._crash_countdown is None and self._target:
                self._crash_countdown = self._armed_crash
            if self._crash_countdown is not None:
                self._crash_countdown -= 1
                if self._crash_countdown <= 0:
                    self._armed_crash = None
                    self._crash_countdown = None
                    # unwinds the executor mid-drive with no cleanup (the
                    # driver catches it and marks the process down)
                    raise ProcessCrash("scripted crash_process fired")
        if self._armed_flap is not None and self._target:
            broker, down, up, cycles = self._armed_flap
            if broker is None:
                broker = self._first_catching_up()
            if broker is not None:
                self._armed_flap = None
                # [broker, phase_ticks_left, is_down, cycles_left, down, up]
                self._flap_state = [broker, down, True, cycles, down, up]
                self.kill_broker(broker)
                self._journal_fired("kill_broker", broker=broker,
                                    via="flap")
        elif self._flap_state is not None:
            st = self._flap_state
            st[1] -= 1
            if st[1] <= 0:
                broker = st[0]
                if st[2]:  # down phase over: broker comes back
                    self.restore_broker(broker)
                    self._journal_fired("restore_broker", broker=broker,
                                        via="flap")
                    st[2] = False
                    st[1] = st[5]
                    st[3] -= 1
                elif st[3] <= 0:  # all cycles done, broker stays up
                    self._flap_state = None
                else:  # up phase over: broker dies again
                    self.kill_broker(broker)
                    self._journal_fired("kill_broker", broker=broker,
                                        via="flap")
                    st[2] = True
                    st[1] = st[4]
        if self._armed_foreign is not None:
            if self._foreign_countdown is None and self._target:
                self._foreign_countdown = self._armed_foreign[2]
            if self._foreign_countdown is not None:
                self._foreign_countdown -= 1
                if self._foreign_countdown <= 0:
                    p, conflict, _ = self._armed_foreign
                    applied = self.foreign_reassign(p, conflict)
                    if applied is None and conflict:
                        # nothing in flight to hijack yet: re-check next tick
                        self._foreign_countdown = 1
                    else:
                        self._armed_foreign = None
                        self._foreign_countdown = None
        if self._armed_delete is not None:
            if self._delete_countdown is None and self._target:
                self._delete_countdown = self._armed_delete[1]
            if self._delete_countdown is not None:
                self._delete_countdown -= 1
                if self._delete_countdown <= 0:
                    parts, _ = self._armed_delete
                    self.delete_partitions(parts)
                    self._journal_fired("delete_topic", partitions=parts)
                    self._armed_delete = None
                    self._delete_countdown = None
        if self._armed_kill is not None:
            if self._armed_countdown is None and self._target:
                self._armed_countdown = self._armed_kill[1]
            if self._armed_countdown is not None:
                self._armed_countdown -= 1
                if self._armed_countdown <= 0:
                    victim = self._armed_kill[0]
                    if victim is None:
                        catching = {
                            b
                            for p in self._target
                            for b in self.partitions[p].catching_up
                            if b not in self.failed_brokers
                        }
                        victim = min(catching) if catching else None
                    if victim is None:
                        # nothing mid-catch-up yet: re-check next tick
                        self._armed_countdown = 1
                    else:
                        self.kill_broker(victim)
                        self._journal_fired("kill_broker", broker=victim,
                                            via="armed")
                        self._armed_kill = None
                        self._armed_countdown = None
        stalled = {p for p, left in self._stalled.items() if left > 0}
        for p in list(self._stalled):
            self._stalled[p] -= 1
            if self._stalled[p] <= 0:
                del self._stalled[p]
        if not stalled:
            super().tick()
            return
        # hide stalled reassignments from the base tick so they make no
        # progress (restored before anyone else can observe the gap)
        hidden = {p: self._target.pop(p) for p in stalled
                  if p in self._target}
        hidden_prog = {p: self._progress.pop(p) for p in hidden}
        try:
            super().tick()
        finally:
            self._target.update(hidden)
            self._progress.update(hidden_prog)

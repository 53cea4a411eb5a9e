"""Write-ahead execution checkpoint journal
(``cc-tpu-execution-checkpoint/1``).

Upstream Cruise Control survives controller restarts because execution
state is reconstructable from the cluster itself (SURVEY.md §2.6: the
Executor detects ongoing reassignments at startup).  That only recovers
the *what* — which partitions are mid-move — not the *plan*: which moves
were part of the execution, which already completed, what strategy and
budget the operator approved.  This journal persists exactly that, as an
append-only JSONL checkpoint the :class:`~.executor.Executor` writes at
every state transition of its drive loop:

``start``
    The full approved plan — proposals, strategy, sizes, the retry/
    timeout config in force — written before the first batch dispatches.
``batch``
    Write-ahead batch watermark: task ids + partitions recorded BEFORE
    the backend ``alterPartitionReassignments`` call, so a crash between
    journal and cluster is recovered conservatively (the reassignment
    may or may not have reached the cluster; reconciliation re-issues).
``task``
    A per-task state transition (COMPLETED / DEAD / ABORTED / a retry
    back to PENDING, with the attempt count and any re-planned
    destination).
``phase`` / ``throttle`` / ``resume``
    Drive-phase watermarks, throttle state, and the reconciliation
    summary a recovery wrote when it adopted this checkpoint.
``end``
    Terminal record; the file is then atomically truncated — a
    checkpoint only ever describes the one execution that might need
    recovering (history lives in the telemetry event journal).

Durability model: **group commit**.  Records that gate an external side
effect — ``start`` and ``batch``, the write-ahead barriers — force a
flush of everything buffered before the cluster sees the corresponding
call; ``task``/``phase``/``throttle`` records coalesce in memory and
flush at the next barrier (or every 64 records).  Losing a buffered
record to a crash is safe by construction: reconciliation falls back to
comparing live backend state against the plan, so a lost COMPLETED
record is re-derived as completed-while-down and a lost retry record is
re-issued.  Rotation (when the file exceeds ``max_bytes``) atomically
replaces the file with a compacted snapshot — ``start`` + the latest
per-task states — via ``os.replace`` so no crash point can leave a torn
checkpoint.  ``load()`` skips undecodable lines (a torn final line from
a real crash) and returns the checkpoint only when the last execution
never wrote its ``end`` record.

Fencing (ISSUE 15): every record carries the owner's **controller
epoch** (``set_epoch``, stamped as a top-level record member next to
``seq``).  Recovery claims the next epoch cluster-side CONDITIONALLY on
the checkpoint's recorded epoch (compare-and-swap), so a zombie process
resuming a checkpoint a newer process already took over is refused
before it mutates anything; ``load()`` surfaces the latest recorded
epoch (and the last throttle state, for orphaned-throttle adoption) on
the :class:`ExecutionCheckpoint`.

Integrity (ISSUE 13): every record is framed with a per-record CRC32
member (:mod:`cruise_control_tpu_torch.utils.checksum`; format-versioned —
pre-CRC logs still load).  ``load()`` distinguishes a **torn tail** (the
final line undecodable or CRC-mismatched — expected from a real crash
mid-write, dropped with a warning exactly as before) from **mid-file
corruption** (any earlier bad line — bit rot, a truncated-then-appended
file, operator damage): the latter fails loudly — ``LOG.error`` plus an
``executor.checkpoint_corrupt`` journal event — and the checkpoint is
treated as absent after the last good record before the corruption (the
suffix's ordering can no longer be trusted; reconciliation re-derives
the rest from live cluster state, which the group-commit durability
model already guarantees is safe).

Crash injection: :meth:`crash_after` arms a simulated process death used
by the chaos simulator and the crash-consistency tests —
:class:`ProcessCrash` deliberately subclasses ``BaseException`` so the
stack's broad ``except Exception`` guards (detector loop, fix handler)
cannot swallow a simulated death, and once raised the journal freezes:
nothing the dying process attempts afterwards reaches disk, exactly like
a real crash.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from cruise_control_tpu_torch.analyzer.goal_optimizer import ExecutionProposal
from cruise_control_tpu_torch.utils.checksum import scan_lines, stamp_line
from cruise_control_tpu_torch.utils.locks import InstrumentedLock
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("executor.journal")

SCHEMA = "cc-tpu-execution-checkpoint/1"

_DEFAULT_MAX_BYTES = 4 * 1024 * 1024

#: record vocabulary (the checked-in artifact schema enumerates these)
KINDS = ("start", "batch", "task", "phase", "throttle", "resume", "end")

#: write-ahead barriers: these must reach disk before append returns
#: (start/batch gate cluster calls; resume/end gate recovery decisions;
#: throttle gates the dynamic-config writes — a lost throttle record
#: would orphan the dead run's throttles, since unlike placements they
#: cannot be re-derived from live cluster state alone)
_FLUSH_KINDS = frozenset({"start", "batch", "throttle", "resume", "end"})

#: coalesced records are force-flushed after this many anyway
_MAX_BUFFERED = 64


class ProcessCrash(BaseException):
    """Simulated process death (chaos simulator + crash-consistency
    tests).  A BaseException on purpose: the production stack's broad
    ``except Exception`` guards must not be able to swallow a simulated
    crash — it has to unwind the whole control plane like a real one."""


def proposal_to_record(p: ExecutionProposal) -> list:
    """Compact positional encoding — the ``start`` record carries the
    whole plan, and repeating dict keys per proposal triples its size and
    serialization cost (the bench's <=1%% checkpoint budget).  Order:
    [partition, topic, old_leader, new_leader, old_replicas,
    new_replicas, disk_moves, goals]."""
    return [
        p.partition, p.topic, p.old_leader, p.new_leader,
        list(p.old_replicas), list(p.new_replicas),
        [list(m) for m in p.disk_moves], list(p.goals),
    ]


def proposal_from_record(row) -> ExecutionProposal:
    return ExecutionProposal(
        partition=int(row[0]),
        topic=int(row[1]),
        old_leader=int(row[2]),
        new_leader=int(row[3]),
        old_replicas=tuple(row[4]),
        new_replicas=tuple(row[5]),
        disk_moves=tuple(tuple(m) for m in row[6]),
        goals=tuple(row[7]),
    )


def _per_task_fields(payload: dict):
    """(task_id, fields) pairs from a ``task`` record — either a single
    ``taskId`` or an aggregated ``taskIds`` list (the per-tick COMPLETED
    group record; one record per tick instead of one per move)."""
    tids = payload.get("taskIds")
    if tids is not None:
        fields = {k: v for k, v in payload.items() if k != "taskIds"}
        return [(int(t), {"taskId": int(t), **fields}) for t in tids]
    tid = payload.get("taskId")
    if tid is None:
        return []
    return [(int(tid), payload)]


@dataclasses.dataclass
class ExecutionCheckpoint:
    """One recoverable execution, rebuilt from the journal file."""

    execution_id: int
    strategy: str
    max_ticks: int
    proposals: List[ExecutionProposal]
    #: external partition id → size (the strategy-ordering input)
    sizes: Dict[int, float]
    #: executor config snapshot in force when the execution started
    config: Dict[str, Any]
    #: task_id → last recorded state payload (state/attempts/newReplicas)
    tasks: Dict[int, dict]
    phase: str
    last_tick: int
    #: True when a previous recovery already adopted this checkpoint
    resumed_before: bool = False
    #: controller epoch of the last record — the fencing token the
    #: checkpoint's owner held.  Recovery claims epoch+1 conditionally on
    #: this value (CAS), so two racing recoveries serialize and a zombie
    #: resume of an already-taken-over checkpoint is refused.
    epoch: int = 0
    #: last recorded throttle state ({"state": "set"/"cleared", "rate"}) —
    #: resume adopts (and eventually clears) the dead run's orphaned
    #: throttle configs from it
    throttle: Optional[Dict[str, Any]] = None


class ExecutionJournal:
    """Append-only, crash-safe JSONL checkpoint for one execution."""

    def __init__(self, path: str, max_bytes: int = _DEFAULT_MAX_BYTES):
        self.path = path
        self.max_bytes = max(1024, int(max_bytes))
        self._lock = InstrumentedLock("journal.execution")
        self._fh = None
        self._seq = 0
        self._bytes = 0
        #: frozen == the owning process "died": appends become no-ops
        self._frozen = False
        #: controller epoch stamped on every record (execution fencing);
        #: the executor sets it when it claims ownership
        self._epoch = 0
        #: test/sim hook: successful appends remaining before ProcessCrash
        self._crash_after: Optional[int] = None
        #: group-commit buffer of serialized-but-unflushed records
        self._pending: List[str] = []
        #: lifetime high-water mark of the on-disk checkpoint (bytes) —
        #: compaction/truncation shrink the file mid-execution, so a
        #: retention gate needs the peak, not the (usually empty) endpoint
        self.high_water_bytes = 0
        #: compaction model: latest start payload + per-task latest states
        self._start: Optional[dict] = None
        self._tasks: Dict[int, dict] = {}
        self._phase: Optional[dict] = None
        self._throttle: Optional[dict] = None

    # ---- crash injection --------------------------------------------------------
    def crash_after(self, n: int) -> None:
        """Arm a simulated death: the next ``n`` appends persist, then the
        following append freezes the journal and raises ProcessCrash —
        the record at the crash boundary never reaches disk."""
        with self._lock:
            self._crash_after = max(0, int(n))

    @property
    def frozen(self) -> bool:
        return self._frozen

    def thaw(self) -> None:
        """Un-freeze (the 'restarted process' reopening its checkpoint)."""
        with self._lock:
            self._frozen = False
            self._crash_after = None

    def set_epoch(self, epoch: int) -> None:
        """Stamp subsequent records with the owner's controller epoch."""
        with self._lock:
            self._epoch = int(epoch)

    # ---- emission ---------------------------------------------------------------
    def append(self, kind: str, **payload: Any) -> None:
        """Persist one record; flushed before returning.  IO failures are
        logged, never raised (a checkpoint hiccup must not fail the
        execution it protects); ProcessCrash (armed via crash_after) is
        the single deliberate exception."""
        with self._lock:
            if self._frozen:
                return
            if self._crash_after is not None:
                if self._crash_after <= 0:
                    self._frozen = True
                    self._crash_after = None
                    # a real crash loses the unflushed buffer too — the
                    # harness must exercise exactly that loss
                    self._pending.clear()
                    raise ProcessCrash(
                        f"simulated crash at checkpoint write {self._seq + 1}"
                        f" ({kind})"
                    )
                self._crash_after -= 1
            self._seq += 1
            rec = {
                "schema": SCHEMA,
                "seq": self._seq,
                "kind": kind,
                "epoch": self._epoch,
                "ts": round(time.time(), 3),
                "payload": payload,
            }
            self._track(kind, payload)
            # compact separators: the start record positionally encodes
            # the WHOLE plan, so whitespace is ~10% of the checkpoint's
            # bytes and encode time on the write-ahead hot path.  The
            # CRC frame makes a bit-flipped-but-still-JSON record
            # detectable at load time.
            self._pending.append(stamp_line(
                json.dumps(rec, default=str, separators=(",", ":"))
            ))
            try:
                if kind in _FLUSH_KINDS or len(self._pending) >= _MAX_BUFFERED:
                    self._flush_locked()  # cclint: disable=blocking-under-lock -- journal.execution IS the file serializer: write-ahead semantics require the flush to land before append returns, under the same lock that orders the records
                if kind == "end":
                    # terminal: atomically truncate — a completed
                    # execution needs no recovery state
                    self._truncate()
            except OSError:
                LOG.exception("execution checkpoint write failed (%s)", kind)
                self._pending.clear()
                self._close()

    def _flush_locked(self) -> None:
        for line in self._pending:
            self._write_line(line)
        self._pending.clear()
        if self._bytes > self.max_bytes:
            self._compact()

    def _track(self, kind: str, payload: dict) -> None:
        if kind == "start":
            self._start = payload
            self._tasks = {}
            self._phase = None
            self._throttle = None
        elif kind == "task":
            for tid, fields in _per_task_fields(payload):
                merged = dict(self._tasks.get(tid, {}))
                merged.update(fields)
                self._tasks[tid] = merged
        elif kind == "phase":
            self._phase = payload
        elif kind == "throttle":
            self._throttle = payload
        elif kind == "end":
            self._start = None
            self._tasks = {}
            self._phase = None
            self._throttle = None

    def _write_line(self, line: str) -> None:
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
            self._bytes = self._fh.tell()
        data = line + "\n"
        self._fh.write(data)
        self._fh.flush()
        self._bytes += len(data)
        if self._bytes > self.high_water_bytes:
            self.high_water_bytes = self._bytes

    def _snapshot_records(self) -> List[dict]:
        """The compacted equivalent of the current file contents."""
        if self._start is None:
            return []
        out = [{"schema": SCHEMA, "seq": 1, "kind": "start",
                "epoch": self._epoch, "ts": round(time.time(), 3),
                "payload": self._start}]
        seq = 1
        for extra, kind in ((self._phase, "phase"),
                            (self._throttle, "throttle")):
            if extra is not None:
                seq += 1
                out.append({"schema": SCHEMA, "seq": seq, "kind": kind,
                            "epoch": self._epoch,
                            "ts": round(time.time(), 3), "payload": extra})
        for tid in sorted(self._tasks):
            seq += 1
            out.append({"schema": SCHEMA, "seq": seq, "kind": "task",
                        "epoch": self._epoch, "ts": round(time.time(), 3),
                        "payload": self._tasks[tid]})
        return out

    def _replace_file(self, records: List[dict]) -> None:
        """Atomically swap the checkpoint for ``records`` (may be empty)."""
        self._close()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for rec in records:
                f.write(stamp_line(
                    json.dumps(rec, default=str, separators=(",", ":"))
                ) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._seq = len(records)
        self._bytes = os.path.getsize(self.path)

    def _compact(self) -> None:
        self._replace_file(self._snapshot_records())

    def _truncate(self) -> None:
        """Empty the checkpoint in place.  Unlike :meth:`_compact`,
        truncation has no content whose torn write could corrupt
        recovery — and a crash that loses the truncate entirely just
        leaves the completed execution's end-terminated log, which
        ``load()`` already answers None for.  So no tmp + fsync +
        os.replace here: the atomic dance costs ~1 ms per execution
        (an fsync plus two metadata ops), measurable against the <=1%
        checkpoint budget."""
        self._close()
        with open(self.path, "w"):
            pass
        self._seq = 0
        self._bytes = 0

    def _close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:  # pragma: no cover - defensive
                pass
            self._fh = None
        self._bytes = 0

    def close(self) -> None:
        with self._lock:
            try:
                self._flush_locked()  # cclint: disable=blocking-under-lock -- close() drains the buffer exactly once; the lock serializes against a concurrent append, and there is no after-the-lock to defer to
            except OSError:  # pragma: no cover - defensive
                LOG.exception("execution checkpoint flush on close failed")
                self._pending.clear()
            self._close()

    # ---- recovery ---------------------------------------------------------------
    def load(self) -> Optional[ExecutionCheckpoint]:
        """The in-flight execution this checkpoint describes, or None
        (no file, empty file, or the last execution wrote its ``end``).

        Bad-line policy: silent skip is reserved for the FILE TAIL —
        exactly one undecodable/CRC-mismatched final line, the signature
        of a real crash mid-write (appends flush in order, so everything
        before it is intact).  Any earlier bad line is mid-file
        corruption: it is journaled loudly (``executor.checkpoint_corrupt``)
        and every record from the corruption onward is discarded — the
        checkpoint is absent after the last good record, and
        reconciliation re-derives the rest from live cluster state."""
        try:
            # binary read: bit rot may leave bytes that are not UTF-8 —
            # such a line must classify as torn/corrupt, not crash load()
            with open(self.path, "rb") as f:
                lines = f.read().splitlines()
        except OSError:
            return None
        records, bad, n_lines = scan_lines(lines)
        if bad:
            if bad == [n_lines - 1]:
                # the torn final line of a real crash: tolerated, as ever
                LOG.warning("checkpoint %s: dropping torn final record",
                            self.path)
            else:
                from cruise_control_tpu_torch.telemetry import events

                first_bad = bad[0]
                dropped = n_lines - first_bad
                LOG.error(
                    "checkpoint %s: mid-file corruption at record %d — "
                    "discarding it and the %d record(s) after it; "
                    "recovery will reconcile from live cluster state",
                    self.path, first_bad, dropped,
                )
                events.emit(
                    "executor.checkpoint_corrupt", severity="ERROR",
                    line=first_bad, dropped=dropped,
                )
                # every good record before the corruption is trusted;
                # the suffix is not (its ordering can't be proven)
                records = records[:first_bad]
        start_idx = None
        for i, rec in enumerate(records):
            if rec.get("kind") == "start":
                start_idx = i
        if start_idx is None:
            return None
        tail = records[start_idx:]
        if any(rec.get("kind") == "end" for rec in tail):
            return None
        start = tail[0].get("payload", {})
        tasks: Dict[int, dict] = {}
        phase = "replica_moves"
        last_tick = 0
        resumed_before = False
        throttle: Optional[dict] = None
        epoch = 0
        for rec in tail:
            try:
                epoch = max(epoch, int(rec.get("epoch", 0)))
            except (TypeError, ValueError):
                pass
        for rec in tail[1:]:
            payload = rec.get("payload", {})
            kind = rec.get("kind")
            if kind == "task":
                for tid, fields in _per_task_fields(payload):
                    merged = dict(tasks.get(tid, {}))
                    merged.update(fields)
                    tasks[tid] = merged
            elif kind == "batch":
                # write-ahead watermark: the listed tasks were dispatched
                # (or were about to be — reconciliation treats both alike)
                for tid in payload.get("taskIds", ()):
                    merged = dict(tasks.get(int(tid), {}))
                    merged.setdefault("state", "IN_PROGRESS")
                    merged["state"] = merged.get("state", "IN_PROGRESS")
                    tasks[int(tid)] = merged
                last_tick = max(last_tick, int(payload.get("tick", 0)))
            elif kind == "phase":
                phase = payload.get("phase", phase)
            elif kind == "throttle":
                throttle = dict(payload)
            elif kind == "resume":
                resumed_before = True
            if "tick" in payload:
                try:
                    last_tick = max(last_tick, int(payload["tick"]))
                except (TypeError, ValueError):
                    pass
        return ExecutionCheckpoint(
            execution_id=int(start.get("executionId", 0)),
            strategy=str(start.get("strategy", "")),
            max_ticks=int(start.get("maxTicks", 10_000)),
            proposals=[proposal_from_record(row)
                       for row in start.get("proposals", ())],
            sizes={int(k): float(v)
                   for k, v in (start.get("sizes") or {}).items()},
            config=dict(start.get("config") or {}),
            tasks=tasks,
            phase=phase,
            last_tick=last_tick,
            resumed_before=resumed_before,
            epoch=epoch,
            throttle=throttle,
        )

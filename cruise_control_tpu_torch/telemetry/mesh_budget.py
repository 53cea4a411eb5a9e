"""Mesh observatory — collective & transfer accounting, dispatch-gap
attribution, and a replication audit (``cc-tpu-mesh-budget/1``).

The port's counterpart of the reference's ``telemetry/mesh_budget.py``,
with its public names, journal records and artifact schema.  It rides the
kernel observatory's ONE capture pipeline
(:data:`~cruise_control_tpu_torch.telemetry.kernel_budget.CAPTURE` arm →
trace → parse) as a registered capture observer, so no second profiler
session exists:

* **Transfers**: Kineto's ``cat: "gpu_memcpy"`` records with their
  ``args.bytes``, ``Memcpy HtoD`` as H2D and ``Memcpy DtoH`` as D2H; a
  device-to-device copy and a memset (``cat: "gpu_memset"``) are work on
  the card, busy time.  Beside the trace, an instrumented byte counter
  per logical fn: the sanctioned transfer entry points :func:`device_put`
  / :func:`fetch` (the engine's carry reads, packed prefix fetch and
  round fetch, the what-if verdict reads), so ``cc_transfer_bytes
  {direction=,fn=}`` says which code path pays.
* **Dispatch-gap attribution**: per card, a priority sweep (collective >
  transfer > busy) over the capture window assigns every elementary time
  slice to exactly ONE term, so ``busy + collective + transfer + host_gap
  == wall`` EXACTLY.  The window spans the first to the last record on
  the card; its gaps are the host's: reading the carry, dispatching the
  next chunk.  On the CPU dialect each host thread that ran ops is a
  lane whose ops are busy.
* **Collectives**: NCCL's kernels classify under the closed
  :data:`~cruise_control_tpu_torch.telemetry.kernel_budget.
  COLLECTIVE_OPS`; one card runs none, so the table is empty until a
  multi-card search exists (ROADMAP A11).
* **Replication audit** (:func:`audit_replication`): on one card every
  live CUDA tensor is single-device; the audit counts their bytes (each
  storage once), bounded by ``telemetry.mesh.audit.max.arrays``.

Served on ``GET /profile/mesh`` with the same 202-arm / poll ladder as
``/profile/kernels``.  Journal: ``profiler.mesh.parsed`` (deterministic
payload) and ``profiler.mesh.audit`` (explicit audits only).  Disarmed
cost is one attribute check per routed transfer.
"""

from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.telemetry import kernel_budget
from cruise_control_tpu_torch.telemetry.kernel_budget import (
    classify_collective,
    merge_intervals,
)
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("mesh_budget")

SCHEMA = "cc-tpu-mesh-budget/1"

#: the closed wall-decomposition vocabulary — terms partition the window
WALL_TERMS = ("busy", "collective", "transfer", "host_gap")

_H2D_MARKS = ("memcpyh2d", "transfertodevice", "bufferfromhostbuffer",
              "copytodevice", "infeed")
_D2H_MARKS = ("memcpyd2h", "transferfromdevice", "copyrawtohost",
              "toliteral", "outfeed")


def classify_transfer(name: str) -> Optional[str]:
    """Map a trace event name to a transfer direction (``"h2d"`` /
    ``"d2h"``) or None.  Covers both runtimes' host-transfer event
    vocabularies; device-side ``copy`` HLOs are intra-device moves, not
    host transfers, and do not classify."""
    n = name.lower()
    for mark in _H2D_MARKS:
        if mark in n:
            return "h2d"
    for mark in _D2H_MARKS:
        if mark in n:
            return "d2h"
    return None


#: Kineto's memcpy records by direction (``Memcpy HtoD (Pageable ->
#: Device)``, ``Memcpy DtoH (Device -> Pinned)``)
_KINETO_COPIES = (("memcpy htod", "h2d"), ("memcpy dtoh", "d2h"))

#: NCCL's kernel names (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``) by
#: collective op
_NCCL_OPS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
             ("reducescatter", "reduce-scatter"),
             ("sendrecv", "collective-permute"), ("alltoall", "all-to-all"))


def kineto_transfer(name: str) -> Optional[str]:
    """A Kineto ``gpu_memcpy`` record's direction, or None (device to
    device)."""
    n = name.lower()
    for mark, direction in _KINETO_COPIES:
        if n.startswith(mark):
            return direction
    return None


def kineto_collective(name: str) -> Optional[str]:
    """The collective op of a card's kernel: NCCL's by name, else the
    reference's HLO vocabulary (:func:`classify_collective`)."""
    n = name.lower()
    if n.startswith("nccl") or "nccldevkernel" in n:
        flat = n.replace("_", "")
        for mark, op in _NCCL_OPS:
            if mark in flat:
                return op
    return classify_collective(name.split("(", 1)[0])


def _event_bytes(args: dict) -> int:
    for key in ("raw_bytes_accessed", "bytes_accessed",
                "bytes_transferred", "bytes", "size"):
        v = args.get(key)
        if v is not None:
            try:
                return int(v)
            except (TypeError, ValueError):
                continue
    return 0


# ---- parsing ---------------------------------------------------------------------
@dataclass
class DeviceSplit:
    """One device's exact wall partition over the capture window."""

    wall_us: float = 0.0
    busy_us: float = 0.0
    collective_us: float = 0.0
    transfer_us: float = 0.0
    gap_us: float = 0.0


@dataclass
class MeshParse:
    """Parser output: the mesh-level decomposition of one capture."""

    dialect: str                        # "device" | "host-thunk"
    window_us: float = 0.0
    #: op → {"count", "time_us", "bytes"} (closed COLLECTIVE_OPS keys)
    collectives: Dict[str, dict] = field(default_factory=dict)
    #: direction → {"count", "time_us", "bytes"} (trace-derived copies)
    transfers: Dict[str, dict] = field(default_factory=dict)
    devices: Dict[str, DeviceSplit] = field(default_factory=dict)
    skew_source: str = "busy"

    def skew(self) -> Optional[float]:
        vals = [d.busy_us for d in self.devices.values() if d.busy_us > 0]
        if not vals:
            return None
        mean = sum(vals) / len(vals)
        return (max(vals) / mean) if mean > 0 else None


_PRIO = {"collective": 0, "transfer": 1, "busy": 2}


def _sweep(window: Tuple[float, float],
           classed: List[Tuple[float, float, str]]) -> DeviceSplit:
    """Priority sweep-line: assign every elementary slice of ``window``
    to exactly one class (collective > transfer > busy; uncovered time is
    the gap), so the returned terms partition the window EXACTLY —
    overlapping async kernels are counted once, never double."""
    w0, w1 = window
    span = max(0.0, w1 - w0)
    deltas: Dict[float, List[int]] = {}
    for s, e, cls in classed:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        i = _PRIO[cls]
        deltas.setdefault(s, [0, 0, 0])[i] += 1
        deltas.setdefault(e, [0, 0, 0])[i] -= 1
    acc = [0.0, 0.0, 0.0]
    active = [0, 0, 0]
    prev: Optional[float] = None
    for t in sorted(deltas):
        if prev is not None and t > prev:
            seg = t - prev
            for i in range(3):
                if active[i] > 0:
                    acc[i] += seg
                    break
        d = deltas[t]
        for i in range(3):
            active[i] += d[i]
        prev = t
    occupied = acc[0] + acc[1] + acc[2]
    return DeviceSplit(
        wall_us=span, busy_us=acc[2], collective_us=acc[0],
        transfer_us=acc[1], gap_us=max(0.0, span - occupied),
    )


def _tally(table: Dict[str, dict], key: str, dur: float, nbytes: int,
           ) -> None:
    row = table.setdefault(key, {"count": 0, "time_us": 0.0, "bytes": 0})
    row["count"] += 1
    row["time_us"] += dur
    row["bytes"] += nbytes


def _ival(e: dict) -> Tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def _window(ivals: List[Tuple[float, float]]) -> Tuple[float, float]:
    if not ivals:
        return (0.0, 0.0)
    return (min(s for s, _ in ivals), max(e for _, e in ivals))


def parse_mesh_trace(trace_path: str) -> MeshParse:
    """Parse one Kineto Chrome trace into the mesh decomposition,
    detecting the dialect exactly like
    :func:`~cruise_control_tpu_torch.telemetry.kernel_budget.parse_trace`:
    the card's records (kernels, copies, memsets) or the CPU's host ops."""
    events = kernel_budget._load_events(trace_path)
    kernels = kernel_budget._xevents(events, "kernel")
    copies = (kernel_budget._xevents(events, "gpu_memcpy")
              + kernel_budget._xevents(events, "gpu_memset"))
    if kernels:
        return _parse_device_mesh(kernels, copies)
    return _parse_host_mesh(kernel_budget._xevents(events, "cpu_op"))


def _parse_device_mesh(kernels: List[dict], copies: List[dict],
                       ) -> MeshParse:
    parsed = MeshParse(dialect="device")
    ivals: Dict[str, List[Tuple[float, float, str]]] = {}
    all_spans: List[Tuple[float, float]] = []
    for e in kernels:
        ts, end = _ival(e)
        all_spans.append((ts, end))
        op = kineto_collective(str(e.get("name", "")))
        if op is not None:
            cls = "collective"
            _tally(parsed.collectives, op, end - ts,
                   _event_bytes(e.get("args", {})))
        else:
            cls = "busy"
        ivals.setdefault(kernel_budget.device_label(e), []).append(
            (ts, end, cls))
    for e in copies:
        ts, end = _ival(e)
        all_spans.append((ts, end))
        direction = (kineto_transfer(str(e.get("name", "")))
                     if e.get("cat") == "gpu_memcpy" else None)
        if direction is not None:
            _tally(parsed.transfers, direction, end - ts,
                   _event_bytes(e.get("args", {})))
        ivals.setdefault(kernel_budget.device_label(e), []).append(
            (ts, end, "transfer" if direction else "busy"))
    window = _window(all_spans)
    parsed.window_us = max(0.0, window[1] - window[0])
    for label, classed in ivals.items():
        parsed.devices[label] = _sweep(window, classed)
    parsed.skew_source = "busy"
    return parsed


def _parse_host_mesh(ops: List[dict]) -> MeshParse:
    parsed = MeshParse(dialect="host-thunk")
    lanes: Dict[Any, List[Tuple[float, float]]] = {}
    for e in ops:
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(_ival(e))
    window = _window([iv for ivs in lanes.values() for iv in ivs])
    parsed.window_us = max(0.0, window[1] - window[0])
    order = {k: i for i, k in enumerate(sorted(lanes, key=str))}
    for key, ivs in lanes.items():
        parsed.devices[f"cpu-lane-{order[key]}"] = _sweep(
            window, [(s, e, "busy") for s, e in merge_intervals(ivs)])
    parsed.skew_source = "busy"
    return parsed


# ---- the transfer ledger ---------------------------------------------------------
def _tree_nbytes(x: Any) -> int:
    n = getattr(x, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(x, dict):
        return sum(_tree_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tree_nbytes(v) for v in x)
    try:
        return int(np.asarray(x).nbytes)
    except Exception:
        return 0


class TransferLedger:
    """Byte/time counters per (direction, logical fn) for every transfer
    routed through the sanctioned entry points.  The trace sees copies as
    anonymous records; the ledger names them, so ``cc_transfer_bytes
    {direction=,fn=}`` can say WHICH code path pays.  Disabled cost: one
    attribute read per call."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        #: fn → {"h2d_count", "h2d_bytes", "h2d_us", "d2h_count", ...}
        self._by_fn: Dict[str, Dict[str, float]] = {}

    def note(self, direction: str, fn: str, nbytes: int,
             dur_s: float = 0.0) -> None:
        """Record one transfer (``direction`` is ``"h2d"``/``"d2h"``).
        The generic seam for sites that perform the copy themselves
        (e.g. the constraint upload's ``torch.as_tensor`` batch)."""
        if not self.enabled:
            return
        with self._lock:
            row = self._by_fn.setdefault(fn, {
                "h2d_count": 0, "h2d_bytes": 0, "h2d_us": 0.0,
                "d2h_count": 0, "d2h_bytes": 0, "d2h_us": 0.0,
            })
            row[f"{direction}_count"] += 1
            row[f"{direction}_bytes"] += int(nbytes)
            row[f"{direction}_us"] += dur_s * 1e6

    def device_put(self, x: Any, device: Any = None, *,
                   fn: str = "unlabeled") -> Any:
        """The instrumented upload (``torch.as_tensor(x, device=)``)."""
        import torch

        t0 = time.perf_counter()
        out = torch.as_tensor(x, device=device)
        if self.enabled:
            self.note("h2d", fn, _tree_nbytes(x),
                      time.perf_counter() - t0)
        return out

    def fetch(self, x: Any, *, fn: str = "unlabeled") -> np.ndarray:
        """The instrumented D2H read (a tensor to a numpy array on the
        host) — the drive loop's reads route through here so the ledger
        charges them to a named fn."""
        if not self.enabled:
            return x.detach().cpu().numpy()
        t0 = time.perf_counter()
        out = x.detach().cpu().numpy()
        self.note("d2h", fn, int(out.nbytes), time.perf_counter() - t0)
        return out

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {fn: dict(row) for fn, row in self._by_fn.items()}

    @staticmethod
    def delta(now: Dict[str, Dict[str, float]],
              baseline: Optional[Dict[str, Dict[str, float]]],
              ) -> Dict[str, Dict[str, float]]:
        """``now - baseline`` per fn/field (fns absent from the window
        drop out) — the per-capture ledger window."""
        if not baseline:
            return now
        out: Dict[str, Dict[str, float]] = {}
        for fn, row in now.items():
            base = baseline.get(fn, {})
            d = {k: v - base.get(k, 0) for k, v in row.items()}
            if any(d[k] for k in ("h2d_count", "d2h_count")):
                out[fn] = d
        return out

    def reset(self) -> None:
        with self._lock:
            self._by_fn = {}


# ---- the replication audit -------------------------------------------------------
def audit_replication(max_arrays: int = 4096,
                      device_type: str = "cuda") -> dict:
    """Walk the live tensors on ``device_type``: on one card every one is
    single-device, so ``single_device_bytes`` (each storage once) is what
    the process holds there and nothing is replicated or sharded yet
    (ROADMAP A11).  At most ``max_arrays`` tensors are counted
    (``truncated`` says when more were live)."""
    import torch

    tensors = [o for o in gc.get_objects()
               if issubclass(type(o), torch.Tensor)
               and o.device.type == device_type]
    out = {
        "arrays": 0, "skipped": 0,
        "truncated": len(tensors) > max_arrays,
        "devices": (max(1, torch.cuda.device_count()) if device_type
                    == "cuda" else 1),
        "logical_bytes": 0, "stored_bytes": 0,
        "replicated_bytes": 0, "sharded_bytes": 0,
        "single_device_bytes": 0,
    }
    seen = set()
    for t in tensors[:max_arrays]:
        try:
            nbytes = t.numel() * t.element_size()
            storage = t.untyped_storage()
            key = (storage.data_ptr(), storage.nbytes())
        except (RuntimeError, ValueError, AttributeError):
            out["skipped"] += 1
            continue
        out["arrays"] += 1
        out["logical_bytes"] += int(nbytes)
        if key not in seen:
            seen.add(key)
            out["stored_bytes"] += int(key[1])
    out["single_device_bytes"] = out["stored_bytes"]
    return out


# ---- artifact --------------------------------------------------------------------
def build_mesh_artifact(
    parsed: MeshParse,
    units: int,
    unit: str = "scan-call",
    source: str = "live-capture",
    backend: Optional[str] = None,
    capture: Optional[dict] = None,
    fixture: Optional[dict] = None,
    ledger: Optional[Dict[str, Dict[str, float]]] = None,
    replication: Optional[dict] = None,
    now: Optional[float] = None,
) -> dict:
    """Assemble the ``cc-tpu-mesh-budget/1`` artifact.  The ``wall``
    block is the per-device MEAN of each term; by the sweep's
    construction ``busy + collective + transfer + host_gap == wall``
    exactly (``reconciliation_pct`` is the proof the gate test pins)."""
    units = max(1, int(units))
    if backend is None:
        backend = "cuda" if parsed.dialect == "device" else "cpu"
    devs = parsed.devices
    n = max(1, len(devs))

    def mean(attr: str) -> float:
        return sum(getattr(d, attr) for d in devs.values()) / n

    wall_us = mean("wall_us")
    terms_us = {
        "busy": mean("busy_us"),
        "collective": mean("collective_us"),
        "transfer": mean("transfer_us"),
        "host_gap": mean("gap_us"),
    }
    skew = parsed.skew()
    col_total_us = sum(v["time_us"] for v in parsed.collectives.values())
    art = {
        "schema": SCHEMA,
        "generated_unix": round(time.time() if now is None else now, 3),
        "backend": backend,
        "dialect": parsed.dialect,
        "source": source,
        "unit": unit,
        "units": units,
        "collectives": {
            "time_ms": round(col_total_us / 1e3, 4),
            "bytes": int(sum(v["bytes"]
                             for v in parsed.collectives.values())),
            "by_op": {
                op: {
                    "count": int(v["count"]),
                    "count_per_unit": round(v["count"] / units, 2),
                    "time_ms": round(v["time_us"] / 1e3, 4),
                    "bytes": int(v["bytes"]),
                }
                for op, v in sorted(parsed.collectives.items())
            },
        },
        "transfers": {
            "trace": {
                d: {
                    "count": int(v["count"]),
                    "count_per_unit": round(v["count"] / units, 2),
                    "time_ms": round(v["time_us"] / 1e3, 4),
                    "bytes": int(v["bytes"]),
                }
                for d, v in sorted(parsed.transfers.items())
            },
            "ledger": {
                "enabled": ledger is not None,
                "by_fn": {
                    fn: {
                        "h2d_count": int(row.get("h2d_count", 0)),
                        "h2d_bytes": int(row.get("h2d_bytes", 0)),
                        "h2d_ms": round(row.get("h2d_us", 0.0) / 1e3, 4),
                        "d2h_count": int(row.get("d2h_count", 0)),
                        "d2h_bytes": int(row.get("d2h_bytes", 0)),
                        "d2h_ms": round(row.get("d2h_us", 0.0) / 1e3, 4),
                    }
                    for fn, row in sorted((ledger or {}).items())
                },
            },
        },
        "devices": {
            "count": len(devs),
            "skew": round(skew, 4) if skew is not None else None,
            "skew_source": parsed.skew_source,
            "per_device": {
                label: {
                    "wall_ms": round(d.wall_us / 1e3, 4),
                    "busy_ms": round(d.busy_us / 1e3, 4),
                    "collective_ms": round(d.collective_us / 1e3, 4),
                    "transfer_ms": round(d.transfer_us / 1e3, 4),
                    "gap_ms": round(d.gap_us / 1e3, 4),
                }
                for label, d in sorted(devs.items())
            },
        },
        "wall": {
            "window_ms": round(wall_us / 1e3, 4),
            "busy_ms": round(terms_us["busy"] / 1e3, 4),
            "collective_ms": round(terms_us["collective"] / 1e3, 4),
            "transfer_ms": round(terms_us["transfer"] / 1e3, 4),
            "host_gap_ms": round(terms_us["host_gap"] / 1e3, 4),
            "reconciliation_pct": round(
                100.0 * sum(terms_us.values()) / wall_us
                if wall_us > 0 else 100.0, 4),
        },
    }
    if replication is not None:
        art["replication"] = replication
    if capture is not None:
        art["capture"] = capture
    if fixture is not None:
        art["fixture"] = fixture
    return art


# ---- budget regression gate ------------------------------------------------------
def compare_mesh_budget(artifact: dict, budget: dict) -> List[str]:
    """Gate a measured mesh artifact against the pinned per-term budget.
    Counts only — timings are host-noisy; counts are deterministic for a
    fixed program:

    * collective ops: per-op ``count_per_unit`` ceilings, and any op NOT
      in the budget appearing at all is a regression;
    * trace transfers: per-direction ``count_per_unit`` ceilings;
    * ledger fns: the fn vocabulary is closed, with per-fn d2h/h2d count
      ceilings (a new un-budgeted transfer site fails the gate).

    Shrinkage is an improvement, never a violation."""
    tol = 1.0 + float(budget.get("tolerance_pct", 25)) / 100.0
    out: List[str] = []
    pinned_fixture = budget.get("fixture") or {}
    fixture = artifact.get("fixture") or {}
    for key in sorted(set(pinned_fixture) & set(fixture)):
        if pinned_fixture[key] != fixture[key]:
            out.append(
                f"fixture mismatch on {key!r}: measured "
                f"{fixture[key]!r} vs budget {pinned_fixture[key]!r} — "
                "mesh counts only compare at identical shapes"
            )
    if out:
        return out
    pinned_ops = budget.get("collective_ops", {})
    by_op = artifact.get("collectives", {}).get("by_op", {})
    for op, v in sorted(by_op.items()):
        got = float(v.get("count_per_unit", 0.0))
        if op not in pinned_ops:
            if got > 0:
                out.append(
                    f"unexpected collective op {op!r}: {got:g}/"
                    f"{artifact['unit']} (not in the pinned budget)"
                )
            continue
        ceiling = float(pinned_ops[op]) * tol
        if got > ceiling:
            out.append(
                f"collective {op!r} grew to {got:g}/{artifact['unit']} "
                f"(budget {pinned_ops[op]:g}, ceiling {ceiling:g})"
            )
    pinned_xfer = budget.get("transfer_trace", {})
    trace = artifact.get("transfers", {}).get("trace", {})
    for direction, v in sorted(trace.items()):
        got = float(v.get("count_per_unit", 0.0))
        ceiling = float(pinned_xfer.get(direction, 0.0)) * tol
        if got > ceiling:
            out.append(
                f"trace {direction} transfers grew to {got:g}/"
                f"{artifact['unit']} (ceiling {ceiling:g})"
            )
    pinned_fns = budget.get("ledger_fns", {})
    by_fn = artifact.get("transfers", {}).get("ledger", {}) \
        .get("by_fn", {})
    for fn, row in sorted(by_fn.items()):
        if fn not in pinned_fns:
            out.append(
                f"unexpected ledger fn {fn!r} "
                "(new transfer site — regen tests/budgets/"
                "mesh_budget.json if intended)"
            )
            continue
        for direction in ("h2d", "d2h"):
            got = float(row.get(f"{direction}_count", 0)) \
                / max(1, int(artifact.get("units", 1)))
            ceiling = float(
                pinned_fns[fn].get(f"{direction}_count_per_unit", 0.0)
            ) * tol
            if got > ceiling:
                out.append(
                    f"ledger fn {fn!r} {direction} grew to {got:g}/"
                    f"{artifact['unit']} (ceiling {ceiling:g})"
                )
    return out


# ---- the observatory (a CaptureManager observer) ---------------------------------
class MeshObservatory:
    """Mesh-level consumer of the kernel observatory's capture pipeline.

    Registered as a :class:`~cruise_control_tpu_torch.telemetry.
    kernel_budget.CaptureManager` observer (:meth:`attach`): one armed
    capture feeds BOTH artifacts.  Hooks: trace start snapshots the
    transfer-ledger baseline (the artifact windows the ledger), trace
    finish runs the replication audit while the search's tensors are
    alive, and the off-thread parse builds ``cc-tpu-mesh-budget/1``."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.ledger = TransferLedger()
        self.audit_max_arrays = 4096
        self._lock = threading.Lock()
        self._latest: Optional[dict] = None
        self._ledger_baseline: Optional[dict] = None
        self._ledger_end: Optional[dict] = None
        self._last_audit: Optional[dict] = None
        self._latest_parsed: Optional[MeshParse] = None
        self.parses = 0
        self.parse_failures = 0
        #: seconds of the latest audit (the live-tensor walk)
        self.last_audit_s: Optional[float] = None

    # ---- configuration ----------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  ledger_enabled: Optional[bool] = None,
                  audit_max_arrays: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if audit_max_arrays is not None:
                self.audit_max_arrays = max(1, int(audit_max_arrays))
        if ledger_enabled is not None:
            self.ledger.enabled = bool(ledger_enabled)

    def attach(self, capture: Optional[Any] = None) -> None:
        """Register on the capture pipeline (idempotent)."""
        (capture or kernel_budget.CAPTURE).add_observer(self)

    def reset(self) -> None:
        """Drop parsed state + ledger (tests).  Attachment survives —
        registration is structural, like the capture manager's own."""
        with self._lock:
            self._latest = None
            self._ledger_baseline = None
            self._ledger_end = None
            self._last_audit = None
            self._latest_parsed = None
            self.parses = 0
            self.parse_failures = 0
        self.ledger.reset()

    def _audit(self) -> dict:
        t0 = time.perf_counter()
        art = audit_replication(self.audit_max_arrays)
        dt = time.perf_counter() - t0
        with self._lock:
            self.last_audit_s = dt
        return art

    # ---- CaptureManager observer hooks ------------------------------------------
    def on_trace_start(self, meta: dict) -> None:
        if not self.enabled:
            return
        baseline = self.ledger.snapshot()
        with self._lock:
            self._ledger_baseline = baseline
            self._ledger_end = None

    def on_trace_finish(self, meta: dict) -> None:
        if not self.enabled:
            return
        # the ledger's window closes with the trace, not at the parse
        end = self.ledger.snapshot()
        with self._lock:
            self._ledger_end = end
        try:
            audit = self._audit()
        except Exception:  # the audit is best effort: the artifact goes without
            LOG.exception("mesh-budget replication audit failed")
            audit = None
        with self._lock:
            self._last_audit = audit

    def on_parse(self, trace_path: str, meta: dict) -> None:
        if not self.enabled:
            return
        from cruise_control_tpu_torch.telemetry import events

        try:
            parsed = parse_mesh_trace(trace_path)
            units = max(1, int(meta.get("scansTraced") or 0))
            with self._lock:
                baseline = self._ledger_baseline
                end = self._ledger_end
                audit = self._last_audit
            ledger = TransferLedger.delta(
                end if end is not None else self.ledger.snapshot(), baseline)
            artifact = build_mesh_artifact(
                parsed, units=units, unit="scan-call",
                source=("legacy-trace-dir"
                        if meta.get("reason") == "profiler_trace_dir"
                        else "live-capture"),
                capture=dict(meta), ledger=ledger, replication=audit,
            )
            with self._lock:
                self._latest = artifact
                self._latest_parsed = parsed
                self.parses += 1
        except Exception:
            with self._lock:
                self.parse_failures += 1
            LOG.exception("mesh-budget trace parse failed for capture %s",
                          meta.get("id"))
            return
        # deterministic payload ONLY (scenario fingerprints): the lane
        # count on the host dialect follows thread scheduling, so it stays
        # out of the journal — read it from the artifact
        events.emit(
            "profiler.mesh.parsed", captureId=meta.get("id"),
            dialect=parsed.dialect, units=units,
            collectiveOps=sorted(parsed.collectives),
        )

    # ---- operator surface --------------------------------------------------------
    def arm(self, scans: Optional[int] = None,
            reason: str = "mesh-api") -> dict:
        """Arm a capture through the shared pipeline (the kernel
        observatory parses the same trace)."""
        self.attach()
        kernel_budget.CAPTURE.arm(scans=scans, reason=reason)
        return self.state()

    def audit(self) -> dict:
        """Run the replication audit NOW (journaled — the explicit
        operator action, unlike the capture-finish hook)."""
        from cruise_control_tpu_torch.telemetry import events

        art = self._audit()
        with self._lock:
            self._last_audit = art
        events.emit(
            "profiler.mesh.audit", arrays=art["arrays"],
            replicatedBytes=art["replicated_bytes"],
            shardedBytes=art["sharded_bytes"],
            singleDeviceBytes=art["single_device_bytes"],
        )
        return art

    def state(self) -> dict:
        cap = kernel_budget.CAPTURE.state()
        with self._lock:
            return {
                "enabled": self.enabled,
                "ledgerEnabled": self.ledger.enabled,
                "capture": cap,
                "parses": self.parses,
                "parseFailures": self.parse_failures,
                "lastAuditS": self.last_audit_s,
            }

    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._latest

    def latest_parsed(self) -> Optional[MeshParse]:
        """The latest parse before the artifact's rounding."""
        with self._lock:
            return self._latest_parsed

    def summary(self) -> dict:
        """The ``/diagnostics`` merge block (``meshBudget``)."""
        out = self.state()
        with self._lock:
            out["latest"] = self._latest
            out["lastAudit"] = self._last_audit
        return out

    def families(self) -> List[tuple]:
        """``extra_families`` rows for the Prometheus exposition."""
        art = self.latest()
        with self._lock:
            audit = self._last_audit
        fams: List[tuple] = []
        if art is not None:
            by_op = art["collectives"]["by_op"]
            if by_op:
                fams.append((
                    "cc_collective_busy_ms", "gauge",
                    "Collective time in the latest mesh capture, by op",
                    [({"op": op}, float(v["time_ms"]))
                     for op, v in by_op.items()],
                ))
                fams.append((
                    "cc_collective_bytes", "gauge",
                    "Collective bytes in the latest mesh capture, by op",
                    [({"op": op}, float(v["bytes"]))
                     for op, v in by_op.items()],
                ))
            xfer_rows_b: List[tuple] = []
            xfer_rows_ms: List[tuple] = []
            for d, v in art["transfers"]["trace"].items():
                xfer_rows_b.append(
                    ({"direction": d, "fn": "trace"}, float(v["bytes"])))
                xfer_rows_ms.append(
                    ({"direction": d, "fn": "trace"}, float(v["time_ms"])))
            for fn, row in art["transfers"]["ledger"]["by_fn"].items():
                for d in ("h2d", "d2h"):
                    if row[f"{d}_count"]:
                        xfer_rows_b.append(({"direction": d, "fn": fn},
                                            float(row[f"{d}_bytes"])))
                        xfer_rows_ms.append(({"direction": d, "fn": fn},
                                             float(row[f"{d}_ms"])))
            if xfer_rows_b:
                fams.append((
                    "cc_transfer_bytes", "gauge",
                    "H2D/D2H bytes in the latest mesh capture window "
                    "(trace copies + the instrumented ledger, by fn)",
                    xfer_rows_b,
                ))
                fams.append((
                    "cc_transfer_ms", "gauge",
                    "H2D/D2H time in the latest mesh capture window",
                    xfer_rows_ms,
                ))
            wall = art["wall"]
            fams.append((
                "cc_mesh_host_gap_ms", "gauge",
                "Mean per-device host/dispatch gap in the latest mesh "
                "capture window",
                [({}, float(wall["host_gap_ms"]))],
            ))
        if audit is not None:
            fams.append((
                "cc_mesh_replicated_bytes", "gauge",
                "Bytes stored as extra replicated copies across the mesh "
                "(latest replication audit; 0 on one card)",
                [({}, float(audit["replicated_bytes"]))],
            ))
            fams.append((
                "cc_mesh_sharded_bytes", "gauge",
                "Bytes stored sharded (one logical copy split across "
                "devices; latest replication audit; 0 on one card)",
                [({}, float(audit["sharded_bytes"]))],
            ))
        return fams

    def install_gauges(self, registry) -> None:
        registry.gauge("mesh.capture.parses",
                       lambda: float(self.parses))
        registry.gauge("mesh.capture.parse.failures",
                       lambda: float(self.parse_failures))


#: process-wide default (bootstrap reconfigures it from the
#: telemetry.mesh.* keys and attaches it to the capture pipeline)
MESH = MeshObservatory()


# module-level conveniences bound to the default instance -------------------------
def configure(**kwargs) -> None:
    MESH.configure(**kwargs)


def arm(scans: Optional[int] = None, reason: str = "mesh-api") -> dict:
    return MESH.arm(scans=scans, reason=reason)


def latest() -> Optional[dict]:
    return MESH.latest()


def device_put(x: Any, device: Any = None, *,
               fn: str = "unlabeled") -> Any:
    """The sanctioned H2D entry point."""
    return MESH.ledger.device_put(x, device, fn=fn)


def fetch(x: Any, *, fn: str = "unlabeled") -> np.ndarray:
    """The sanctioned D2H entry point."""
    return MESH.ledger.fetch(x, fn=fn)


def note_transfer(direction: str, fn: str, nbytes: int,
                  dur_s: float = 0.0) -> None:
    MESH.ledger.note(direction, fn, nbytes, dur_s)


def install_gauges(registry) -> None:
    MESH.install_gauges(registry)


def reset() -> None:
    MESH.reset()

"""Kernel observatory — live device-kernel budget capture + parsing
(``cc-tpu-kernel-budget/2``) over ``torch.profiler``.

The port's counterpart of the reference's ``telemetry/kernel_budget.py``,
with its public names, journal records and artifact schema.  This module
is the port's ONE entry point to ``torch.profiler``
(:func:`profiler_session` and the capture manager's session): a second
session cannot run beside it in one process, so every other user
(``tools/profile_search.py``, the tests) opens its session here.

* **Trace parser** (:func:`parse_trace`) reads a Kineto Chrome trace in
  its two dialects and maps them onto the schema's closed ``dialect``
  vocabulary:

  - ``"device"``: Kineto's ``cat: "kernel"`` events, recorded by CUPTI on
    the card.  Each card (``args.device``) is its own ``/device:GPU:N``;
    a kernel's ``dur`` is its true device time.  Kernels replayed from a
    captured CUDA graph are recorded one by one, like eager launches.
  - ``"host-thunk"``: on the CPU, where the tests run, ``cat: "cpu_op"``
    events.  These nest (``aten::matmul`` ⊃ ``aten::mm``), so a per-thread
    stack walk gives each op its self time; each host thread that ran ops
    is a ``cpu-lane-N`` whose busy time is its ops' self time.

  Kineto records no bytes and no operations for a kernel.  They come from
  each kernel's work model (the ``*_work`` functions beside each wrapper),
  noted at launch into the :data:`WORK` ledger while a capture records;
  a captured step chunk notes its launches' work once at capture and adds
  it again at every replay (``analyzer/step_graph.py``).
* **Dropped records**: the ledger also counts each hand kernel's
  launches over the capture window, so the parse holds the trace's kernel
  records against them.  A trace that lacks records (CUPTI has dropped a
  few dozen of a call's 1 540 in a long-lived process, ROADMAP §C) says
  so: the artifact's ``dropped_records`` (stem → records missing), the
  capture state's ``droppedRecords``, ``cc_kernel_dropped_records_total``
  and a warning log; its counts and busy time are then short.
* **Buckets** (:func:`classify_bucket`): every kernel lands in exactly one
  of the closed :data:`BUCKETS` — the port's hand kernels by their
  ``csrc`` stem (:data:`KERNEL_BUCKETS`), PyTorch's own kernels in
  ``long_tail`` — so bucket self-times partition busy time (the
  reconciliation invariant).
* **CaptureManager** (singleton :data:`CAPTURE`): ``arm`` requests a
  capture of the next N drive-loop scan calls; the engine wraps each scan
  call in :meth:`~CaptureManager.scan_call` and calls
  :meth:`~CaptureManager.begin` at the call's first replay, after any
  graph capture (a CUDA-graph capture is not made under a live session).
  Parsing runs off the request thread (:meth:`~CaptureManager.
  parse_pending`, pumped by the SLO tick) and lands on ``GET
  /profile/kernels``, ``/diagnostics`` (``kernelBudget``) and ``GET
  /metrics`` (``cc_kernel_*``, ``cc_shard_*``).
* **Journal**: ``profiler.capture.start`` / ``.end`` with deterministic
  payloads (sequence-numbered ids, no paths, no timings).

Disarmed cost: one attribute check per scan call, per search and per
kernel launch; ``profiler_trace_dir`` stays out of the step loop's key.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.ops.kernels import (
    HBM_BYTES_PER_S,
    PEAK_F32_FLOPS,
    WORK,
)
from cruise_control_tpu_torch.utils.logging import get_logger

LOG = get_logger("kernel_budget")

SCHEMA = "cc-tpu-kernel-budget/2"

#: the closed bucket vocabulary — by_bucket rows partition busy time
BUCKETS = ("grid_topk", "auction", "move_vec_build", "pool_rebuild",
           "scan_loop", "long_tail")

#: the port's hand kernels (``csrc/<stem>.cu``) by bucket:
#: grid_topk K1 grid_top_r, K13 round_pack, K14 score_columnar, K17
#: grid_patch; move_vec_build K2 grid_terms, K3 per_src_top, K6
#: score_candidates, K7 compact_rows, K16 stale_sets; auction K4
#: budget_accept, K5 match_batch, K15 corrected_accept; pool_rebuild K10
#: pool_tables and K11 top_select (the repool's top-k on the scan path);
#: scan_loop K8 commit_batch, K9 recompute_aggregates; long_tail K12
#: whatif_verdict (off the scan path) and PyTorch's own kernels
KERNEL_BUCKETS = {
    "grid_top_r": "grid_topk", "round_pack": "grid_topk",
    "score_columnar": "grid_topk", "grid_patch": "grid_topk",
    "grid_terms": "move_vec_build", "per_src_top": "move_vec_build",
    "score_candidates": "move_vec_build", "compact_rows": "move_vec_build",
    "stale_sets": "move_vec_build",
    "budget_accept": "auction", "match_batch": "auction",
    "corrected_accept": "auction",
    "pool_tables": "pool_rebuild", "top_select": "pool_rebuild",
    "commit_batch": "scan_loop", "recompute_aggregates": "scan_loop",
    "whatif_verdict": "long_tail",
}

#: kernel records one launch of a wrapper makes where it is not one: K9's
#: six (max, count, scan, scatter, gather, out) and K12's seven (alive,
#: part, sort_count, prep, scatter, brokers, finish)
RECORDS_PER_LAUNCH = {"recompute_aggregates": 6, "whatif_verdict": 7}

#: tiny kernels a capture launches on the card right after its session
#: starts, before the traced call's first replay.  In a process that has
#: run many captures a session loses its first few dozen kernel records:
#: 31-39 of a 1000b/20k scan call's, its first three steps
#: (``chip_smoke.py`` phase 13 (g), ``--late-records-full``); a pause
#: and a synchronize keep them lost, these launches take the loss in the
#: call's place.  Their records stay in the trace as plain torch kernels
PRIMER_LAUNCHES = 64


def _prime_session() -> None:
    """:data:`PRIMER_LAUNCHES` one-element adds on the current card, then
    a synchronize; nothing without one."""
    import torch

    if not PRIMER_LAUNCHES or not torch.cuda.is_available():
        return
    x = torch.zeros(1, device=torch.cuda.current_device())
    for _ in range(PRIMER_LAUNCHES):
        x.add_(1)
    torch.cuda.synchronize()


#: the closed collective-op vocabulary (the mesh observatory); NCCL's
#: kernels and the reference's HLO roots classify alike
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "collective-permute", "all-to-all")


def classify_collective(name: str) -> Optional[str]:
    """Map an HLO/thunk event name to its collective op, or None.

    ``all-reduce.12`` → ``all-reduce``; async halves
    (``all-gather-start.3`` / ``all-gather-done.3``) classify as their
    op — both dialects record collectives under these instruction
    roots.  Fusions never classify (a fused collective keeps its
    ``all-*`` root in both profiler dialects)."""
    root = _name_root(name.lower())
    for op in COLLECTIVE_OPS:
        if root == op or root == op + "-start" or root == op + "-done":
            return op
    return None


def merge_intervals(
        ivals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted union of ``(start, end)`` intervals (overlaps coalesced)."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(i for i in ivals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def overlap_us(merged_a: List[Tuple[float, float]],
               merged_b: List[Tuple[float, float]]) -> float:
    """Total intersection length of two MERGED interval lists."""
    total = 0.0
    i = j = 0
    while i < len(merged_a) and j < len(merged_b):
        s = max(merged_a[i][0], merged_b[j][0])
        e = min(merged_a[i][1], merged_b[j][1])
        if e > s:
            total += e - s
        if merged_a[i][1] <= merged_b[j][1]:
            i += 1
        else:
            j += 1
    return total


#: kernel rows retained in the artifact (the by-category table keeps every
#: hand kernel; the live artifact keeps the head of the kernel list)
_TOP_KERNELS = 40

#: parse queue bound: captures are operator-paced; a burst just drops the
#: oldest unparsed trace (and removes its directory)
_MAX_PENDING_PARSES = 4


# ---- the profiler session (the port's ONE torch.profiler surface) ----------------
_SESSION_LOCK = threading.Lock()
_SESSION_HELD = [False]


def _claim_session() -> None:
    import torch

    with _SESSION_LOCK:
        if _SESSION_HELD[0] or torch.autograd._profiler_enabled():
            raise RuntimeError("a torch.profiler session is already running "
                               "in this process (one at a time)")
        _SESSION_HELD[0] = True


def _release_session() -> None:
    with _SESSION_LOCK:
        _SESSION_HELD[0] = False


#: seconds the process's profiler sessions took to start: the first (on a
#: card, CUPTI's start-up) and the latest, and how many started
SESSION_STARTS: Dict[str, Optional[float]] = {
    "first": None, "latest": None, "count": 0}


def _started(seconds: float) -> None:
    with _SESSION_LOCK:
        if SESSION_STARTS["first"] is None:
            SESSION_STARTS["first"] = seconds
        SESSION_STARTS["latest"] = seconds
        SESSION_STARTS["count"] += 1


def _activities():
    """CUPTI's kernel records on a card; the host ops on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity

    return ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])


class _ProfilerHandle:
    """One live ``torch.profiler`` session exporting to ``trace_dir``.

    Neither Python stacks nor shapes are recorded: the budget's signal is
    the kernel stream, and the reference learned that a Python tracer
    floods a trace with host events the moment a cold compile lands in the
    window (~1M events, zero kernels).  Raises when another session runs."""

    def __init__(self, trace_dir: str, name: str = "capture"):
        import torch

        _claim_session()
        self.trace_dir = trace_dir
        self.path = os.path.join(
            trace_dir, f"cc-{os.getpid()}-{name}.pt.trace.json.gz")
        try:
            t0 = time.perf_counter()
            self._prof = torch.profiler.profile(
                activities=_activities(), with_stack=False,
                record_shapes=False, profile_memory=False)
            self._prof.start()
            _started(time.perf_counter() - t0)
        except BaseException:
            _release_session()
            raise

    def stop(self, export: bool = True) -> None:
        """Stop the session; ``export`` writes the trace to ``path``
        (False aborts a capture without the export cost)."""
        try:
            self._prof.stop()
            if export:
                os.makedirs(self.trace_dir, exist_ok=True)
                self._prof.export_chrome_trace(self.path)
        finally:
            self._prof = None
            _release_session()


# ---- trace discovery -------------------------------------------------------------
def newest_trace(trace_dir: str) -> str:
    """The newest Chrome trace (``*.json.gz`` / ``*.json``) under a
    capture's directory."""
    paths = [p for pat in ("*.json.gz", "*.json")
             for p in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def _load_events(trace_path: str) -> List[dict]:
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", [])


# ---- parsing ---------------------------------------------------------------------
@dataclass
class KernelRow:
    """One kernel (or host op) aggregated over the trace (self time)."""

    name: str
    category: str
    bucket: str
    count: int = 0
    time_us: float = 0.0        # self time (children excluded)
    total_time_us: float = 0.0  # wall incl. children
    bytes: int = 0
    flops: int = 0
    long_name: str = ""


@dataclass
class ParsedTrace:
    """Parser output: kernel rows + the per-device split."""

    dialect: str                        # "device" | "host-thunk"
    rows: List[KernelRow] = field(default_factory=list)
    #: device label → busy microseconds (kernel self time on the device
    #: dialect; a host lane's ops' self time on the host-thunk dialect)
    device_busy_us: Dict[str, float] = field(default_factory=dict)
    #: device label → collective-wait microseconds subtracted from a lane
    #: (empty: one card has no collectives)
    device_collective_us: Dict[str, float] = field(default_factory=dict)
    #: what per-device "busy" means in this parse (``"busy"`` here)
    skew_source: str = "busy"
    #: stem → the kernel records the trace lacks against the launches the
    #: work ledger counted in the window (empty: none missing)
    dropped_records: Dict[str, int] = field(default_factory=dict)

    @property
    def total_time_us(self) -> float:
        return sum(r.time_us for r in self.rows)

    @property
    def total_bytes(self) -> int:
        return sum(r.bytes for r in self.rows)

    @property
    def total_flops(self) -> int:
        return sum(r.flops for r in self.rows)

    @property
    def total_count(self) -> int:
        return sum(r.count for r in self.rows)

    def skew(self) -> Optional[float]:
        """max/mean of per-device busy — 1.0 is a perfectly level mesh;
        None without device attribution."""
        vals = [v for v in self.device_busy_us.values() if v > 0]
        if not vals:
            return None
        mean = sum(vals) / len(vals)
        return (max(vals) / mean) if mean > 0 else None


def _name_root(name: str) -> str:
    """``fusion.933`` → ``fusion``; ``reduce-window.2`` → ``reduce-window``."""
    root = name.split(".", 1)[0]
    return root


_KERNEL_IDENT = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)_kernel\b")


def kernel_stem(name: str) -> Optional[str]:
    """The ``csrc`` stem of a hand kernel's CUDA function name
    (``csrc/<stem>.cu`` names its kernels ``<stem>_kernel`` or
    ``<stem>_<part>_kernel``), or None for any other kernel."""
    for ident in _KERNEL_IDENT.findall(name):
        best = None
        for stem in KERNEL_BUCKETS:
            if (ident == stem or ident.startswith(stem + "_")) and (
                    best is None or len(stem) > len(best)):
                best = stem
        if best is not None:
            return best
    return None


#: host ops (the CPU dialect) that select or sort, and that gather
_HOST_SELECT = ("sort", "argsort", "topk", "kthvalue", "msort")
_HOST_GATHER = ("gather", "index", "index_select", "take", "take_along_dim")


def classify_bucket(name: str, category: str,
                    enclosing: Sequence[str] = ()) -> str:
    """Map one kernel (or host op) to its budget bucket.

    A hand kernel goes by its ``csrc`` stem (:data:`KERNEL_BUCKETS`);
    PyTorch's own kernels (``category`` ``"torch"``) are the long tail.
    A host op of the CPU dialect goes by its name alone, as the
    reference's host dialect does: sorts and top-k to ``grid_topk``,
    gathers to ``move_vec_build``, the rest to ``long_tail``.  The port's
    traces have no control-flow regions, so ``enclosing`` is unused."""
    stem = kernel_stem(name)
    if stem is not None:
        return KERNEL_BUCKETS[stem]
    if category == "torch":
        return "long_tail"
    root = name.lower().rsplit("::", 1)[-1]
    if root in _HOST_SELECT:
        return "grid_topk"
    if root in _HOST_GATHER or "gather" in root:
        return "move_vec_build"
    return "long_tail"


def _short_name(name: str) -> str:
    """``void (anonymous namespace)::grid_top_r_kernel<1, false>(float
    const*, ...)`` → ``grid_top_r_kernel<1, false>``: the kernel's name
    without its namespace qualifier, return type and argument list."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = head.strip()
    return head[5:] if head.startswith("void ") else head


def _walk_threads(per_thread: Dict[Any, List[dict]],
                  dur_us: Callable[[dict], float],
                  account: Callable[[dict, float, Any], None],
                  ) -> None:
    """Per-thread interval stack walk: events nest strictly; each event is
    accounted its duration minus its children's (self time)."""
    for key, evs in per_thread.items():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[Tuple[float, dict]] = []   # (end_ts, event)
        child_time: List[float] = []

        def close_one() -> None:
            _end, ev = stack.pop()
            ct = child_time.pop()
            account(ev, ct, key)
            if child_time:
                child_time[-1] += dur_us(ev)

        for e in evs:
            ts = e["ts"]
            while stack and ts >= stack[-1][0] - 1e-9:
                close_one()
            stack.append((ts + e.get("dur", 0.0), e))
            child_time.append(0.0)
        while stack:
            close_one()


def device_label(e: dict) -> str:
    """A device-dialect event's card: ``/device:GPU:<args.device>``."""
    return f"/device:GPU:{e.get('args', {}).get('device', e.get('pid'))}"


def _xevents(events: List[dict], cat: str) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == cat
            and "ts" in e]


def parse_trace(trace_path: str,
                work: Optional[Dict[str, Sequence[float]]] = None,
                ) -> ParsedTrace:
    """Parse one Kineto Chrome trace into kernel rows with self-time
    accounting and the per-device split, detecting the dialect: the
    card's kernel records (``cat: "kernel"``) or the CPU's host ops
    (``cat: "cpu_op"``).  ``work`` (stem → [launches, bytes, operations],
    the :data:`WORK` ledger's table for the capture window) gives each
    hand kernel's rows their bytes and operations, spread over its rows by
    launch count, and the records the trace should hold
    (:func:`missing_records`)."""
    events = _load_events(trace_path)
    kernels = _xevents(events, "kernel")
    if kernels:
        parsed = _parse_device_dialect(kernels)
    else:
        parsed = _parse_host_dialect(_xevents(events, "cpu_op"))
    _apportion_work(parsed.rows, work or {})
    parsed.dropped_records = missing_records(parsed.rows, work or {})
    return parsed


def _parse_device_dialect(events: List[dict]) -> ParsedTrace:
    parsed = ParsedTrace(dialect="device")
    agg: Dict[Tuple[str, str], KernelRow] = {}
    per_device: Dict[str, float] = {}

    def dur_us(e: dict) -> float:
        return float(e.get("dur", 0.0))

    def account(e: dict, child_us: float, _key) -> None:
        d_us = dur_us(e)
        self_us = max(0.0, d_us - child_us)
        full = str(e.get("name", ""))
        stem = kernel_stem(full)
        category = stem or "torch"
        bucket = classify_bucket(full, category)
        name = _short_name(full)
        row = agg.setdefault((full, bucket), KernelRow(
            name=name, category=category, bucket=bucket,
            long_name=full[:240]))
        row.count += 1
        row.time_us += self_us
        row.total_time_us += d_us
        label = device_label(e)
        per_device[label] = per_device.get(label, 0.0) + self_us

    per_stream: Dict[Any, List[dict]] = {}
    for e in events:
        a = e.get("args", {})
        per_stream.setdefault((a.get("device", e.get("pid")),
                               a.get("stream", e.get("tid"))), []).append(e)
    _walk_threads(per_stream, dur_us, account)
    parsed.rows = list(agg.values())
    parsed.device_busy_us = per_device
    return parsed


def _parse_host_dialect(events: List[dict]) -> ParsedTrace:
    parsed = ParsedTrace(dialect="host-thunk")
    agg: Dict[Tuple[str, str], KernelRow] = {}
    per_lane: Dict[Any, float] = {}

    def dur_us(e: dict) -> float:
        return float(e.get("dur", 0.0))

    def account(e: dict, child_us: float, key) -> None:
        d_us = dur_us(e)
        self_us = max(0.0, d_us - child_us)
        name = str(e.get("name", ""))
        bucket = classify_bucket(name, name)
        row = agg.setdefault((name, bucket), KernelRow(
            name=name, category=name, bucket=bucket))
        row.count += 1
        row.time_us += self_us
        row.total_time_us += d_us
        per_lane[key] = per_lane.get(key, 0.0) + self_us

    per_thread: Dict[Any, List[dict]] = {}
    for e in events:
        per_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    _walk_threads(per_thread, dur_us, account)
    parsed.rows = list(agg.values())
    order = {k: i for i, k in enumerate(sorted(per_lane, key=str))}
    parsed.device_busy_us = {f"cpu-lane-{order[k]}": v
                             for k, v in per_lane.items()}
    return parsed


def _apportion_work(rows: List[KernelRow],
                    work: Dict[str, Sequence[float]]) -> None:
    """Give each hand kernel's rows its stem's bytes and operations, in
    proportion to their launch counts (the last row takes the remainder,
    so a stem's totals are exact)."""
    by_stem: Dict[str, List[KernelRow]] = {}
    for row in rows:
        if row.category in work:
            by_stem.setdefault(row.category, []).append(row)
    for stem, srows in by_stem.items():
        _n, nbytes, ops = work[stem]
        total = sum(r.count for r in srows)
        left_b, left_o = int(nbytes), int(ops)
        for i, row in enumerate(sorted(srows, key=lambda r: r.name)):
            if i == len(srows) - 1:
                row.bytes, row.flops = left_b, left_o
            else:
                row.bytes = int(nbytes) * row.count // total
                row.flops = int(ops) * row.count // total
                left_b -= row.bytes
                left_o -= row.flops


def missing_records(rows: List[KernelRow],
                    work: Dict[str, Sequence[float]]) -> Dict[str, int]:
    """Stem → the kernel records ``rows`` lack against the launches the
    work ledger counted (each launch makes :data:`RECORDS_PER_LAUNCH`
    records, one where unlisted); stems with every record are left out.
    More records than launches means a launch the ledger missed: logged,
    not reported as a drop."""
    seen: Dict[str, int] = {}
    for row in rows:
        seen[row.category] = seen.get(row.category, 0) + row.count
    out: Dict[str, int] = {}
    for stem in sorted(work):
        want = int(work[stem][0]) * RECORDS_PER_LAUNCH.get(stem, 1)
        got = seen.get(stem, 0)
        if got < want:
            out[stem] = want - got
        elif got > want:
            LOG.warning("kernel-budget trace holds %d records of %s, its "
                        "launches %d", got, stem, want)
    return out


# ---- artifact --------------------------------------------------------------------
def chip_name() -> str:
    """The card's name (``torch.cuda.get_device_name``), "cpu" without
    one."""
    import torch

    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")


def build_artifact(
    parsed: ParsedTrace,
    units: int,
    unit: str = "scan-call",
    source: str = "live-capture",
    backend: Optional[str] = None,
    capture: Optional[dict] = None,
    fixture: Optional[dict] = None,
    top: int = _TOP_KERNELS,
    now: Optional[float] = None,
    chip: Optional[str] = None,
) -> dict:
    """Assemble the ``cc-tpu-kernel-budget/2`` artifact from a parsed
    trace.  ``units`` is the per-unit divisor (scan calls for a live
    capture).  ``hw`` holds the card's roofline denominators (H100 SXM:
    3.35 TB/s HBM3, 67 TFLOP/s f32), the ones ``chip_smoke.py`` bounds
    each kernel with; ``dropped_records`` the kernel records the trace
    lacks (:func:`missing_records`, over the whole capture)."""
    units = max(1, int(units))
    tot_us = parsed.total_time_us
    tot_bytes = parsed.total_bytes
    tot_flops = parsed.total_flops
    by_bucket: Dict[str, dict] = {}
    by_category: Dict[str, dict] = {}
    for row in parsed.rows:
        b = by_bucket.setdefault(
            row.bucket, {"count": 0, "time_us": 0.0, "bytes": 0})
        b["count"] += row.count
        b["time_us"] += row.time_us
        b["bytes"] += row.bytes
        c = by_category.setdefault(
            row.category, {"count": 0, "time_us": 0.0, "bytes": 0})
        c["count"] += row.count
        c["time_us"] += row.time_us
        c["bytes"] += row.bytes
    rows = sorted(parsed.rows, key=lambda r: -r.time_us)
    if backend is None:
        backend = "cuda" if parsed.dialect == "device" else "cpu"
    skew = parsed.skew()
    art = {
        "schema": SCHEMA,
        "generated_unix": round(time.time() if now is None else now, 3),
        "backend": backend,
        "dialect": parsed.dialect,
        "source": source,
        "unit": unit,
        "units": units,
        "hw": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
               "peak_f32_flops": PEAK_F32_FLOPS,
               "chip": chip if chip is not None else chip_name()},
        "per_unit": {
            "kernels": round(parsed.total_count / units, 2),
            "device_busy_ms": round(tot_us / units / 1e3, 4),
            "bytes_mb": round(tot_bytes / units / 1e6, 4),
            "model_gflops": round(tot_flops / units / 1e9, 4),
            "hbm_floor_ms": round(
                tot_bytes / units / HBM_BYTES_PER_S * 1e3, 4),
            "flops_floor_ms": round(
                tot_flops / units / PEAK_F32_FLOPS * 1e3, 4),
        },
        # bytes / busy-time over the card's bandwidth (0 on the CPU
        # dialect, where no hand kernel launches)
        "hbm_utilization_of_busy": round(
            (tot_bytes / (tot_us / 1e6)) / HBM_BYTES_PER_S
            if tot_us else 0.0, 6),
        "by_bucket": {
            k: {
                "count_per_unit": round(v["count"] / units, 2),
                "us_per_unit": round(v["time_us"] / units, 2),
                "mb_per_unit": round(v["bytes"] / units / 1e6, 4),
                "share_of_busy": round(
                    v["time_us"] / tot_us if tot_us else 0.0, 4),
            }
            for k, v in sorted(by_bucket.items(),
                               key=lambda kv: -kv[1]["time_us"])
        },
        "by_category": {
            k: {
                "count_per_unit": round(v["count"] / units, 2),
                "us_per_unit": round(v["time_us"] / units, 2),
                "mb_per_unit": round(v["bytes"] / units / 1e6, 4),
            }
            for k, v in sorted(by_category.items(),
                               key=lambda kv: -kv[1]["time_us"])
        },
        "devices": {
            "count": len(parsed.device_busy_us),
            "busy_ms": {
                k: round(v / 1e3, 4)
                for k, v in sorted(parsed.device_busy_us.items())
            },
            "skew": round(skew, 4) if skew is not None else None,
            "skew_source": parsed.skew_source,
        },
        "kernels": [
            {
                "name": r.name,
                "category": r.category,
                "bucket": r.bucket,
                "count_per_unit": round(r.count / units, 2),
                "us_per_unit": round(r.time_us / units, 3),
                "mb_per_unit": round(r.bytes / units / 1e6, 5),
                "gbps": round(r.bytes / (r.time_us / 1e6) / 1e9, 2)
                if r.time_us else 0.0,
                "long_name": r.long_name,
            }
            for r in rows[:top]
        ],
        "dropped_records": dict(sorted(parsed.dropped_records.items())),
    }
    if capture is not None:
        art["capture"] = capture
    if fixture is not None:
        art["fixture"] = fixture
    return art


# ---- budget regression gate ------------------------------------------------------
def compare_budget(artifact: dict, budget: dict) -> List[str]:
    """Gate a measured artifact against a pinned budget: per-bucket
    kernel COUNTS and the total may not grow past the budget's ceiling
    (timings are too host-noisy to pin; counts are deterministic for a
    fixed program).  Shrinkage is an improvement, never a violation.
    Returns human-readable violations (empty = gate holds)."""
    tol = 1.0 + float(budget.get("tolerance_pct", 10)) / 100.0
    out: List[str] = []
    pinned_fixture = budget.get("fixture") or {}
    fixture = artifact.get("fixture") or {}
    for key in sorted(set(pinned_fixture) & set(fixture)):
        if pinned_fixture[key] != fixture[key]:
            out.append(
                f"fixture mismatch on {key!r}: measured "
                f"{fixture[key]!r} vs budget {pinned_fixture[key]!r} — "
                "kernel counts only compare at identical shapes"
            )
    if out:
        return out
    measured_total = float(artifact["per_unit"]["kernels"])
    budget_total = float(budget["total_kernels_per_unit"])
    if measured_total > budget_total * tol:
        out.append(
            f"total kernels/{artifact['unit']} grew to "
            f"{measured_total:g} (budget {budget_total:g}, "
            f"+{budget.get('tolerance_pct', 10)}% ceiling "
            f"{budget_total * tol:g})"
        )
    for bucket, pinned in budget.get("by_bucket", {}).items():
        ceiling = float(pinned["count_per_unit"]) * tol
        got = float(
            artifact["by_bucket"].get(bucket, {}).get("count_per_unit", 0.0)
        )
        if got > ceiling:
            out.append(
                f"bucket {bucket!r} grew to {got:g} kernels/"
                f"{artifact['unit']} (budget "
                f"{pinned['count_per_unit']:g}, ceiling {ceiling:g})"
            )
    return out


# ---- the capture manager ---------------------------------------------------------
_IDLE = "IDLE"
_ARMED = "ARMED"
_TRACING = "TRACING"


class CaptureManager:
    """On-demand device-kernel capture around drive-loop scan calls.

    State machine (one capture at a time)::

        IDLE --arm()--> ARMED --1st scan_call--> TRACING
        TRACING --Nth scan_call / search end--> IDLE (+ pending parse)

    The engine claims an armed capture at search entry
    (:meth:`search_scope`), wraps every scan call in :meth:`scan_call`,
    and calls :meth:`begin` at a call's first replay: the profiler starts
    there, after any CUDA-graph capture, not at the call's entry.  Parsing
    happens in :meth:`parse_pending`, off the request thread.  The
    disarmed fast path is one attribute read.
    """

    def __init__(self, enabled: bool = True, default_scans: int = 3,
                 trace_dir: str = "",
                 clock: Optional[Callable[[], float]] = None,
                 id_factory: Optional[Callable[[], str]] = None):
        self.enabled = enabled
        self.default_scans = max(1, int(default_scans))
        self.trace_dir = trace_dir
        self._clock = clock or time.time
        self._seq = 0
        self._id_factory = id_factory or self._next_id
        self._lock = threading.Lock()
        self._state = _IDLE
        self._owner: Optional[int] = None
        self._capture_id: Optional[str] = None
        self._reason = ""
        self._scans_requested = 0
        self._scans_seen = 0
        self._started = 0.0
        self._active_dir: Optional[str] = None
        self._cleanup_dir: Optional[str] = None
        self._handle: Optional[_ProfilerHandle] = None
        #: the profiler start a scan call owes (a trace dir and the start
        #: record), made by :meth:`begin` at the call's first replay
        self._start_owed: Optional[Tuple[str, dict]] = None
        #: the work ledger's recorder of the live trace
        self._work: Optional[Dict[str, List[float]]] = None
        #: traces waiting for an off-thread parse:
        #: (trace_dir, cleanup_dir|None, capture meta, work table)
        self._pending: List[Tuple[str, Optional[str], dict, dict]] = []
        #: parses popped from the queue and currently running — a poll
        #: mid-parse must read "in flight", not "never captured"
        self._parsing = 0
        self._latest: Optional[dict] = None
        #: the latest parse before the artifact's rounding (in-process
        #: checks of the partition)
        self._latest_parsed: Optional[ParsedTrace] = None
        self.captures = 0
        self.parse_failures = 0
        #: kernel records the parsed traces lacked against their windows'
        #: launches, over every capture
        self.dropped_records = 0
        #: trace starts refused (another profiler session was running)
        self.refusals = 0
        self.last_error: Optional[str] = None
        #: seconds of the latest profiler start (CUPTI's start-up on the
        #: first session of a process), stop + export, and parse
        self.last_start_s: Optional[float] = None
        self.last_stop_s: Optional[float] = None
        self.last_parse_s: Optional[float] = None
        #: a capture is claimed by a search (scan calls then run with the
        #: trace's synchronize at their end)
        self.capturing = False
        #: secondary consumers of the ONE capture pipeline (the mesh
        #: observatory): ``on_trace_start(meta)``, ``on_trace_finish
        #: (meta)`` on the owner thread, ``on_parse(trace_path, meta)``
        #: off it.  Registration is structural: observers survive
        #: :meth:`reset`/:meth:`scoped`.
        self._observers: List[Any] = []

    def add_observer(self, observer: Any) -> None:
        """Register a capture observer (idempotent)."""
        with self._lock:
            if observer not in self._observers:
                self._observers.append(observer)

    def remove_observer(self, observer: Any) -> None:
        with self._lock:
            if observer in self._observers:
                self._observers.remove(observer)

    def _notify(self, hook: str, *args) -> None:
        with self._lock:
            observers = list(self._observers)
        for obs in observers:
            fn = getattr(obs, hook, None)
            if fn is None:
                continue
            try:
                fn(*args)
            except Exception:  # an observer must not break the capture
                LOG.exception("kernel-budget observer %s failed", hook)

    def _next_id(self) -> str:
        self._seq += 1  # cclint: disable=lock-discipline -- only reachable via self._id_factory, whose call sites (arm, search_scope's legacy claim) hold self._lock
        return f"capture-{self._seq}"

    # ---- configuration ----------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  default_scans: Optional[int] = None,
                  trace_dir: Optional[str] = None,
                  clock: Optional[Callable[[], float]] = None,
                  id_factory: Optional[Callable[[], str]] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if default_scans is not None:
                self.default_scans = max(1, int(default_scans))
            if trace_dir is not None:
                self.trace_dir = trace_dir
            if clock is not None:
                self._clock = clock
            if id_factory is not None:
                self._id_factory = id_factory

    def reset(self) -> None:
        """Drop all state (tests).  An in-flight trace, if any, is
        stopped so the process's profiler is reusable."""
        with self._lock:
            handle, self._handle = self._handle, None
            pending, self._pending = self._pending, []
            work, self._work = self._work, None
            self._state = _IDLE
            self._owner = None
            self._start_owed = None
            self.capturing = False
            self._latest = None
            self._latest_parsed = None
            self._seq = 0
            self.captures = 0
            self.parse_failures = 0
            self.dropped_records = 0
            self.refusals = 0
            self.last_error = None
        if work is not None:
            WORK.close(work)
        if handle is not None:
            try:
                handle.stop(export=False)
            except Exception:  # the profiler refused; nothing to recover
                LOG.exception("kernel-budget trace abort failed")
        for _dir, cleanup, _meta, _work in pending:
            self._rm(cleanup)

    @staticmethod
    def _rm(path: Optional[str]) -> None:
        if path:
            shutil.rmtree(path, ignore_errors=True)

    @contextlib.contextmanager
    def scoped(self, clock: Optional[Callable[[], float]] = None,
               id_factory: Optional[Callable[[], str]] = None):
        """Swap in a deterministic clock / capture-id factory for the
        scope of one scenario run (the simulator injects its virtual
        clock and a ``sim-capture-N`` counter so journal fingerprints
        stay bit-stable), resetting capture state and restoring the
        previous configuration on exit."""
        with self._lock:
            prev_clock, prev_factory = self._clock, self._id_factory
            if clock is not None:
                self._clock = clock
            if id_factory is not None:
                self._id_factory = id_factory
        try:
            yield self
        finally:
            self.reset()
            with self._lock:
                self._clock, self._id_factory = prev_clock, prev_factory

    # ---- arming -----------------------------------------------------------------
    def arm(self, scans: Optional[int] = None,
            reason: str = "api") -> dict:
        """Request a capture of the next ``scans`` drive-loop scan calls.
        Idempotent while a capture is in flight (the current state is
        returned either way)."""
        with self._lock:
            if self.enabled and self._state == _IDLE:
                self._state = _ARMED
                self._owner = None
                self._capture_id = self._id_factory()
                self._reason = reason
                self._scans_requested = max(
                    1, int(scans) if scans else self.default_scans)
                self._scans_seen = 0
        return self.state()

    def state(self) -> dict:
        """The poll body (202 responses) / diagnostics block."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "state": self._state,
                "captureId": self._capture_id,
                "scansRequested": self._scans_requested,
                "scansTraced": self._scans_seen,
                "pendingParses": len(self._pending),
                "activeParses": self._parsing,
                "captures": self.captures,
                "parseFailures": self.parse_failures,
                "droppedRecords": self.dropped_records,
                "refusals": self.refusals,
                "lastError": self.last_error,
                "lastStartS": self.last_start_s,
                "lastStopS": self.last_stop_s,
                "lastParseS": self.last_parse_s,
            }

    # ---- optimizer integration --------------------------------------------------
    @contextlib.contextmanager
    def search_scope(self, legacy_trace_dir: str = ""):
        """Wraps ONE engine search.  Claims an armed capture for the
        calling thread (so its scan calls are the traced ones) and, when
        ``cuda.search.profiler.trace.dir`` is set, traces the WHOLE search
        into that directory through this single entry point — the trace
        feeds the same parse queue and stays in the directory."""
        claimed = False
        legacy = False
        if legacy_trace_dir:
            meta = None
            with self._lock:
                if self._state == _IDLE:
                    legacy = True
                    self._state = _TRACING
                    self._owner = threading.get_ident()
                    self._capture_id = self._id_factory()
                    self._reason = "profiler_trace_dir"
                    self._scans_requested = 0
                    self._scans_seen = 0
                    self._started = self._clock()
                    self._active_dir = legacy_trace_dir
                    self._cleanup_dir = None
                    self.capturing = True
                    meta = self._start_meta()
            if legacy:
                self._start_trace(legacy_trace_dir, meta)
        elif self.enabled:
            with self._lock:
                if self._state == _ARMED and self._owner is None:
                    self._owner = threading.get_ident()
                    claimed = True
                    self.capturing = True
        try:
            yield self
        finally:
            if legacy:
                with self._lock:
                    legacy_live = self._state == _TRACING \
                        and self._owner == threading.get_ident()
                if legacy_live:  # trace start may have failed
                    self._finish(reason="search-end")
            elif claimed:
                with self._lock:
                    still_mine = self._owner == threading.get_ident() \
                        and self._state in (_ARMED, _TRACING)
                    tracing_now = self._state == _TRACING
                if still_mine:
                    if tracing_now:
                        # the search ended before N scan calls landed:
                        # close the capture with what it got
                        self._finish(reason="search-end")
                    else:
                        # never reached a scan call (score-only path /
                        # converged instantly): release the claim so the
                        # next search can serve the armed capture
                        with self._lock:
                            self._owner = None
                            self.capturing = False

    @contextlib.contextmanager
    def scan_call(self):
        """Wraps one drive-loop scan call.  Owes the profiler's start to
        the call's first replay (:meth:`begin`) and, at the call's end,
        synchronizes the card and stops the trace once the requested scan
        count has been traced.  No-op (one lock-free check) unless this
        thread owns an armed capture."""
        if self._owner != threading.get_ident():
            yield
            return
        with self._lock:
            if self._owner != threading.get_ident():
                mine = False
            else:
                mine = True
                if self._state == _ARMED:
                    self._state = _TRACING
                    self._started = self._clock()
                    base = self.trace_dir or None
                    if base:
                        os.makedirs(base, exist_ok=True)
                    self._cleanup_dir = tempfile.mkdtemp(
                        prefix="cc-kernel-budget-", dir=base)
                    self._active_dir = self._cleanup_dir
                    self._start_owed = (self._active_dir,
                                        self._start_meta())
        if not mine:
            yield
            return
        try:
            yield
        finally:
            # a call that never reached a replay still owes its start
            self.begin()
            done = False
            with self._lock:
                tracing = self._state == _TRACING \
                    and self._owner == threading.get_ident()
            if tracing:
                # the call's kernels complete inside the window
                _synchronize()
                with self._lock:
                    self._scans_seen += 1
                    # scansRequested == 0 is the legacy whole-search
                    # trace: only search_scope's exit finishes it
                    done = (self._scans_requested > 0
                            and self._scans_seen >= self._scans_requested)
            if done:
                self._finish(reason="scans-complete")

    def begin(self) -> None:
        """Start the owed profiler session — the engine calls this at a
        scan call's first replay, after any CUDA-graph capture.  No-op
        (one lock-free check) unless this thread's capture owes one."""
        if self._start_owed is None \
                or self._owner != threading.get_ident():
            return
        with self._lock:
            owed, self._start_owed = self._start_owed, None
        if owed is not None:
            self._start_trace(*owed)

    def _start_meta(self) -> dict:
        return {
            "id": self._capture_id,
            "reason": self._reason,
            "scansRequested": self._scans_requested,
            "startedUnix": round(self._started, 3),
        }

    def _start_trace(self, trace_dir: str, meta: dict) -> None:
        from cruise_control_tpu_torch.telemetry import events

        t0 = time.perf_counter()
        try:
            handle = _ProfilerHandle(trace_dir, name=str(meta["id"]))
        except Exception as e:
            # a second profiler session must fail the capture, not the
            # rebalance that carries it
            LOG.warning("kernel-budget trace start refused: %s", e)
            with self._lock:
                self._state = _IDLE
                self._owner = None
                self.capturing = False
                self.refusals += 1
                self.last_error = str(e)
                self._rm(self._cleanup_dir)
                self._cleanup_dir = None
            return
        start_s = time.perf_counter() - t0
        work = WORK.open()
        with self._lock:
            self._handle = handle
            self._work = work
            self.last_start_s = start_s
        self._notify("on_trace_start", meta)
        events.emit(
            "profiler.capture.start", captureId=meta["id"],
            scans=meta["scansRequested"], reason=meta["reason"],
        )
        _prime_session()

    def _finish(self, reason: str) -> None:
        """Stop the trace and queue the directory for an off-thread
        parse."""
        from cruise_control_tpu_torch.telemetry import events

        with self._lock:
            handle, self._handle = self._handle, None
            work, self._work = self._work, None
        if work is not None:
            WORK.close(work)
        t0 = time.perf_counter()
        if handle is not None:
            try:
                handle.stop(export=True)
            except Exception:  # export failed; the parse will report it
                LOG.exception("kernel-budget trace stop failed")
        stop_s = time.perf_counter() - t0
        # still on the capture-owner thread, with the search's device
        # state alive — the mesh observatory's audit runs here
        self._notify("on_trace_finish", {"id": self._capture_id})
        with self._lock:
            self.last_stop_s = stop_s
            meta = {
                "id": self._capture_id,
                "reason": self._reason,
                "scansRequested": self._scans_requested,
                "scansTraced": self._scans_seen,
                "startedUnix": round(self._started, 3),
                "wallS": round(max(0.0, self._clock() - self._started), 3),
            }
            self._pending.append(
                (self._active_dir, self._cleanup_dir, meta, work or {}))
            while len(self._pending) > _MAX_PENDING_PARSES:
                _dir, cleanup, dropped, _w = self._pending.pop(0)
                self._rm(cleanup)
                LOG.warning("kernel-budget parse queue full; dropped "
                            "capture %s", dropped.get("id"))
            self._state = _IDLE
            self._owner = None
            self._start_owed = None
            self.capturing = False
            self._active_dir = None
            self._cleanup_dir = None
            capture_id = meta["id"]
            scans_traced = meta["scansTraced"]
        events.emit(
            "profiler.capture.end", captureId=capture_id,
            scansTraced=scans_traced, stopReason=reason,
        )

    # ---- off-thread parse (SLO maintenance tick) --------------------------------
    def parse_pending(self, max_parses: int = 1) -> int:
        """Parse up to ``max_parses`` captured traces into artifacts.
        Chrome-trace parsing is tens of milliseconds to seconds of pure
        host work — which is why this rides the SLO observatory's
        maintenance tick (like ``device_cost.capture_pending``), never a
        request thread.  Returns the number parsed; never raises."""
        done = 0
        while done < max_parses:
            with self._lock:
                if not self._pending:
                    return done
                trace_dir, cleanup_dir, meta, work = self._pending.pop(0)
                self._parsing += 1
            try:
                t0 = time.perf_counter()
                trace_path = newest_trace(trace_dir)
                parsed = parse_trace(trace_path, work=work)
                units = max(1, int(meta.get("scansTraced") or 0))
                artifact = build_artifact(
                    parsed, units=units, unit="scan-call",
                    source=("legacy-trace-dir"
                            if meta.get("reason") == "profiler_trace_dir"
                            else "live-capture"),
                    capture=meta, now=self._clock(),
                )
                dropped = parsed.dropped_records
                if dropped:
                    LOG.warning(
                        "kernel-budget capture %s: the trace lacks %d "
                        "kernel records of its launches (%s); its counts "
                        "and busy time are short", meta.get("id"),
                        sum(dropped.values()), dropped)
                with self._lock:
                    self._latest = artifact
                    self._latest_parsed = parsed
                    self.captures += 1
                    self.dropped_records += sum(dropped.values())
                    self.last_parse_s = time.perf_counter() - t0
                # secondary consumers (the mesh observatory) parse the
                # same trace before the directory is cleaned up
                self._notify("on_parse", trace_path, meta)
            except Exception:
                with self._lock:
                    self.parse_failures += 1
                LOG.exception("kernel-budget trace parse failed for "
                              "capture %s", meta.get("id"))
            finally:
                self._rm(cleanup_dir)
                with self._lock:
                    self._parsing -= 1
            done += 1
        return done

    # ---- readers ----------------------------------------------------------------
    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._latest

    def latest_parsed(self) -> Optional[ParsedTrace]:
        with self._lock:
            return self._latest_parsed

    def summary(self) -> dict:
        """The ``/diagnostics`` merge block: capture state + the latest
        measured budget (estimates from ``deviceCost`` sit beside it)."""
        out = self.state()
        with self._lock:
            out["latest"] = self._latest
        return out

    def families(self) -> List[tuple]:
        """``extra_families`` rows for the Prometheus exposition, from the
        latest parsed capture: per-bucket busy/count/bytes, the measured
        HBM utilization, and the per-device split."""
        art = self.latest()
        if art is None:
            return []
        fams: List[tuple] = []
        for fam, key, scale, help_ in (
            ("cc_kernel_busy_ms", "us_per_unit", 1e-3,
             "Measured device-kernel self time per scan call, by budget "
             "bucket (latest capture)"),
            ("cc_kernel_count", "count_per_unit", 1.0,
             "Measured kernels per scan call, by budget bucket"),
            ("cc_kernel_bytes", "mb_per_unit", 1e6,
             "Bytes per scan call, by budget bucket, from the hand "
             "kernels' work models (0 for PyTorch's own kernels)"),
        ):
            rows = [({"category": bucket}, float(v.get(key, 0.0)) * scale)
                    for bucket, v in art["by_bucket"].items()]
            if rows:
                fams.append((fam, "gauge", help_, rows))
        fams.append((
            "cc_kernel_hbm_utilization_measured", "gauge",
            "Work-model bytes over measured device busy time, as a share "
            "of the card's HBM bandwidth (latest capture; the always-on "
            "estimate is cc_device_hbm_utilization_estimate)",
            [({}, float(art["hbm_utilization_of_busy"]))],
        ))
        fams.append((
            "cc_kernel_dropped_records_total", "counter",
            "Kernel records the captures' traces lacked against the "
            "launches the hand kernels' wrappers counted in their windows",
            [({}, float(self.dropped_records))],
        ))
        devices = art.get("devices", {})
        busy = devices.get("busy_ms", {})
        if busy:
            fams.append((
                "cc_shard_busy_ms", "gauge",
                "Per-device busy time of the latest capture (kernel self "
                "time on a card; host ops' self time per thread on the "
                "CPU)",
                [({"device": label}, float(ms))
                 for label, ms in busy.items()],
            ))
        if devices.get("skew") is not None:
            fams.append((
                "cc_shard_skew", "gauge",
                "max/mean of per-device busy time (1.0 = level mesh)",
                [({}, float(devices["skew"]))],
            ))
        return fams

    def install_gauges(self, registry) -> None:
        registry.gauge("kernel.capture.parses.pending",
                       lambda: float(len(self._pending)))
        registry.gauge("kernel.capture.count",
                       lambda: float(self.captures))


def _synchronize() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---- the single profiler entry point (tools ride it too) ------------------------
@contextlib.contextmanager
def profiler_session(trace_dir: Optional[str] = None, activities=None):
    """A raw ``torch.profiler`` session — the port's ONE place besides the
    capture manager that starts the profiler.  Yields the
    ``torch.profiler.profile`` object (``activities`` defaults to CUPTI's
    kernels on a card, the host ops on the CPU); with ``trace_dir`` the
    Chrome trace is exported there on exit (its path in ``.trace_path``).
    Raises when another session runs in the process."""
    import torch

    _claim_session()
    try:
        prof = torch.profiler.profile(
            activities=activities or _activities(), with_stack=False,
            record_shapes=False, profile_memory=False)
        t0 = time.perf_counter()
        with prof:
            _started(time.perf_counter() - t0)
            yield prof
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.trace_path = os.path.join(
                trace_dir, f"cc-{os.getpid()}-session.pt.trace.json.gz")
            prof.export_chrome_trace(prof.trace_path)
    finally:
        _release_session()


#: process-wide default (bootstrap reconfigures it from the
#: telemetry.kernel.* keys; the sim swaps in a virtual clock and a
#: deterministic id factory so scenario fingerprints stay bit-stable)
CAPTURE = CaptureManager()


# module-level conveniences bound to the default instance -------------------------
def configure(**kwargs) -> None:
    CAPTURE.configure(**kwargs)


def arm(scans: Optional[int] = None, reason: str = "api") -> dict:
    return CAPTURE.arm(scans=scans, reason=reason)


def parse_pending(max_parses: int = 1) -> int:
    return CAPTURE.parse_pending(max_parses)


def latest() -> Optional[dict]:
    return CAPTURE.latest()


def install_gauges(registry) -> None:
    CAPTURE.install_gauges(registry)


def reset() -> None:
    CAPTURE.reset()

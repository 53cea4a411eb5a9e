"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface; it is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library at first use and loaded with
``ctypes``.  Builds go to ``build/torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the source and of
the shared headers (``csrc/*.cuh``), so an edited kernel or header never
loads a stale library.  Nothing here runs at import:
the CPU tests import every module of the package without a compiler.

Builds and loads are told to the :data:`LISTENERS` (the device-stats
monitor, ``telemetry/device_stats.py``, registers there): each library's
first load in a process, with its ``nvcc`` seconds when the process built
it, and each library the process built.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: keeps each kernel's rounding equal to its plain
    # torch version, operation for operation
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: H100 shared memory one block may use (bytes), dynamic opt-in included
SMEM_LIMIT = 232_448

#: the card's roofline denominators (H100 SXM): HBM3 bytes a second and
#: f32 operations a second — what a kernel's bound (``chip_smoke.py``) and
#: the kernel observatory's floors divide its work model by
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: kernel → nvcc seconds of the build this process made of it, until its
#: first load counts them
_built_s: Dict[str, float] = {}
#: build and load listeners: ``on_kernel_put(name)`` after each library
#: this process built, ``on_kernel_load(name, seconds, library, built)`` at
#: each library's first load in the process (``seconds`` includes the
#: build's ``nvcc`` seconds where ``built``)
LISTENERS: List[Any] = []


def add_listener(listener: Any) -> None:
    """Register a build and load listener (idempotent)."""
    with _lock:
        if listener not in LISTENERS:
            LISTENERS.append(listener)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is built: keyed by a hash of its
    source, every shared header (``csrc/*.cuh``, so an edited header
    rebuilds each kernel) and the compiler flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; raises with the compiler's output if any
    build fails.  Each build's ``ptxas`` report (registers, shared memory,
    spills) is kept beside the library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out[n])
        # the builds run together: each is charged the wall until its
        # compiler was collected
        _built_s[n] = time.perf_counter() - t0
        for listener in list(LISTENERS):
            listener.on_kernel_put(n)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built now if needed)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
            nvcc_s = _built_s.pop(name, None)
            seconds = (nvcc_s or 0.0) + time.perf_counter() - t0
            for listener in list(LISTENERS):
                listener.on_kernel_load(name, seconds, path.name,
                                        nvcc_s is not None)
        return lib


def bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """Kernel ``name``'s library with ``fn`` typed (``restype`` int: the
    CUDA error code of the launch)."""
    lib = load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(kernel: str, name: str, x, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what kernel ``kernel`` takes."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} {tuple(shape)} "
            f"tensor on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}"
        )


def launched(kernel: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed (CUDA error {err})")


#: what a kernel's ``*_attrs`` C function reports, in its order
ATTR_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
             "blocks_per_sm")


def attrs(kernel: str, fn, *args) -> Dict[str, int]:
    """Call a kernel's exported ``*_attrs(args..., int* out)`` — its
    ``cudaFuncGetAttributes`` and ``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor`` at the given shape — and name the five numbers
    (:data:`ATTR_KEYS`)."""
    out = (ctypes.c_int * len(ATTR_KEYS))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{kernel}: attributes query failed (CUDA error "
                           f"{err})")
    return dict(zip(ATTR_KEYS, out))


class WorkLedger:
    """Bytes and operations of the hand kernels' launches, by ``csrc``
    stem, noted by each wrapper where it launches its kernel while a
    recorder is open (:meth:`recording`; the kernel observatory's capture,
    a step chunk's CUDA-graph capture).  The work is the kernel's work
    model at the launch's shapes (the ``*_work`` function beside each
    wrapper), the count ``chip_smoke.py`` bounds the kernel with, taken at
    the most its shapes can need where the work depends on the data.
    Disarmed cost: one attribute check a launch (:attr:`active` is an
    empty list)."""

    def __init__(self):
        self._lock = threading.Lock()
        #: open recorders: stem → [launches, bytes, operations]
        self.active: List[Dict[str, List[float]]] = []

    def note(self, stem: str, nbytes: float, ops: float) -> None:
        """One launch of kernel ``stem``, moving ``nbytes`` and doing
        ``ops``."""
        with self._lock:
            for rec in self.active:
                row = rec.setdefault(stem, [0, 0.0, 0.0])
                row[0] += 1
                row[1] += nbytes
                row[2] += ops

    def add(self, work: Dict[str, List[float]], times: int = 1) -> None:
        """Add a recorded table ``times`` over (a captured chunk's
        replays)."""
        with self._lock:
            for rec in self.active:
                for stem, (n, b, o) in work.items():
                    row = rec.setdefault(stem, [0, 0.0, 0.0])
                    row[0] += n * times
                    row[1] += b * times
                    row[2] += o * times

    def open(self) -> Dict[str, List[float]]:
        """A new recorder, open until :meth:`close`."""
        rec: Dict[str, List[float]] = {}
        with self._lock:
            self.active = self.active + [rec]
        return rec

    def close(self, rec: Dict[str, List[float]]) -> None:
        with self._lock:
            self.active = [r for r in self.active if r is not rec]

    @contextlib.contextmanager
    def recording(self, exclusive: bool = False):
        """Record the launches noted inside the block → the table.  With
        ``exclusive`` the other recorders see nothing of the block (a
        CUDA-graph capture notes launches that have not run)."""
        rec: Dict[str, List[float]] = {}
        with self._lock:
            prev = self.active
            self.active = [rec] if exclusive else prev + [rec]
        try:
            yield rec
        finally:
            with self._lock:
                self.active = (prev if exclusive else
                               [r for r in self.active if r is not rec])


#: the process-wide ledger the wrappers note their launches' work into
WORK = WorkLedger()


def note_work(stem: str, work) -> None:
    """Note one launch of kernel ``stem`` whose work model ``work()``
    gives (bytes, operations) — evaluated only while a recorder is open."""
    if WORK.active:
        WORK.note(stem, *work())


def on_cpu(x: torch.Tensor) -> bool:
    """Whether a wrapper handed ``x`` runs its kernel's plain twin: exactly
    when ``x`` lies on the CPU.  A CUDA tensor launches the kernel or
    raises; there is no fallback."""
    return x.device.type == "cpu"


def stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, which
    every launch takes (``device`` a ``torch.device``): the raw
    ``cudaStream_t``, read without building a ``torch.cuda.Stream``, which
    cost ~9 us of a launch's host time on an H100 host."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device`` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count

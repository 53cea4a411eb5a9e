"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface; it is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library at first use and loaded with
``ctypes``.  Builds go to ``build/torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the source and of
the shared headers (``csrc/*.cuh``), so an edited kernel or header never
loads a stale library.  Nothing here runs at import:
the CPU tests import every module of the package without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

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

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


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
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built now if needed)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
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

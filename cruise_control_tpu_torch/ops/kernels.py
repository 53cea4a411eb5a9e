"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface; it is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library at first use and loaded with
``ctypes``.  Builds go to ``build/torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the source, so an
edited kernel never loads a stale library.  Nothing here runs at import:
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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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

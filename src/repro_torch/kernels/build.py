"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

into ``build/kernels/<name>-<digest>.so`` under the checkout, at first
use. The digest covers the sources and the flags, so an edited kernel is
rebuilt and a stale library is never loaded. The sources have a plain C
interface (pointers and the stream as ``void*``, each entry point
returning ``cudaGetLastError()``), so a build takes seconds, not the
minutes a file that includes PyTorch's headers would.

All missing libraries are built at once, one ``nvcc`` process per source
started together. Nothing here runs at import: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pairwise_kl", "soft_ce", "neighbor_mean", "neighbor_gather",
           "dequant_kl")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries and their declared entry points, once per process
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels can "
                           "only be built on a machine with the toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source whose library is missing, all at once.

    Returns ``{name: {"seconds": wall time, "log": nvcc's stderr}}`` for
    the sources it built (``-Xptxas -v`` puts registers, shared memory
    and spills there). Raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: Dict[str, tuple] = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    done: Dict[str, dict] = {}
    failed: List[str] = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n"
                          f"{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        done[name] = {"seconds": time.perf_counter() - t0, "log": stderr}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; builds every missing
    source first (in parallel), so the first kernel call pays one build."""
    if name not in _libs:
        if not library_path(name).exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]


def entry(source: str, name: str, n_pointers: int, n_ints: int):
    """The C entry point ``name`` of ``csrc/<source>.cu``: ``n_pointers``
    device pointers, ``n_ints`` ints, then the stream; returns an int
    CUDA error code. Every argtype is declared so ctypes never cuts a
    64-bit pointer to an int."""
    if name not in _entries:
        fn = getattr(load(source), name)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")

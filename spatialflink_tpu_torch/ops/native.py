"""Build and load the port's native libraries: the hand-written CUDA
kernels of ``csrc/`` and the host point ingest ``native/ingest.cpp``.

Each ``csrc/<name>.cu`` exports plain-C launch functions. It is compiled
at first use with ``nvcc`` into ``_build/lib<name>-<hash>.so`` (the hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds) and loaded with :mod:`ctypes`. The host
sources (:data:`HOST_SOURCES`) are built the same way with ``g++``
(:data:`CXX_FLAGS`; their hash also covers the host's platform). Nothing
is built or loaded when this module is imported: the CPU tests import every
module and have no ``nvcc``. Each build keeps the compiler's output beside
the library (``.log``): with ``-Xptxas -v`` it states every kernel's
registers, shared memory and spills, which :func:`ptxas_report` reads.
Concurrent first builds (several test workers) each compile into a file of
their own and ``os.replace`` it into place, so no process loads a
half-written library. A missing compiler or a failed compile raises with
the compiler's output; nothing falls back.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so that no ``a*b+c`` is fused
into an FMA (each operation rounds once, as the plain PyTorch versions'
separate ops do, which makes kernel and plain version agree bit for bit),
and never ``--use_fast_math`` (IEEE division and square root).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pip_dist", "range_mask", "knn_topk", "pip_lattice", "cell_order",
           "geom_dist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: host C++ libraries, built with g++: name -> source
HOST_SOURCES = {"ingest": _PKG / "native" / "ingest.cpp"}
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of spatialflink_tpu_torch are compiled at first use")


def cxx_path() -> str:
    """``g++`` on PATH; raises when there is none."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the native point ingest of "
            "spatialflink_tpu_torch (native/ingest.cpp) is compiled at "
            "first use")
    return cxx


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        key = HOST_SOURCES[name].read_bytes() + " ".join(
            (*CXX_FLAGS, sys.platform, platform.machine())).encode()
    else:
        key = b"".join(p.read_bytes() for p in [
            CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]) + \
            " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        return [cxx_path(), *CXX_FLAGS, "-o", str(out),
                str(HOST_SOURCES[name])]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library in ``names`` (CUDA sources and
    :data:`HOST_SOURCES`) that is not built yet, one compiler process per
    source, all started together. Returns the wall seconds of each compile
    that ran (0.0 for a library already built)."""
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = _command(name, tmp)  # raises before anything is written
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            tool = "g++" if name in HOST_SOURCES else "nvcc"
            failed.append(f"{tool} failed for {name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output of the current build of ``lib<name>`` ("" when it
    was built before logs were kept)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
# "Used 32 registers, used 1 barriers, 8 bytes cumulative stack size, 24724
# bytes smem, ...": the fields between the two vary with the kernel
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:[^\n]*?, (\d+) bytes smem)?")


def _kernel_name(symbol: str) -> str:
    """The ``*_kernel`` name inside an Itanium-mangled symbol (length-
    prefixed names after ``_Z`` / ``_ZN``), with ``<true>`` / ``<false>``
    for a bool template argument; the symbol itself when there is none."""
    i = 3 if symbol.startswith("_ZN") else 2 if symbol.startswith("_Z") \
        else len(symbol)
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while j < len(symbol) and symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
        if name.endswith("_kernel"):
            tmpl = {"ILb1E": "<true>", "ILb0E": "<false>"}.get(
                symbol[i:i + 5], "")
            return name + tmpl
    return symbol


def ptxas_report(log: str) -> list:
    """One entry per kernel of a ``-Xptxas -v`` log: its name, registers
    per thread, static shared memory bytes and spill store / load bytes."""
    rows = []
    parts = _PTXAS_ENTRY.split(log)
    for symbol, body in zip(parts[1::2], parts[2::2]):
        used = _PTXAS_USED.search(body)
        spill = _PTXAS_SPILL.search(body)
        rows.append({
            "kernel": _kernel_name(symbol),
            "registers": int(used.group(1)) if used else None,
            "smem_bytes": int(used.group(2) or 0) if used else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None})
    return rows


def load(name: str) -> ctypes.CDLL:
    """``lib<name>``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def function(name: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int):
    """The C function ``symbol`` of ``lib<name>``, built on first use, with
    its argument types declared (every pointer and the stream as
    ``c_void_p``, or ctypes would pass them as 32-bit ints)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

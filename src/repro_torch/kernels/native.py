"""Build and load the hand-written CUDA libraries in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library that ``ctypes``
loads: a build of seconds, with no PyTorch headers involved.  The build
runs at first use, once per process, under its own lock (region workers
and the bitstream prefetcher may race to it), into ``build/repro_torch/``
at the repository root.  The library file carries a hash of its source,
so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import: importing this module needs no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build-and-load wall time (load only when the library
# file already existed), "log": nvcc output ("" then), "path": the .so}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "repro_torch are built from source at first use")
    return str(path)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {src}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        lib = ctypes.CDLL(str(out))
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log,
                            "path": str(out)}
        _libs[name] = lib
        return lib


class LaunchCounter:
    """Per-body launch counts of one CUDA wrapper.  A wrapper adds one
    where it launches its kernel and nowhere else, so a run can show that
    its main path went through the kernel.  Thread-safe: region workers
    launch concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Counter = Counter()

    def inc(self, key: str):
        with self._lock:
            self._counts[key] += 1

    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._counts[key]

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def reset(self):
        with self._lock:
            self._counts.clear()

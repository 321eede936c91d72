"""Build and load the hand-written CUDA libraries in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library that ``ctypes``
loads: a build of seconds, with no PyTorch headers involved.  The build
runs at first use, once per process, under its own lock (region workers
and the bitstream prefetcher may race to it), into ``build/repro_torch/``
at the repository root.  Each library has its own lock, so
``load_libraries`` runs one ``nvcc`` per source, all at once.  The library
file carries a hash of its source and of the headers it includes, so an
edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import: importing this module needs no CUDA toolkit.

``plain_versions()`` is the one scoped override of the device dispatch:
inside it, the recurrence wrappers (``rglru_scan``, ``rwkv6``) run their
plain PyTorch versions on CUDA tensors too, so a caller can replay the
main path with the yardstick on the card.  It is a context variable: it
holds for the thread (or task) that entered it and nowhere else.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # guards the per-library lock table
_build_locks: Dict[str, threading.Lock] = {}
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


_INCLUDE = re.compile(rb'^#include "([\w.]+)"', re.M)


def _digest(src: Path) -> str:
    """A hash of ``src`` and of the ``csrc`` headers it includes by
    quoted name (device code shared between sources)."""
    h = hashlib.sha256()
    text = src.read_bytes()
    h.update(text)
    for header in _INCLUDE.findall(text):
        h.update((CSRC / header.decode()).read_bytes())
    return h.hexdigest()[:12]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use."""
    with _lock:
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = _digest(src)
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


def load_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build and load several libraries at once, one ``nvcc`` per source
    running in parallel."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        libs = list(pool.map(load_library, names))
    return dict(zip(names, libs))


_plain = contextvars.ContextVar("repro_torch_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run the plain versions on CUDA tensors within this block (and this
    thread) only."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def use_kernel(t) -> bool:
    """Whether a wrapper given tensor ``t`` launches its CUDA kernel: ``t``
    lies on a CUDA device and no ``plain_versions()`` block is open."""
    return t.is_cuda and not _plain.get()


def check_tensor(t, what: str, shape, device, dtype):
    """Raise unless ``t`` is a CUDA tensor on ``device`` of ``dtype`` and
    ``shape`` with unit stride on its last dim: what a kernel that reads
    the other dims by their strides takes."""
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or t.stride(-1) != 1:
        raise ValueError(f"{what} must be {tuple(shape)} with unit stride on "
                         f"the last dim, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


class LaunchCounter:
    """Per-body launch counts of one CUDA wrapper.  A wrapper adds one
    where it launches its kernel and nowhere else, so a run can show that
    its main path went through the kernel.  Thread-safe: region workers
    launch concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Counter = Counter()

    def inc(self, key: str, n: int = 1):
        with self._lock:
            self._counts[key] += n

    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._counts[key]

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def reset(self):
        with self._lock:
            self._counts.clear()

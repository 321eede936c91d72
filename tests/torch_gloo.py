"""Run a worker in ``world`` processes that join one ``gloo`` group.

Shared by the port's multi-process tests (``test_torch_moe_mesh.py``,
``test_torch_dtensor_step.py``).  The ranks meet through a file store in a
directory of the caller's (``init_method="file://..."``), so no port is
chosen before the ranks bind it: a port handed on after its probe socket
closed can be taken by another process meanwhile, and then rank 0 cannot
listen and the others wait for it until the caller's time limit.  gloo's
own connections bind ports the kernel picks.

A worker is the source of a ``python -c`` program; it reads ``rank``,
``world`` and the init method from ``sys.argv[1:4]`` and the caller's
arguments after them.  If a rank fails, the others are stopped at once
rather than left to wait for it.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(code: str, args, workdir, timeout_s: float,
              world: int = 4) -> list:
    """Run ``code`` as ranks 0 .. world - 1 (``python -c code rank world
    init_method *args``) with ``src`` on the path, from the repo root; the
    group's file store and each rank's log go in ``workdir``.  Raises
    ``AssertionError`` with every rank's log tail unless all exit 0 within
    ``timeout_s``; returns the logs."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "rdzv"
    if store.exists():
        store.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    paths = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, path in enumerate(paths):
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(world),
                 store.as_uri(), *map(str, args)], env=env, cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    why = "timed out"
    try:
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if all(rc == 0 for rc in rcs):
                why = None
                break
            if any(rc not in (None, 0) for rc in rcs):
                why = "a rank failed"
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [path.read_text(errors="replace") for path in paths]
    if why is not None:
        raise AssertionError(
            f"{why} after {timeout_s} s or less; exit codes "
            f"{[p.returncode for p in procs]}\n" + "\n".join(
                f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    return logs

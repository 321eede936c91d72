"""``repro_torch.Client`` — the front door of the port.

    with repro_torch.Client(n_regions=2) as client:      # cuda:0
        h = client.launch("MedianBlur", (img, out), H=128, W=128, iters=2)
        ping, pong = h.result(timeout=60)

    repro_torch.Client(n_regions=2, device="cpu")        # plain kernels

``submit(task) -> TaskHandle`` and ``launch(kernel, hittiles, ...)`` bind
to one shell's scheduler.  Token serving (``stream``), multi-shell
clusters (``n_shells > 1``) and the elastic pool come with later slices of
the port and raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence as Seq

from repro_torch.controller.hittile import HitTile
from repro_torch.controller.kernels import get_kernel
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.shell import Shell
from repro_torch.core.task import Task


class Client:
    """Submission facade over one Shell + Scheduler, both owned by the
    Client: ``Shell(n_regions, ...)`` on ``device`` (``None`` = ``cuda:0``;
    raises without CUDA) and a ``Scheduler`` whose ``run_forever`` loop
    runs on a thread of its own."""

    def __init__(self, *, n_regions: int = 2, n_shells: int = 1,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 device=None, **shell_kwargs):
        if n_shells != 1:
            raise NotImplementedError(
                "multi-shell clusters (n_shells > 1) are not ported yet")
        devices = None if device is None else [device]
        self.shell = Shell(n_regions=n_regions, devices=devices,
                           **shell_kwargs)
        try:
            self.scheduler = Scheduler(self.shell, scheduler_config)
        except BaseException:
            self.shell.shutdown()  # a refused config leaks no workers
            raise
        self._loop_thread = threading.Thread(
            target=self.scheduler.run_forever, name="client-scheduler",
            daemon=True)
        self._loop_thread.start()
        if not self.scheduler.wait_until_serving(10.0):
            raise RuntimeError("scheduler loop failed to start")

    # -- task submission -------------------------------------------------
    def submit(self, task: Task):
        """Submit a prepared ``Task``; returns its ``TaskHandle``."""
        return self.scheduler.submit(task)

    def launch(self, kernel: str, hittiles: Seq = (), priority: int = 4,
               tenant: str = "default", **scalars):
        """Build the ``Task`` from a registered kernel's declared argument
        names and submit it immediately."""
        kd = get_kernel(kernel)
        # HitTiles unwrap; raw arrays pass as-is (a numpy array's own
        # ``.data`` is a memoryview, so duck-typing on it is wrong)
        bufs = tuple(h.data if isinstance(h, HitTile) else h
                     for h in hittiles)
        task = Task(kernel=kernel, args=kd.bundle(*bufs, **scalars),
                    priority=priority, tenant=tenant)
        return self.submit(task)

    def stream(self, prompt, params=None, tenant: str = "default",
               **param_kwargs):
        raise NotImplementedError(
            "token serving (Client.stream) is not ported yet")

    # -- observability ---------------------------------------------------
    def report(self) -> dict:
        """The scheduler's versioned report (layer ``scheduler``; see
        ``core/reporting.py``)."""
        return self.scheduler.report()

    # -- lifecycle -------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful stop: finish all submitted tasks, then stop whatever
        this Client owns.  Returns the final report."""
        rep = self.scheduler.drain(timeout)
        self.shell.shutdown()
        return rep if rep is not None else self.report()

    def shutdown(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Stop now: cancel queued work, let running tasks finish, tear
        down owned resources."""
        rep = self.scheduler.shutdown(timeout)
        self.shell.shutdown()
        return rep

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()
        return False

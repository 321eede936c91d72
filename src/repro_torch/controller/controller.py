"""Controller entity — the user-facing host API (paper §3).

.. deprecated::
    ``repro_torch.Client`` is the front door (``submit``/``launch`` for
    tasks, ``stream`` for token serving, one handle API over a shell or an
    elastic pool).  The Controller keeps working as a thin batch shim over
    the same scheduler, but new code should use the Client.

    shell = Shell(n_regions=2)                 # cuda:0; devices=["cpu"]
    ctrl = Controller(shell)
    t = ctrl.launch("MedianBlur", hittiles, H=600, W=600, iters=2, priority=1)
    ctrl.run()          # scheduler main loop over submitted tasks
    ctrl.wait(t)

The Controller hides regions, reconfiguration and context book-keeping; the
scheduler is the FCFS+priorities use case of §4.3 (swappable policy).

A copy of the reference's ``controller/controller.py``.  One difference, as
in the port's ``Client``: ``launch`` unwraps ``HitTile``s only, and passes
any other argument as it is (the reference unwraps anything with a
``.data`` attribute, which for a numpy array is its ``memoryview``).
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, List

from repro_torch.controller.hittile import HitTile
from repro_torch.controller.kernels import get_kernel
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.shell import Shell
from repro_torch.core.submit import TaskHandle
from repro_torch.core.task import Task


class _HandleRegistry(dict):
    """tid -> TaskHandle map whose insertions wake waiters: ``wait()``
    callers racing ``run()`` block on the condition until their task's
    handle is registered, instead of polling (or missing it)."""

    def __init__(self, cv: threading.Condition):
        super().__init__()
        self._cv = cv

    def __setitem__(self, key, value):
        with self._cv:
            super().__setitem__(key, value)
            self._cv.notify_all()


class Controller:
    def __init__(self, shell: Shell, scheduler_config: SchedulerConfig = None):
        warnings.warn(
            "Controller is deprecated; use repro_torch.Client — the "
            "submit/stream facade over shell and pool backends",
            DeprecationWarning, stacklevel=2)
        self.shell = shell
        self.scheduler = Scheduler(shell, scheduler_config)
        self._submitted: List[Task] = []
        # tid -> TaskHandle for everything ever run through this controller
        # (the event-driven wait() target; no status polling anywhere)
        self._cv = threading.Condition()
        self._handles: Dict[int, TaskHandle] = _HandleRegistry(self._cv)

    def launch(self, kernel: str, hittiles=(), priority: int = 4,
               arrival_time: float = 0.0, **scalars) -> Task:
        """Enqueue a kernel-execution task (Controller model: tasks are
        queued, the runtime resolves placement/transfers)."""
        kd = get_kernel(kernel)
        bufs = tuple(h.data if isinstance(h, HitTile) else h
                     for h in hittiles)
        bundle = kd.bundle(*bufs, **scalars)
        task = Task(kernel=kernel, args=bundle, priority=priority,
                    arrival_time=arrival_time)
        self._submitted.append(task)
        return task

    def run(self, quiet: bool = True) -> dict:
        """Run the scheduler over everything submitted so far."""
        tasks, self._submitted = self._submitted, []
        return self.scheduler.run(tasks, quiet=quiet,
                                  handles=self._handles)

    def wait(self, task: Task, timeout: float = 60.0) -> Task:
        """Block until ``task`` settles — event-driven on the task's
        ``TaskHandle`` (a ``threading.Event`` under the hood), no polling
        loop.  Usable from any thread, including while — or just before —
        ``run()`` is blocking in another one: a wait racing ``run()``
        blocks on the handle registration first, then on completion.
        ``TimeoutError`` if the task has not settled (or was never run)
        within ``timeout``."""
        deadline = time.perf_counter() + timeout
        with self._cv:
            if not self._cv.wait_for(lambda: task.tid in self._handles,
                                     timeout=timeout):
                raise TimeoutError(task)
            handle = self._handles[task.tid]
        if not handle.wait(max(0.0, deadline - time.perf_counter())):
            raise TimeoutError(task)
        return task

    def shutdown(self):
        self.shell.shutdown()

"""Online admission layer: thread-safe task submission + completion futures.

The paper's evaluation hands the scheduler the whole workload up front
(``tasks_to_arrive``); a server cannot.  ``SubmissionQueue`` is the
thread-safe front door — any client thread calls
``Scheduler.submit(task)`` and gets back a ``TaskHandle`` future it can
wait on, poll, or cancel while the task is still queued.  The scheduler's
event loop ingests submissions at each iteration (a wakeup callback pokes
the interrupt controller so a sleeping loop reacts immediately).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

from repro_torch.core.task import Task, TaskStatus

# statuses from which a cancel is still possible (not yet claimed by a region)
_CANCELLABLE = (TaskStatus.PENDING, TaskStatus.QUEUED, TaskStatus.PREEMPTED)


class CancelledError(RuntimeError):
    """The task was cancelled before it ran."""


class TaskFailedError(RuntimeError):
    """The task (or the scheduler serving it) failed permanently."""


class MigratedError(RuntimeError):
    """The task was handed off to another shell (cluster migration); this
    local handle is finished, the cluster-level handle stays live."""


class TaskHandle:
    """Future for one submitted task.

    - ``result(timeout)`` blocks until the task completes and returns its
      output buffers (``Task.result``); raises ``CancelledError`` /
      ``TaskFailedError`` / ``TimeoutError``.
    - ``status`` is the live ``TaskStatus``.
    - ``cancel()`` succeeds only while the task is still queued (never
      dispatched, or preempted and back in a queue).
    """

    def __init__(self, task: Task):
        self.task = task
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancelled = False
        self._claimed = False
        self._migrated = False
        self._exception: Optional[BaseException] = None

    # -- client side -----------------------------------------------------
    @property
    def status(self) -> TaskStatus:
        return self.task.status

    def done(self) -> bool:
        return self._done.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def migrated(self) -> bool:
        return self._migrated

    def cancel(self) -> bool:
        with self._lock:
            if self._done.is_set() or self._claimed:
                return False
            if self.task.status not in _CANCELLABLE:
                return False
            self._cancelled = True
            self.task.status = TaskStatus.CANCELLED
            self._done.set()
            return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"task #{self.task.tid} not done within {timeout}s "
                f"(status={self.task.status.value})")
        if self._cancelled:
            raise CancelledError(f"task #{self.task.tid} was cancelled")
        if self._migrated:
            raise MigratedError(
                f"task #{self.task.tid} migrated to another shell; wait on "
                f"the cluster handle instead")
        if self._exception is not None:
            raise TaskFailedError(
                f"task #{self.task.tid} failed") from self._exception
        return self.task.result

    # -- scheduler side --------------------------------------------------
    def _claim(self) -> bool:
        """Atomically take the task for dispatch; refuses if a concurrent
        ``cancel()`` won the race."""
        with self._lock:
            if self._cancelled:
                return False
            self._claimed = True
            return True

    def _back_to_queue(self) -> bool:
        """Atomically transition the task (back) to QUEUED for admission or
        re-enqueue; refuses — without touching the status — if a concurrent
        ``cancel()`` already resolved the handle."""
        with self._lock:
            if self._cancelled:
                return False
            self._claimed = False
            self.task.status = TaskStatus.QUEUED
            return True

    def _resolve(self):
        self._done.set()

    def _migrate_out(self) -> bool:
        """Scheduler side: the cluster frontend took this task for a
        cross-shell migration.  The local handle resolves (neither
        stranded nor cancelled); liveness continues on the cluster
        handle."""
        with self._lock:
            if self._done.is_set():
                return False
            self._migrated = True
            self._done.set()
            return True

    def _fail(self, exc: BaseException):
        with self._lock:
            if self._done.is_set():
                return
            self._exception = exc
            self._done.set()


class SubmissionQueue:
    """Thread-safe staging area between client threads and the event loop.

    ``submit`` may be called from any thread; ``drain_new`` is called by
    the scheduler loop only.  ``close`` rejects further submissions (used
    by ``Scheduler.drain``/``shutdown``).
    """

    def __init__(self, wakeup: Optional[Callable[[], None]] = None):
        self._lock = threading.Lock()
        self._items: deque = deque()
        self._open = True
        self._wakeup = wakeup

    def submit(self, task: Task) -> TaskHandle:
        handle = TaskHandle(task)
        with self._lock:
            if not self._open:
                raise RuntimeError(
                    "submission queue is closed (scheduler draining)")
            self._items.append((task, handle))
        if self._wakeup is not None:
            self._wakeup()
        return handle

    def drain_new(self) -> List[Tuple[Task, TaskHandle]]:
        with self._lock:
            out = list(self._items)
            self._items.clear()
        return out

    def close(self):
        with self._lock:
            self._open = False

    def reopen(self):
        """A new scheduler loop is starting: accept submissions again."""
        with self._lock:
            self._open = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return not self._open

    def empty(self) -> bool:
        with self._lock:
            return not self._items

    def __len__(self):
        with self._lock:
            return len(self._items)

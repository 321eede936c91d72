"""Interrupt controller + select() analogue (paper §4.1/4.2, Algorithm 1).

Region workers post events (kernel completion, preemption-save done, region
failure, chunk heartbeats) to a single queue; the scheduler's
``WaitForInterrupt`` blocks on it with a timeout equal to the next simulated
task arrival — exactly the paper's select()-with-timer loop, without any
busy polling.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional


class EventKind(Enum):
    TASK_DONE = "task_done"
    TASK_PREEMPTED = "task_preempted"
    RECONFIG_DONE = "reconfig_done"
    REGION_FAILED = "region_failed"
    HEARTBEAT = "heartbeat"


@dataclass
class Event:
    kind: EventKind
    region_id: int
    task: Any = None
    payload: Any = None
    t: float = field(default_factory=time.perf_counter)


class InterruptController:
    def __init__(self):
        self._q: "queue.Queue[Event]" = queue.Queue()

    def raise_interrupt(self, ev: Event):
        self._q.put(ev)

    def wait(self, timeout: Optional[float]) -> Optional[Event]:
        """select(): returns an Event, or None on timeout (= next arrival)."""
        try:
            if timeout is not None and timeout <= 0:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> list:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

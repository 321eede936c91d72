"""Tasks and their lifecycle (paper §4.3).

A Task is one request to run a registered kernel with given arguments at a
given priority.  Tasks are pre-generated with random arrival times for the
scheduler experiments (exactly the paper's evaluation harness), or submitted
live through the Controller API.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

N_PRIORITIES = 5  # paper: "we choose to use 5 different priorities"


class TaskStatus(Enum):
    PENDING = "pending"      # generated, not yet arrived
    QUEUED = "queued"        # in a priority queue
    RECONFIGURING = "reconf"  # region being partially reconfigured for it
    RUNNING = "running"
    PREEMPTED = "preempted"  # context saved, waiting in queue again
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"  # cancelled via TaskHandle while still queued


_ids = itertools.count()


@dataclass
class Task:
    kernel: str                   # registered kernel name
    args: Any                     # ArgBundle (uniform ABI)
    priority: int = N_PRIORITIES - 1  # 0 = most urgent
    arrival_time: float = 0.0     # seconds from scheduler start
    # EDF policy: absolute deadline in seconds from scheduler start
    # (same clock as arrival_time); None = background, no deadline.
    deadline_s: Optional[float] = None
    # WFQ policy + per-tenant metrics: which tenant submitted this task.
    tenant: str = "default"
    # placement constraint (DESIGN.md §6.2): minimum region width (devices)
    # this task needs.  None = inherit the kernel's declared
    # ``KernelDef.footprint`` at admission (default 1).
    footprint: Optional[int] = None
    # serving phase tag (DESIGN.md §9): "prefill" | "decode" | None.  The
    # token-serving engine tags its tasks so phase-aware routing (cluster)
    # and disaggregated region pinning can tell the two bitstream kinds
    # apart without parsing kernel names.
    phase: Optional[str] = None
    # hard placement pin: region ids this task may run on (None = any).
    # Pins are shell-local (rids), so they do NOT survive cross-shell
    # migration — the cluster clone drops them.
    region_pin: Optional[frozenset] = None
    # per-task chunk-budget override (None = region/kernel default).  The
    # region resolves it freshly at EVERY launch and uploads the scalar by
    # value, so a task requeued with a different remaining budget after a
    # preemption provably re-uploads — never reuses a stale scalar.
    chunk_budget: Optional[int] = None
    # deterministic preemption hook for the megakernel engine (tests, the
    # serving preempt probe, the overhead bench): the next megakernel
    # launch of this task writes this value into its preempt flag before
    # dispatch — the device exits at exactly this chunk boundary — and
    # clears the field (one-shot).  Ignored by the sync/pipelined engines.
    preempt_at_boundary: Optional[int] = None
    # the Sequence this task serves, if any (serving engine back-reference;
    # opaque to the scheduler)
    sequence: Any = None
    tid: int = field(default_factory=lambda: next(_ids))
    status: TaskStatus = TaskStatus.PENDING
    # context of a preempted task (host-side committed copy)
    saved_context: Any = None
    # bookkeeping for the paper's metrics
    t_arrived: Optional[float] = None
    t_first_served: Optional[float] = None
    t_done: Optional[float] = None
    n_preemptions: int = 0
    n_reconfigs: int = 0
    n_migrations: int = 0
    run_s: float = 0.0            # accumulated on-region execution time
    # stamped by the scheduler at completion (deadline_s is relative to the
    # serving run's start, so it cannot be recomputed after that run ends)
    deadline_missed: bool = False
    region_history: list = field(default_factory=list)
    # rid of the region the scheduler last dispatched this task to (loop
    # thread only).  Repair's dropped-command requeue keys on it: a task
    # already re-dispatched to another region must not be requeued again.
    last_dispatched_rid: Optional[int] = None

    @property
    def service_time(self) -> Optional[float]:
        """Paper metric (i): arrival -> first execution start."""
        if self.t_arrived is None or self.t_first_served is None:
            return None
        return self.t_first_served - self.t_arrived

    @property
    def turnaround(self) -> Optional[float]:
        if self.t_arrived is None or self.t_done is None:
            return None
        return self.t_done - self.t_arrived

    def __repr__(self):
        return (f"Task(#{self.tid} {self.kernel} prio={self.priority} "
                f"{self.status.value})")


def generate_random_tasks(rng, kernels: list, n_tasks: int, rate_T: float,
                          arg_factory, n_priorities: int = N_PRIORITIES,
                          tenants: Optional[list] = None,
                          deadline_slack: Optional[tuple] = None
                          ) -> list[Task]:
    """Paper §4.3: pre-generate ``tasks_to_arrive`` ordered by random arrival
    time ~ U(0, T), random priority, random kernel, random args.

    ``rate_T`` is in seconds here (the paper uses minutes at its scale).
    ``arg_factory(rng, kernel_name)`` builds the ArgBundle.

    ``tenants`` (optional) assigns each task a tenant round-robin;
    ``deadline_slack=(lo, hi)`` (optional) sets ``deadline_s`` to
    ``arrival + U(lo, hi)``.  Both default to off and draw nothing from
    ``rng`` when off, so existing seeded streams are unchanged.
    """
    tasks = []
    for i in range(n_tasks):
        k = kernels[int(rng.integers(len(kernels)))]
        t = Task(
            kernel=k,
            args=arg_factory(rng, k),
            priority=int(rng.integers(n_priorities)),
            arrival_time=float(rng.uniform(0.0, rate_T)),
        )
        if tenants:
            t.tenant = tenants[i % len(tenants)]
        if deadline_slack is not None:
            lo, hi = deadline_slack
            t.deadline_s = t.arrival_time + float(rng.uniform(lo, hi))
        tasks.append(t)
    tasks.sort(key=lambda t: t.arrival_time)
    return tasks

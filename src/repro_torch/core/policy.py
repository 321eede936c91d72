"""Pluggable scheduling policies (the queue discipline of paper §4.3 as a
free variable).

The paper's Algorithm 1 hardwires FCFS within 5 static priorities; related
work treats the discipline itself as an extension point (arXiv 2301.07615)
or schedules against per-task budgets (arXiv 2311.11015).  This module
factors the discipline out of the event loop: the ``Scheduler`` owns
admission and dispatch mechanics, a ``SchedulingPolicy`` owns *which* task
runs next, *which* running task to preempt, and *which* queued tasks are
worth warming bitstreams for.

Policies:

- ``FcfsPriority`` — the paper's exact semantics (default): strict priority
  levels, FCFS by arrival time within a level, preemption only of strictly
  lower-priority running tasks.
- ``EarliestDeadlineFirst`` — dispatch by ``Task.deadline_s`` (seconds from
  scheduler start, ``None`` = background/+inf); preempts the running task
  with the latest deadline when it is strictly later than the candidate's.
- ``WeightedFairShare`` — per-``Task.tenant`` virtual-time fairness (start-
  time fair queuing over a per-dispatch quantum): the backlogged tenant with
  the smallest virtual time is served next, so one tenant flooding the queue
  cannot starve the others.  Preemption keeps the paper's strict-priority
  rule (fairness is enforced at dispatch, urgency at preemption).

All policy structures use deques / heaps / index cursors — no O(n) head
pops on the dispatch hot path.
"""
from __future__ import annotations

import bisect
import heapq
import itertools
import math
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.task import Task, TaskStatus

POLICY_NAMES = ("fcfs", "edf", "wfq")


def region_fits(task: Task, region) -> bool:
    """Placement feasibility (DESIGN.md §6.2): the region's device slice
    must be at least as wide as the task's resource footprint, and the
    region must be in the task's pin set when one is declared (the
    serving engine's prefill/decode disaggregation pins each phase to its
    own regions — DESIGN.md §9)."""
    pin = getattr(task, "region_pin", None)
    if pin is not None and region.rid not in pin:
        return False
    need = getattr(task, "footprint", None) or 1
    devs = getattr(region, "devices", None)
    capacity = len(devs) if devs is not None else 1
    return need <= capacity


def pick_region(task: Task, idle_regions: Sequence, affinity: bool = True):
    """First idle region the task *fits on* (footprint <= region width),
    preferring one whose loaded bitstream already matches ``task`` (exactly
    the seed scheduler's affinity rule).  ``None`` when no idle region is
    wide enough — the caller may try a different task."""
    best = None
    for r in idle_regions:
        if task is not None and not region_fits(task, r):
            continue
        if (affinity and task is not None
                and r.loaded == (task.kernel, task.args.signature(),
                                 r.geometry)):
            return r
        if best is None:
            best = r
    return best


class _FifoQueue:
    """Arrival-ordered FIFO with an amortised-O(1) head pop.

    Replaces the seed's ``list`` + ``q.pop(0)``: the head is an index
    cursor, compacted occasionally, so popping never shifts the whole
    queue.  Inserts stay ``bisect.insort`` by arrival time (a re-enqueued
    preempted task keeps its original arrival slot — seed semantics).
    Cancelled tasks are dropped lazily at peek time.
    """

    __slots__ = ("_items", "_head")

    def __init__(self):
        self._items: List[Task] = []
        self._head = 0

    def push(self, task: Task):
        bisect.insort(self._items, task, lo=self._head,
                      key=lambda t: t.arrival_time)

    def _compact(self):
        if self._head > 32 and self._head * 2 >= len(self._items):
            del self._items[:self._head]
            self._head = 0

    def peek(self) -> Optional[Task]:
        while self._head < len(self._items):
            t = self._items[self._head]
            if t.status is TaskStatus.CANCELLED:
                self._head += 1
                self._compact()
                continue
            return t
        return None

    def pop(self) -> Optional[Task]:
        t = self.peek()
        if t is not None:
            self._head += 1
            self._compact()
        return t

    def remove(self, task: Task) -> bool:
        """Remove a specific task (identity comparison — Task's generated
        ``==`` would compare numpy payloads); order is preserved."""
        for i in range(self._head, len(self._items)):
            if self._items[i] is task:
                del self._items[i]
                return True
        return False

    def iter_live(self):
        """Lazy iteration over non-cancelled tasks (prefetch peeks stop
        after k tasks without materialising the queue)."""
        for i in range(self._head, len(self._items)):
            t = self._items[i]
            if t.status is not TaskStatus.CANCELLED:
                yield t

    def live(self) -> List[Task]:
        return list(self.iter_live())

    def __len__(self):
        return len(self._items) - self._head


class SchedulingPolicy:
    """Protocol for queue disciplines.  The scheduler calls:

    - ``enqueue(task)``        — task admitted (or re-admitted) to the queue
    - ``select(idle_regions)`` — pick ``(task, region)`` to dispatch now,
      or ``None``; the returned task is removed from the policy's queues
    - ``choose_victim(candidate, running)`` — region to preempt so that
      blocked ``candidate`` can run, or ``None``; ``running`` preserves
      shell region order and excludes dead/preempt-pending regions
    - ``peek_for_prefetch(k)`` — up to ``k`` queued tasks in likely dispatch
      order (bitstream-warming hints; must not mutate the queues)
    - ``on_requeue(task)``     — a preempted/migrated task coming back
    - ``on_task_done(task)``   — completion callback (accounting)
    """

    name = "base"
    affinity = True  # seed bitstream-affinity dispatch rule

    def enqueue(self, task: Task) -> None:
        raise NotImplementedError

    def select(self, idle_regions: Sequence) -> Optional[Tuple[Task, object]]:
        raise NotImplementedError

    def choose_victim(self, candidate: Task,
                      running: Sequence) -> Optional[object]:
        raise NotImplementedError

    def peek_for_prefetch(self, k: int) -> List[Task]:
        raise NotImplementedError

    def peek_same_bitstream(self, matches, region, window: int,
                            max_skip_wait_s: Optional[float] = None
                            ) -> Optional[Task]:
        """Same-bitstream coalescing lookahead (DESIGN.md §8.3): a queued
        task for which ``matches(task)`` is true (same executable key as
        the region's loaded bitstream) and which fits ``region``, reachable
        within ``window`` queue positions *without bending the policy's
        cross-class semantics* — strict priority order for fcfs, deadline
        order for edf, tenant fairness for wfq.  Only the order *within*
        one equivalence class (level / background set / tenant FIFO) may be
        bent, bounded by ``window`` — the serving analogue of continuous
        batching.  ``max_skip_wait_s`` is the starvation bound: a match
        must never jump a skipped fitting task whose queue wait already
        exceeds it (a coalesced stream would otherwise renew the skip
        forever).  Must not mutate the queues; the scheduler removes the
        returned task with ``take``.  Default: no coalescing."""
        return None

    def take(self, task: Task) -> bool:
        """Remove a specific queued task (returned by
        ``peek_same_bitstream``) from the policy's queues, applying the
        same accounting ``select`` would (e.g. wfq virtual-time charge).
        False if the task is no longer queued."""
        return False

    def on_requeue(self, task: Task) -> None:
        self.enqueue(task)

    def on_task_done(self, task: Task) -> None:
        pass

    # -- queue introspection (event loop + checkpointing) ----------------
    def pending_tasks(self) -> List[Task]:
        raise NotImplementedError

    def has_pending(self) -> bool:
        return bool(self.pending_tasks())

    def preempt_candidates(self) -> List[Task]:
        """Blocked queue heads that may justify a preemption, most urgent
        first.  Default: the overall dispatch head."""
        head = self.peek_for_prefetch(1)
        return head[:1]


class FcfsPriority(SchedulingPolicy):
    """Paper Algorithm 1: strict priorities, FCFS by arrival within each.

    Reproduces the seed scheduler bit-for-bit: same dispatch order, same
    affinity rule, same one-preemption-attempt-per-priority-level with the
    least-urgent strictly-lower-priority victim.
    """

    name = "fcfs"

    def __init__(self, n_priorities: int):
        self.n_priorities = n_priorities
        self._queues = [_FifoQueue() for _ in range(n_priorities)]

    def enqueue(self, task: Task) -> None:
        self._queues[task.priority].push(task)

    def select(self, idle_regions):
        for q in self._queues:
            t = q.peek()
            if t is None:
                continue
            region = pick_region(t, idle_regions, self.affinity)
            if region is None:
                # head blocked on placement (no idle region wide enough):
                # FIFO within the level is preserved, lower levels may run
                continue
            q.pop()
            return t, region
        return None

    def choose_victim(self, candidate, running):
        # seed `_find_lower_priority_victim`: first region carrying the
        # numerically-largest (least urgent) strictly-lower priority
        best, best_prio = None, candidate.priority
        for r in running:
            t = r.current_task
            if t is not None and t.priority > best_prio:
                best, best_prio = r, t.priority
        return best

    def preempt_candidates(self):
        # seed `_serve`: one attempt per non-empty priority level, in order
        out = []
        for q in self._queues:
            t = q.peek()
            if t is not None:
                out.append(t)
        return out

    def peek_for_prefetch(self, k):
        out = []
        for q in self._queues:
            for t in q.iter_live():
                out.append(t)
                if len(out) >= k:
                    return out
        return out

    def peek_same_bitstream(self, matches, region, window,
                            max_skip_wait_s=None):
        # strict priority is never bent: scan levels top-down and stop at
        # the first level owning a task that fits this region.  Within that
        # level, a same-bitstream task up to ``window`` positions deep may
        # jump the (same-priority) FIFO — the continuous-batching move.  A
        # level whose window holds no region-fitting task is skipped, the
        # same placement rule ``select`` applies to blocked heads.  A jump
        # is REFUSED once any skipped fitting task is already starving
        # (queue wait beyond ``max_skip_wait_s``): a steady same-bitstream
        # stream would otherwise coalesce past that head indefinitely.
        now = time.perf_counter() if max_skip_wait_s is not None else 0.0
        for q in self._queues:
            fitting_seen = False
            starving_skipped = False
            for i, t in enumerate(q.iter_live()):
                if i >= window:
                    break
                if not region_fits(t, region):
                    continue
                if matches(t):
                    if starving_skipped:
                        return None  # the starving head dispatches first
                    return t
                fitting_seen = True
                if (max_skip_wait_s is not None and t.t_arrived is not None
                        and now - t.t_arrived > max_skip_wait_s):
                    starving_skipped = True
            if fitting_seen:
                return None  # this level's head must dispatch normally
        return None

    def take(self, task):
        return self._queues[task.priority].remove(task)

    def pending_tasks(self):
        return [t for q in self._queues for t in q.live()]

    def has_pending(self):
        return any(q.peek() is not None for q in self._queues)


def _deadline_key(task: Task) -> Tuple[float, float]:
    d = task.deadline_s if task.deadline_s is not None else math.inf
    return (d, task.arrival_time)


class EarliestDeadlineFirst(SchedulingPolicy):
    """Dispatch the queued task whose deadline expires soonest.

    ``Task.deadline_s`` is seconds from scheduler start (same clock as
    ``arrival_time``); tasks without a deadline run as background (+inf).
    Preempts the running task with the *latest* deadline when the blocked
    candidate's deadline is strictly earlier.
    """

    name = "edf"

    def __init__(self):
        self._heap: List[Tuple[float, float, int, Task]] = []
        self._seq = itertools.count()

    def enqueue(self, task: Task) -> None:
        d, a = _deadline_key(task)
        heapq.heappush(self._heap, (d, a, next(self._seq), task))

    def _drop_cancelled(self):
        while self._heap and (self._heap[0][3].status
                              is TaskStatus.CANCELLED):
            heapq.heappop(self._heap)

    def select(self, idle_regions):
        self._drop_cancelled()
        if not self._heap:
            return None
        task = self._heap[0][3]
        region = pick_region(task, idle_regions, self.affinity)
        if region is not None:
            heapq.heappop(self._heap)
            return task, region
        # head blocked on placement: O(n) scan for the earliest-deadline
        # task that fits an idle region (rare — only wide-footprint heads)
        best_i = None
        for i, e in enumerate(self._heap):
            if e[3].status is TaskStatus.CANCELLED:
                continue
            if best_i is not None and e[:3] >= self._heap[best_i][:3]:
                continue
            if pick_region(e[3], idle_regions, self.affinity) is not None:
                best_i = i
        if best_i is None:
            return None
        entry = self._remove_at(best_i)
        return entry[3], pick_region(entry[3], idle_regions, self.affinity)

    def _remove_at(self, i: int):
        """Swap-and-pop removal of heap entry ``i`` (re-heapify if the
        moved tail landed mid-heap)."""
        entry = self._heap[i]
        self._heap[i] = self._heap[-1]
        self._heap.pop()
        if i < len(self._heap):
            heapq.heapify(self._heap)
        return entry

    def choose_victim(self, candidate, running):
        # qualification is on the deadline ALONE and strict — equal
        # deadlines (notably two background tasks, both +inf) must never
        # churn a context save just to swap equivalents
        cd = (candidate.deadline_s if candidate.deadline_s is not None
              else math.inf)
        best, best_key = None, None
        for r in running:
            t = r.current_task
            if t is None:
                continue
            td = t.deadline_s if t.deadline_s is not None else math.inf
            if td <= cd:
                continue
            key = (td, t.arrival_time)  # latest deadline, latest arrival
            if best_key is None or key > best_key:
                best, best_key = r, key
        return best

    def peek_for_prefetch(self, k):
        # exact k earliest deadlines.  Deliberate trade-off: a heap gives
        # no useful prefix bound for the k smallest (the k-th can sit at
        # index 2^k-1), so this pays O(n log k) per refresh rather than
        # warm the WRONG bitstreams and eat cold compiles on dispatch.
        live = (e for e in self._heap
                if e[3].status is not TaskStatus.CANCELLED)
        return [e[3] for e in heapq.nsmallest(k, live)]

    def peek_same_bitstream(self, matches, region, window,
                            max_skip_wait_s=None):
        # deadline order is never bent: a match qualifies only when every
        # region-fitting task ahead of it (earlier deadline) is background
        # (``deadline_s is None`` sorts to +inf, so in practice only
        # background tasks can be jumped by other background tasks — a
        # deadline-bearing task is never skipped for a coalescing win).
        live = (e for e in self._heap
                if e[3].status is not TaskStatus.CANCELLED)
        now = (time.perf_counter() if max_skip_wait_s is not None else 0.0)
        ahead_has_deadline = False
        starving_skipped = False
        for e in heapq.nsmallest(window, live):
            t = e[3]
            if not region_fits(t, region):
                continue
            if matches(t):
                if ahead_has_deadline or starving_skipped:
                    return None
                return t
            if t.deadline_s is not None:
                ahead_has_deadline = True
            if (max_skip_wait_s is not None and t.t_arrived is not None
                    and now - t.t_arrived > max_skip_wait_s):
                starving_skipped = True
        return None

    def take(self, task):
        for i, e in enumerate(self._heap):
            if e[3] is task:
                self._remove_at(i)
                return True
        return False

    def pending_tasks(self):
        return [e[3] for e in self._heap
                if e[3].status is not TaskStatus.CANCELLED]

    def has_pending(self):
        self._drop_cancelled()
        return bool(self._heap)


class WeightedFairShare(SchedulingPolicy):
    """Per-tenant start-time fair queuing: the backlogged tenant with the
    smallest virtual time is served next; each dispatch advances the
    tenant's clock by ``quantum / weight``.  FIFO within a tenant.

    A tenant going from idle to backlogged is caught up to the minimum
    backlogged virtual time, so sitting out never banks credit and a
    flooding tenant can never starve a light one.
    """

    name = "wfq"

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 quantum: float = 1.0):
        self.weights = dict(weights or {})
        self.quantum = quantum
        self._queues: Dict[str, deque] = {}
        self._vt: Dict[str, float] = {}
        # global virtual clock: the start tag of the last dispatch.  A
        # tenant joining (or returning) is floored to it, so time spent
        # idle — or with all its tasks momentarily in service — never
        # banks credit against tenants that kept consuming.
        self._vclock = 0.0

    def _weight(self, tenant: str) -> float:
        w = self.weights.get(tenant, 1.0)
        if w <= 0:
            raise ValueError(f"tenant {tenant!r} weight must be > 0, got {w}")
        return w

    def _backlogged(self) -> List[str]:
        out = []
        for tenant, q in self._queues.items():
            while q and q[0].status is TaskStatus.CANCELLED:
                q.popleft()
            if q:
                out.append(tenant)
        return out

    def enqueue(self, task: Task) -> None:
        tenant = task.tenant
        q = self._queues.get(tenant)
        newly_backlogged = q is None or not q
        if q is None:
            q = self._queues[tenant] = deque()
        q.append(task)
        if newly_backlogged:
            self._vt[tenant] = max(self._vt.get(tenant, 0.0), self._vclock)

    def select(self, idle_regions):
        # tenants in virtual-time order; a tenant whose head task cannot be
        # placed (footprint too wide for every idle region) is skipped this
        # round without burning its virtual time
        for tenant in sorted(self._backlogged(),
                             key=lambda t: (self._vt.get(t, 0.0), t)):
            task = self._queues[tenant][0]
            region = pick_region(task, idle_regions, self.affinity)
            if region is None:
                continue
            self._queues[tenant].popleft()
            start = self._vt.get(tenant, 0.0)
            self._vclock = max(self._vclock, start)
            self._vt[tenant] = start + self.quantum / self._weight(tenant)
            return task, region
        return None

    def choose_victim(self, candidate, running):
        # urgency stays priority-driven (paper rule); ties broken toward
        # the tenant furthest ahead of its fair share
        best, best_key = None, None
        for r in running:
            t = r.current_task
            if t is None or t.priority <= candidate.priority:
                continue
            key = (t.priority, self._vt.get(t.tenant, 0.0))
            if best_key is None or key > best_key:
                best, best_key = r, key
        return best

    def preempt_candidates(self):
        out = []
        for tenant in sorted(self._backlogged(),
                             key=lambda t: (self._vt.get(t, 0.0), t)):
            out.append(self._queues[tenant][0])
        return out

    def peek_for_prefetch(self, k):
        out = []
        order = sorted(self._backlogged(),
                       key=lambda t: (self._vt.get(t, 0.0), t))
        cursors = {t: 0 for t in order}
        while len(out) < k and order:
            progressed = False
            for tenant in list(order):
                q = self._queues[tenant]
                i = cursors[tenant]
                while i < len(q) and q[i].status is TaskStatus.CANCELLED:
                    i += 1
                if i < len(q):
                    out.append(q[i])
                    cursors[tenant] = i + 1
                    progressed = True
                    if len(out) >= k:
                        break
                else:
                    order.remove(tenant)
            if not progressed:
                break
        return out

    def peek_same_bitstream(self, matches, region, window,
                            max_skip_wait_s=None):
        # tenant fairness is never bent: only the tenant whose turn it is
        # (minimum virtual time — exactly who ``select`` would serve) may
        # coalesce, and ``take`` charges its virtual clock like any other
        # dispatch.  Only that tenant's own FIFO is bent, window-bounded,
        # and never past a starving same-tenant head (the fcfs rule).
        backlogged = self._backlogged()
        if not backlogged:
            return None
        tenant = min(backlogged, key=lambda t: (self._vt.get(t, 0.0), t))
        now = (time.perf_counter() if max_skip_wait_s is not None else 0.0)
        n = 0
        starving_skipped = False
        for t in self._queues[tenant]:
            if t.status is TaskStatus.CANCELLED:
                continue
            if n >= window:
                break
            n += 1
            if region_fits(t, region):
                if matches(t):
                    return None if starving_skipped else t
                if (max_skip_wait_s is not None and t.t_arrived is not None
                        and now - t.t_arrived > max_skip_wait_s):
                    starving_skipped = True
        return None

    def take(self, task):
        q = self._queues.get(task.tenant)
        if q is None:
            return False
        for i, t in enumerate(q):
            if t is task:
                del q[i]
                break
        else:
            return False
        start = self._vt.get(task.tenant, 0.0)
        self._vclock = max(self._vclock, start)
        self._vt[task.tenant] = start + self.quantum / self._weight(
            task.tenant)
        return True

    def pending_tasks(self):
        return [t for q in self._queues.values() for t in q
                if t.status is not TaskStatus.CANCELLED]

    def has_pending(self):
        return bool(self._backlogged())


def make_policy(name: str, *, n_priorities: int,
                tenant_weights: Optional[Dict[str, float]] = None
                ) -> SchedulingPolicy:
    """Build a policy by registry name; unknown names raise ``ValueError``."""
    key = (name or "").lower()
    if key == "fcfs":
        return FcfsPriority(n_priorities)
    if key == "edf":
        return EarliestDeadlineFirst()
    if key == "wfq":
        return WeightedFairShare(weights=tenant_weights)
    raise ValueError(
        f"unknown scheduling policy {name!r}; known: {', '.join(POLICY_NAMES)}")

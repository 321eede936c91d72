"""Reconfigurable Region (paper §4.1-4.2).

Each region is treated as an independent accelerator: its own command queue
and manager thread (the Controller queue-per-device structure), its own
context bank (BRAM analogue), and a bound chunk entry ("bitstream").
Reconfiguration requests are internal tasks in the same queue, scheduled
before the associated kernel launch — exactly §4.2.

On a CUDA device a region is a **CUDA stream** that time-shares the card
with the other regions (the reference's single-device ``allow_overlap``
regime).  The worker thread issues every launch of its tasks under
``torch.cuda.stream(region.stream)``; tensors never cross to another
region's stream except through the host (``Committed.materialize``).

Preemption is cooperative-chunked: the worker checks the preempt flag
between chunks, saves the context+payload through the double-buffered bank,
and raises a TASK_PREEMPTED interrupt.  Chunk control runs on the host, so
a chunk's ``done`` is known as soon as its launches are issued; the event
recorded after them says when the device has finished them.

The region runs one of two engine modes:

- ``sync`` — wait for each chunk's event before issuing the next: the
  bit-identity reference;
- ``pipelined`` — keep one more chunk in flight while the oldest one's
  event resolves, polling ``Event.query()`` with backoff, so the device
  never idles across a chunk boundary waiting on the host.  The chunk entry
  is done-gated to identity, so the one speculative chunk issued beyond
  completion launches nothing and results stay bit-identical.

The reference's third mode, ``megakernel``, comes with a later slice of
the port.  Context and payload buffers stay device-resident across chunks
and across preempt/resume on the same region; the host copy of a
preemption commit is produced lazily, only when a cross-region resume
needs host bytes.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional, Tuple

import torch

from repro_torch.controller.kernels import get_kernel
from repro_torch.core.context import ContextBank, ContextRecord, Committed
from repro_torch.core.interrupts import Event, EventKind, InterruptController
from repro_torch.core.reconfig import ReconfigEngine
from repro_torch.core.task import Task, TaskStatus

# host-side wait while a chunk's event resolves: bounded exponential
# backoff instead of a fixed-interval busy-poll — a long chunk no longer
# burns a host core, while the floor keeps short chunks prompt.  The device
# is busy with the speculative chunk during this wait, so the interval only
# bounds preempt/failure *response* latency, never throughput.
_POLL_MIN_S = 5e-6
_POLL_MAX_S = 1e-3

ENGINE_MODES = ("sync", "pipelined", "megakernel")


def check_engine_mode(mode: str) -> str:
    if mode not in ENGINE_MODES:
        raise ValueError(f"unknown engine mode {mode!r}; "
                         f"known: {ENGINE_MODES}")
    if mode == "megakernel":
        raise NotImplementedError(
            "engine='megakernel' (one persistent launch per task polling a "
            "mapped preempt flag) comes with a later slice of the port; use "
            "'pipelined' or 'sync'")
    return mode


class _HostDone:
    """A chunk's completion snapshot on the CPU, where its work already ran
    by the time the chunk returns."""

    def query(self) -> bool:
        return True

    def synchronize(self):
        pass


class RegionState(Enum):
    """Region lifecycle.  ACTIVE regions accept dispatches; a DRAINING
    region finishes (or is checkpoint-preempted off) its current work but
    receives nothing new.  ``repair()`` revives a failed region back to
    ACTIVE.  RETIRED (terminal) is entered by the elastic pool, which
    comes with a later slice of the port."""
    ACTIVE = "active"
    DRAINING = "draining"
    RETIRED = "retired"


@dataclass
class RegionStats:
    chunks: int = 0
    kernels_run: int = 0
    reconfigs: int = 0
    preemptions: int = 0
    chunk_ewma_s: float = 0.0
    busy_s: float = 0.0
    reconfig_s: float = 0.0  # wall time this region spent reconfiguring
    chunks_pipelined: int = 0   # chunks issued while a predecessor resolved
    chunks_discarded: int = 0   # speculative identity chunks past done
    host_spills_avoided: int = 0  # device-resident resumes (no host copy)
    # which body the last kernel-library-bearing bitstream runs: "cuda"
    # (the hand-written kernel) or "torch" (its plain version, CPU only);
    # None until one loads — benches read it so a CPU number is never
    # taken for a kernel number
    kernel_mode: Optional[str] = None


class Region:
    def __init__(self, rid: int, engine: ReconfigEngine,
                 interrupts: InterruptController, *, devices,
                 geometry: Tuple[int, ...] = (1,),
                 chunk_budget: Optional[int] = None,
                 engine_mode: str = "pipelined"):
        self.rid = rid
        self.engine = engine
        self.interrupts = interrupts
        self.devices = list(devices)
        self.device = torch.device(self.devices[0])
        # the region's own stream on the shared card; None on the CPU
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self.geometry = geometry
        self.chunk_budget = chunk_budget
        self.engine_mode = check_engine_mode(engine_mode)
        self.bank = ContextBank()
        self.loaded: Optional[tuple] = None  # (kernel, sig, geometry)
        self.executable = None
        self.stats = RegionStats()
        self.current_task: Optional[Task] = None
        self.state = RegionState.ACTIVE

        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._inflight = 0  # commands enqueued but not fully processed
        # one lock serializes posting/draining commands and the inflight
        # count, so repair() can drain-and-reject atomically
        self._inflight_lock = threading.Lock()
        self._preempt = threading.Event()
        self._failed = threading.Event()
        self._stop = threading.Event()
        self.slowdown_s: float = 0.0  # straggler-injection test hook
        # test/bench hook: called as on_chunk(region, task) on the worker
        # thread after each retired chunk (deterministic preemption points)
        self.on_chunk: Optional[Callable[["Region", Task], None]] = None
        self._thread: Optional[threading.Thread] = None
        self.start()

    # ------------------------------------------------------------------
    def start(self):
        self._stop.clear()
        self._failed.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"region-{self.rid}", daemon=True)
        self._thread.start()

    def shutdown(self):
        self._stop.set()
        self._q.put(("noop", None))  # wake the blocked worker
        if self._thread:
            self._thread.join(timeout=5)

    # -- commands (the per-region Controller queue) ---------------------
    def _post(self, cmd: str, task):
        with self._inflight_lock:
            self._inflight += 1
            self._q.put((cmd, task))

    def _dec(self):
        with self._inflight_lock:
            self._inflight -= 1

    def enqueue_reconfig(self, task: Task):
        self._post("reconfig", task)

    def enqueue_launch(self, task: Task):
        self._post("launch", task)

    def request_preempt(self):
        self._preempt.set()

    def cancel_preempt(self):
        self._preempt.clear()

    def inject_failure(self):
        """Kill this region (node failure simulation)."""
        self._failed.set()

    def begin_drain(self):
        """Stop accepting dispatches; the current task still finishes or
        is checkpoint-preempted off."""
        if self.state is RegionState.ACTIVE:
            self.state = RegionState.DRAINING

    def repair(self) -> list:
        """Bring the region back.  Its bank survives.  Returns the tasks of
        any ``launch`` commands still queued when the dead worker was
        restarted: they were dispatched but never ran, so the caller must
        requeue them."""
        if self.state is RegionState.RETIRED:
            raise RuntimeError(
                f"region {self.rid} is retired; add a new region instead")
        revived_state = (self.state if self.state is RegionState.DRAINING
                         else RegionState.ACTIVE)
        if self._thread and self._thread.is_alive():
            # failure injected while the worker idled: just lift the flag
            self._failed.clear()
            self.state = revived_state
            return []
        self.state = revived_state
        self.loaded = None
        self.executable = None
        self.current_task = None
        dropped = []
        with self._inflight_lock:
            while True:
                try:
                    dropped.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._inflight = 0
        self.start()
        return [t for (cmd, t) in dropped
                if cmd == "launch" and t is not None]

    @property
    def idle(self) -> bool:
        with self._inflight_lock:
            return self._inflight == 0

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._failed.is_set())

    @property
    def dispatchable(self) -> bool:
        """Eligible for new work: alive and not draining/retired."""
        return self.alive and self.state is RegionState.ACTIVE

    # ------------------------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            cmd, task = self._q.get()
            if cmd == "noop":
                continue
            try:
                try:
                    if cmd == "reconfig":
                        self._do_reconfig(task)
                    elif cmd == "launch":
                        self._do_launch(task)
                finally:
                    self._dec()
            except RegionFailure:
                self.interrupts.raise_interrupt(Event(
                    EventKind.REGION_FAILED, self.rid, task=task))
                return  # thread dies; scheduler handles re-enqueue
            except Exception as e:  # the worker boundary: report, then die
                import traceback

                traceback.print_exc()
                task.status = TaskStatus.FAILED
                self.current_task = None
                self.interrupts.raise_interrupt(Event(
                    EventKind.REGION_FAILED, self.rid, task=task, payload=e))
                return

    def _check_failure(self):
        if self._failed.is_set():
            raise RegionFailure()

    def _do_reconfig(self, task: Task):
        self._check_failure()
        key = (task.kernel, task.args.signature(), self.geometry)
        if self.loaded == key:
            return
        task.status = TaskStatus.RECONFIGURING
        fn, dt = self.engine.load(task.kernel, task.args, self.geometry,
                                  self.devices)
        self.loaded = key
        self.executable = fn
        self.stats.reconfigs += 1
        self.stats.reconfig_s += dt
        if get_kernel(task.kernel).library is not None:
            self.stats.kernel_mode = ("cuda" if self.device.type == "cuda"
                                      else "torch")
        task.n_reconfigs += 1
        self.interrupts.raise_interrupt(Event(
            EventKind.RECONFIG_DONE, self.rid, task=task, payload=dt))

    # -- device plumbing --------------------------------------------------
    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _record(self):
        """Completion snapshot of everything issued on this region so far."""
        if self.stream is None:
            return _HostDone()
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def _upload(self, b):
        """A private device copy of a host buffer (the chunk writes its
        payload in place, so the bundle's own buffer must stay intact for
        a post-failure re-dispatch)."""
        return torch.as_tensor(b).to(self.device, copy=True)

    def _prepare(self, task: Task):
        """Initial (ctx, bufs) for a launch, on this region's stream.

        - fresh launch: copy the argument buffers to the device;
        - resume on the *same* region: the committed payload never left
          device memory — clone it on this stream (the bank keeps the
          committed copy for failure recovery) and skip the host round trip;
        - resume on a *different* region: materialize the committed host
          copy (which waits for the producing stream) and upload it here —
          the only place the spill actually happens.
        """
        saved: Optional[Committed] = task.saved_context
        bufs_np, _, _ = task.args.padded()
        if saved is None:
            return ContextRecord.fresh(), tuple(self._upload(b)
                                                for b in bufs_np)
        task.saved_context = None
        if saved.device and saved.owner is self:
            self.stats.host_spills_avoided += 1
            if saved.payload is not None:
                return saved.context, tuple(b.clone() for b in saved.payload)
            return saved.context, tuple(self._upload(b) for b in bufs_np)
        host = saved.materialize()
        payload = host.payload if host.payload is not None else bufs_np
        return host.context, tuple(self._upload(b) for b in payload)

    def _wait_ready(self, snapshot, abort_on_preempt: bool):
        """Wait for a chunk's event with bounded exponential backoff.
        Returns early when the region fails or, if ``abort_on_preempt``,
        when a preempt request needs the host loop's attention."""
        delay = _POLL_MIN_S
        while not snapshot.query():
            if self._failed.is_set():
                return
            if abort_on_preempt and self._preempt.is_set():
                return
            time.sleep(delay)
            delay = min(delay * 2.0, _POLL_MAX_S)

    def _commit_preempt(self, task: Task, ctx, bufs, t_busy0: float):
        """Preemption tail: lazy-spill commit of the device-resident
        payload (with the event that marks it final), then the
        TASK_PREEMPTED interrupt."""
        self.bank.commit(ctx, payload=bufs, tid=task.tid, device=True,
                         region_rid=self.rid, owner=self,
                         ready=self._record())
        task.saved_context = self.bank.restore()
        task.status = TaskStatus.PREEMPTED
        task.n_preemptions += 1
        self.stats.preemptions += 1
        self.current_task = None
        self.stats.busy_s += time.perf_counter() - t_busy0
        self.interrupts.raise_interrupt(Event(
            EventKind.TASK_PREEMPTED, self.rid, task=task))

    def _finish_done(self, task: Task, bufs, t_busy0: float):
        """Completion tail: host numpy results, copied on this stream (so
        after every launch of the task)."""
        task.status = TaskStatus.DONE
        task.t_done = time.perf_counter()
        task.result = tuple(b.cpu().numpy() for b in bufs[:2])
        self.stats.kernels_run += 1
        self.current_task = None
        self.stats.busy_s += time.perf_counter() - t_busy0
        self.interrupts.raise_interrupt(Event(
            EventKind.TASK_DONE, self.rid, task=task))

    # -- the chunk-pipelined execution hot path -------------------------
    def _do_launch(self, task: Task):
        self._check_failure()
        with self._on_stream():
            self._launch(task)

    def _launch(self, task: Task):
        kd = get_kernel(task.kernel)
        budget = task.chunk_budget or self.chunk_budget or kd.default_budget
        _, ints, floats = task.args.padded()  # memoized host scalars
        ctx, bufs = self._prepare(task)

        task.status = TaskStatus.RUNNING
        task.region_history.append(self.rid)
        if task.t_first_served is None:
            task.t_first_served = time.perf_counter()
        self.current_task = task
        t_busy0 = time.perf_counter()
        depth = 1 if self.engine_mode == "pipelined" else 0
        pending: "deque" = deque()  # (done, event) of unretired chunks
        t_last = time.perf_counter()

        def issue():
            nonlocal ctx, bufs
            if pending:  # overlapped with an unresolved predecessor
                self.stats.chunks_pipelined += 1
            ctx, bufs, done = self.executable(ctx, bufs, ints, floats, budget)
            pending.append((done, self._record()))

        def pop() -> int:
            done, ev = pending.popleft()
            ev.synchronize()
            return done

        def retire(done: int):
            """Account one resolved chunk boundary (EWMA, per-task work)."""
            nonlocal t_last
            dt = time.perf_counter() - t_last
            if self.slowdown_s:
                time.sleep(self.slowdown_s)
                dt += self.slowdown_s
            t_last = time.perf_counter()
            a = 0.3
            self.stats.chunk_ewma_s = (
                dt if self.stats.chunks == 0
                else a * dt + (1 - a) * self.stats.chunk_ewma_s)
            self.stats.chunks += 1
            task.run_s += dt  # per-task (and per-tenant) work attribution
            if self.on_chunk is not None:
                self.on_chunk(self, task)
            return done

        def drain() -> int:
            """Resolve every in-flight chunk (blocking): real chunks are
            retired, speculative identity chunks past ``done`` are
            discarded.  Returns whether the task actually finished."""
            done = 0
            while pending:
                v = pop()
                if done:
                    self.stats.chunks_discarded += 1
                else:
                    retire(v)
                    done = v
            return done

        while True:
            self._check_failure()
            if self._preempt.is_set():
                self._preempt.clear()
                if drain():  # completion raced the preempt: task is done
                    break
                self._commit_preempt(task, ctx, bufs, t_busy0)
                return

            # keep the pipeline primed: chunk k+1 is issued before chunk
            # k's event resolves, so the device never idles across a chunk
            # boundary waiting on the host
            while len(pending) < depth + 1:
                issue()

            # pipelined: poll the oldest chunk's event so a preempt/failure
            # request stays prompt during long chunks.  Synchronous (depth
            # 0): block on the event directly.
            if depth:
                self._wait_ready(pending[0][1], abort_on_preempt=True)
                if self._preempt.is_set() or self._failed.is_set():
                    continue  # handled at the loop top

            if retire(pop()):
                # remaining in-flight chunks were done-gated to identity
                self.stats.chunks_discarded += len(pending)
                pending.clear()
                break

        self._finish_done(task, bufs, t_busy0)


class RegionFailure(Exception):
    pass

"""Reconfigurable Region (paper §4.1-4.2).

Each region is treated as an independent accelerator: its own command queue
and manager thread (the Controller queue-per-device structure), its own
context bank (BRAM analogue), and a bound chunk entry ("bitstream").
Reconfiguration requests are internal tasks in the same queue, scheduled
before the associated kernel launch — exactly §4.2.

On a CUDA device a region is a **CUDA stream** that time-shares the card
with the other regions (the reference's single-device ``allow_overlap``
regime).  The worker thread issues every launch of its tasks under
``torch.cuda.stream(region.stream)``; a committed payload crosses to
another region's stream only through the host (``Committed.materialize``).
The results of ``device_result`` kernels stay on the card: each carries the
event recorded after the task's last launch, and a consumer's stream waits
on it before reading (``core/streams.py``).

Preemption is cooperative-chunked: the worker checks the preempt flag
between chunks, saves the context+payload through the double-buffered bank,
and raises a TASK_PREEMPTED interrupt.  Chunk control runs on the host, so
a chunk's ``done`` is known as soon as its launches are issued; the event
recorded after them says when the device has finished them.

The region runs one of three engine modes:

- ``sync`` — wait for each chunk's event before issuing the next: the
  bit-identity reference;
- ``pipelined`` — keep one more chunk in flight while the oldest one's
  event resolves, polling ``Event.query()`` with backoff, so the device
  never idles across a chunk boundary waiting on the host.  The chunk entry
  is done-gated to identity, so the one speculative chunk issued beyond
  completion launches nothing and results stay bit-identical;
- ``megakernel`` — the whole chunk loop of a task in one launch: on the
  card one persistent kernel (the blur tasks' M1) runs every remaining
  chunk with the context on the device and polls the region's mapped
  preempt flag (``core/preemption.PreemptFlag``) at every chunk boundary;
  on the CPU its plain version, a host loop with the same stop rule.  The
  host waits on the launch's event and rebuilds the host record from the
  context words the kernel wrote back.

Context and payload buffers stay device-resident across chunks and across
preempt/resume on the same region; the host copy of a preemption commit
is produced lazily, only when a cross-region resume needs host bytes — a
flag-exited launch feeds the same commit path.

With a tracer or a metrics registry (``Shell(tracer=, metrics=)``) the
region emits the reference's events and instruments: ``reconfig``, ``run``
and ``chunk`` spans, ``mega_launch``, ``preempt_request``,
``preempt_honored``, ``done`` and ``region_failed``, all stamped on the
host clock: the port's ``DESIGN.md``, "What a span covers on the card",
says what each spans.
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
from repro_torch.core.preemption import PreemptFlag
from repro_torch.core.reconfig import ReconfigEngine
from repro_torch.core.streams import mark_ready, wait_ready
from repro_torch.core.task import Task, TaskStatus

# host-side wait while a chunk's (or a megakernel launch's) event resolves:
# bounded exponential backoff instead of a fixed-interval busy-poll — a long
# chunk no longer burns a host core, while the floor keeps short chunks
# prompt.  The device is busy with the speculative chunk (or the launch)
# during this wait, so the interval only bounds preempt/failure *response*
# latency, never throughput.
_POLL_MIN_S = 5e-6
_POLL_MAX_S = 1e-3

ENGINE_MODES = ("sync", "pipelined", "megakernel")


def check_engine_mode(mode: str) -> str:
    if mode not in ENGINE_MODES:
        raise ValueError(f"unknown engine mode {mode!r}; "
                         f"known: {ENGINE_MODES}")
    return mode


class _HostDone:
    """A chunk's completion snapshot on the CPU, where its work already ran
    by the time the chunk returns."""

    def query(self) -> bool:
        return True

    def synchronize(self):
        pass


class RegionState(Enum):
    """Elastic-pool lifecycle.

    ACTIVE regions accept dispatches; a DRAINING region finishes (or is
    checkpoint-preempted off) its current work but receives nothing new; a
    RETIRED region's stream has been synchronised, its worker shut down
    and its devices returned to the floorplanner.  ``repair()`` revives a
    failed region back to ACTIVE; RETIRED is terminal.
    """
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
    megakernel_launches: int = 0  # single-launch task dispatches
    flag_poll_exits: int = 0      # launches that exited on the preempt flag
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
                 engine_mode: str = "pipelined",
                 tracer=None, metrics=None):
        self.rid = rid
        self.engine = engine
        self.interrupts = interrupts
        # flight recorder and live metrics registry (``repro_torch.obs``):
        # None disables each, and every emit site below is guarded to a
        # single None check
        self.tracer = tracer
        self.metrics = metrics
        self._track = ("region", rid)
        self._t_preempt_req: Optional[float] = None
        # the slice may start empty (the pool's placeholder for a carved
        # slice) and is re-cut by replans; device and stream follow it
        self.devices = list(devices)
        self._stream: Optional[torch.cuda.Stream] = None
        if self.devices and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        self.geometry = geometry
        self.chunk_budget = chunk_budget
        self.engine_mode = check_engine_mode(engine_mode)
        # the megakernel's preempt flag, one per region (at most one launch
        # is in flight on a region); a placeholder slice makes it at its
        # first launch
        self.flag: Optional[PreemptFlag] = None
        if self.engine_mode == "megakernel" and self.devices:
            self.flag = PreemptFlag(self.device)
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
        # (megakernel mode: after each chunk of the CPU's plain version; a
        # launch on the card runs its chunks without the host)
        self.on_chunk: Optional[Callable[["Region", Task], None]] = None
        # test/bench hook, megakernel mode: called as on_launch(region,
        # task) on the worker thread just before a launch is issued, once
        # its flag is set
        self.on_launch: Optional[Callable[["Region", Task], None]] = None
        self._thread: Optional[threading.Thread] = None
        self.start()

    @property
    def device(self) -> torch.device:
        """The first device of the region's slice: where its buffers live."""
        return torch.device(self.devices[0])

    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The region's own stream on its card (a placeholder region makes
        it once a replan has given it a slice); None on the CPU."""
        if self._stream is None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

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
        tr = self.tracer
        if tr is not None:
            cur = self.current_task
            tr.emit("preempt_request", self._track,
                    tid=cur.tid if cur is not None else None)
        m = self.metrics
        if m is not None:
            m.counter("preempt_requests_total", region=self.rid).inc()
        if self._t_preempt_req is None:
            # first unhonored request wins: response latency is measured
            # from what a waiting scheduler actually experiences
            self._t_preempt_req = time.perf_counter()
        self._preempt.set()
        if self.flag is not None:
            # the in-flight megakernel launch reads the store at its next
            # chunk boundary and exits there
            self.flag.write(1)

    def cancel_preempt(self):
        self._preempt.clear()
        self._t_preempt_req = None
        if self.flag is not None:
            self.flag.clear()

    def inject_failure(self):
        """Kill this region (node failure simulation)."""
        self._failed.set()
        if self.flag is not None:
            # pop an in-flight megakernel launch at its next chunk boundary,
            # so the failure interrupt is raised within a chunk
            self.flag.write(1)

    def begin_drain(self):
        """Elastic shrink step 1: stop accepting dispatches.  The caller
        (``RegionPool``) preempts the current task and retires the region
        once it is idle."""
        if self.state is RegionState.ACTIVE:
            self.state = RegionState.DRAINING

    def retire(self):
        """Elastic shrink step 2 (terminal): wait for everything issued on
        the region's stream, then shut the worker down.  The caching
        allocator hands a freed block back to its stream's pool at once,
        so the stream must hold no queued launch by then.  The bank keeps
        its commit: a task checkpoint-preempted off this region resumes
        elsewhere through ``materialize()``."""
        self.state = RegionState.RETIRED
        if self._stream is not None:
            self._stream.synchronize()
        self.shutdown()

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

    @property
    def preempt_requested(self) -> bool:
        """A preempt request waits for the running task to honour it."""
        return self._preempt.is_set()

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
                if self.tracer is not None:
                    self.tracer.emit("region_failed", self._track,
                                     tid=task.tid if task else None)
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

    @property
    def program(self) -> str:
        """Which entry point this region's mode needs."""
        return "mega" if self.engine_mode == "megakernel" else "chunk"

    def _do_reconfig(self, task: Task):
        self._check_failure()
        key = (task.kernel, task.args.signature(), self.geometry)
        if self.loaded == key:
            return
        task.status = TaskStatus.RECONFIGURING
        t_rc0 = time.perf_counter()
        fn, dt = self.engine.load(task.kernel, task.args, self.geometry,
                                  self.devices, program=self.program)
        self.loaded = key
        self.executable = fn
        self.stats.reconfigs += 1
        self.stats.reconfig_s += dt
        kd = get_kernel(task.kernel)
        if kd.library is not None or (self.program == "mega"
                                      and kd.mega_library is not None):
            self.stats.kernel_mode = ("cuda" if self.device.type == "cuda"
                                      else "torch")
        task.n_reconfigs += 1
        tr = self.tracer
        if tr is not None:
            tr.emit_span("reconfig", self._track, t_rc0, tid=task.tid,
                         kernel=task.kernel)
        m = self.metrics
        if m is not None:
            m.histogram("region_reconfig_seconds",
                        region=self.rid).observe(dt)
            m.counter("reconfigs_total", region=self.rid).inc()
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
        """A private device copy of a buffer (the chunk writes its payload
        in place, so the bundle's own buffer must stay intact for a
        post-failure re-dispatch).  A device tensor from an earlier task or
        from the engine is copied on this region's stream after its
        producer's event."""
        if isinstance(b, torch.Tensor):
            wait_ready(b, self.stream)
        return torch.as_tensor(b).to(self.device, copy=True)

    def _prepare(self, task: Task):
        """Initial (ctx, bufs) for a launch, on this region's stream.

        - fresh launch: copy the argument buffers to the device (a device
          tensor after its producer's event);
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
        now = time.perf_counter()
        self.stats.busy_s += now - t_busy0
        tr = self.tracer
        if tr is not None:
            tr.emit_span("run", self._track, t_busy0, tid=task.tid)
            tr.emit("preempt_honored", self._track, tid=task.tid)
        m = self.metrics
        if m is not None:
            m.counter("region_run_seconds_total", region=self.rid).inc(
                now - t_busy0)
            m.counter("preemptions_total", region=self.rid).inc()
            t_req = self._t_preempt_req
            if t_req is not None:
                m.histogram("preempt_response_seconds",
                            region=self.rid).observe(
                    max(now - t_req, 0.0), t=now)
        self._t_preempt_req = None
        self.interrupts.raise_interrupt(Event(
            EventKind.TASK_PREEMPTED, self.rid, task=task))

    def _finish_done(self, task: Task, kd, bufs, t_busy0: float):
        """Completion tail.  ``device_result`` kernels hand every buffer
        back on the card, marked with the event recorded after the task's
        last launch; the others get their first two buffers as host numpy,
        copied on this stream (so after every launch of the task).  The
        status turns DONE only once the result is in place: a caller that
        polls the status finds the result set."""
        task.t_done = time.perf_counter()
        if kd.device_result:
            mark_ready(bufs, self._record())
            task.result = tuple(bufs)
        else:
            task.result = tuple(b.cpu().numpy() for b in bufs[:2])
        task.status = TaskStatus.DONE
        self.stats.kernels_run += 1
        self.current_task = None
        now = time.perf_counter()
        self.stats.busy_s += now - t_busy0
        tr = self.tracer
        if tr is not None:
            tr.emit_span("run", self._track, t_busy0, tid=task.tid)
            tr.emit("done", self._track, tid=task.tid)
        m = self.metrics
        if m is not None:
            m.counter("region_run_seconds_total", region=self.rid).inc(
                now - t_busy0)
            m.counter("kernels_run_total", region=self.rid).inc()
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
        if self.engine_mode == "megakernel":
            self._launch_megakernel(task, kd, budget, ints, floats, ctx, bufs,
                                    t_busy0)
            return
        depth = 1 if self.engine_mode == "pipelined" else 0
        pending: "deque" = deque()  # (done, event) of unretired chunks
        t_last = time.perf_counter()

        def issue():
            nonlocal ctx, bufs
            if pending:  # overlapped with an unresolved predecessor
                self.stats.chunks_pipelined += 1
            ctx, bufs, done = self.executable(ctx, bufs, ints, floats, budget)
            pending.append((done, self._record()))

        tr = self.tracer

        def pop() -> int:
            done, ev = pending.popleft()
            ev.synchronize()
            return done

        def retire(done: int):
            """Account one resolved chunk boundary (EWMA, per-task work)."""
            nonlocal t_last
            t_prev = t_last
            dt = time.perf_counter() - t_last
            if self.slowdown_s:
                time.sleep(self.slowdown_s)
                dt += self.slowdown_s
            t_last = time.perf_counter()
            if tr is not None:
                # traced before on_chunk, so a hook that preempts at this
                # boundary finds the chunk already on the timeline
                tr.emit("chunk", self._track, tid=task.tid,
                        t=t_prev, dur=dt)
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

        self._finish_done(task, kd, bufs, t_busy0)

    # -- the megakernel execution hot path --------------------------------
    def _launch_megakernel(self, task: Task, kd, budget: int, ints, floats,
                           ctx, bufs, t_busy0: float):
        """ONE launch runs every remaining chunk: it re-reads the region's
        preempt flag at each chunk boundary and exits there when it fires.
        ``done == 0`` after it is exactly "the flag fired mid-task": the
        partial context feeds the same commit path a host-driven
        preemption uses, bit-identically to the sync/pipelined engines
        stopping at the same boundary."""
        if self.flag is None:
            self.flag = PreemptFlag(self.device)
        flag = self.flag
        if self._preempt.is_set():
            # a preempt request that lands before dispatch commits the
            # prepared state as-is (zero chunks ran; resume restarts from
            # the same boundary)
            self._preempt.clear()
            flag.clear()
            self._commit_preempt(task, ctx, bufs, t_busy0)
            return
        arm = task.preempt_at_boundary
        if arm is not None:
            task.preempt_at_boundary = None  # one-shot: consumed at launch
            flag.write(int(arm))
        else:
            # a stale flag value must not preempt this launch; re-assert
            # after clearing in case request_preempt raced the clear (its
            # event store precedes its flag store, so the recheck sees it)
            flag.clear()
            if self._preempt.is_set():
                flag.write(1)
        if self.on_launch is not None:
            self.on_launch(self, task)
        hook = self.on_chunk
        after_chunk = (None if hook is None
                       else lambda: hook(self, task))
        t0 = time.perf_counter()
        launch = self.executable(ctx, bufs, ints, floats, budget, flag,
                                 after_chunk=after_chunk)
        self.stats.megakernel_launches += 1
        # the whole loop is in flight on the card; the host only waits for
        # its event.  A failure injected mid-flight pops the launch through
        # the flag, so this wait stays bounded by one chunk, then surfaces
        # through _check_failure below
        delay = _POLL_MIN_S
        while not launch.query():
            if self._failed.is_set() and flag.read() == 0:
                flag.write(1)
            time.sleep(delay)
            delay = min(delay * 2.0, _POLL_MAX_S)
        self._check_failure()
        ctx, bufs, k = launch.result()
        dt = time.perf_counter() - t0
        if k:
            per = dt / k
            a = 0.3
            self.stats.chunk_ewma_s = (
                per if self.stats.chunks == 0
                else a * per + (1 - a) * self.stats.chunk_ewma_s)
        self.stats.chunks += k
        task.run_s += dt
        tr = self.tracer
        if tr is not None:
            tr.emit("mega_launch", self._track, tid=task.tid,
                    t=t0, dur=dt, n_chunks=k, done=int(ctx.done))
        if not ctx.done:
            # the launch exited on the flag at a chunk boundary
            self.stats.flag_poll_exits += 1
            self._preempt.clear()
            flag.clear()
            self._commit_preempt(task, ctx, bufs, t_busy0)
            return
        flag.clear()
        self._finish_done(task, kd, bufs, t_busy0)


class RegionFailure(Exception):
    pass

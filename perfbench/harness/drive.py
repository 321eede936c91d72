"""Run one cell once: set the system up, offer the mix's load for the
window, wait for the answers sent in it, and record what happened.

The system under test is ``repro_torch.Client``, built from the
configuration's ``client`` entry: blur tasks go through ``Client.launch``,
from client threads of this process.  Set-up is everything before the
window opens: imports, the client, the frame pools, and one request of
every shape the mix sends, which builds and loads every kernel library the
window will use.
"""
from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from perfbench.harness import devtrace, traffic

WAIT_PAST_CLOSE_S = 60.0      # an answer sent in the window may come this late
TRACE_CAPACITY = 1 << 21      # the program's flight recorder, traced runs


@dataclass
class BlurRecord:
    req: traffic.BlurRequest
    t_send: float
    t_done: Optional[float] = None
    ok: bool = False
    image: Optional[np.ndarray] = None   # kept for the check
    error: str = ""


@dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device_kind: str = "cpu"
    setup_s: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    t_wait_end: float = 0.0
    frames: Dict[int, list] = field(default_factory=dict, repr=False)
    blur: List[BlurRecord] = field(default_factory=list)
    events: list = field(default_factory=list)     # the program's trace
    dev: Optional[devtrace.DeviceTrace] = None
    memory_peak_bytes: int = 0

    @property
    def config(self) -> dict:
        return self.cell.config

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 <= t < self.t1

    def sent(self) -> list:
        """Requests sent inside the window."""
        return [r for r in self.blur if self.in_window(r.t_send)]


class _Window:
    """The client threads of one run."""

    def __init__(self, run: Run, client, streams, frames, zeros):
        self.run, self.client, self.streams = run, client, streams
        self.frames, self.zeros = frames, zeros
        self.go = threading.Event()
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.threads: List[threading.Thread] = []

    def _next(self, stream):
        with self.lock:
            return next(stream.deck)

    def _blur(self, req: traffic.BlurRequest, t_send: float):
        rec = BlurRecord(req, t_send)
        h = self.client.launch(req.kernel, (self.frames[req.px][req.frame],
                                            self.zeros[req.px]),
                               priority=req.priority, H=req.px, W=req.px,
                               iters=req.iters)
        self.run.blur.append(rec)
        return rec, h

    def _finish_blur(self, rec: BlurRecord, h):
        try:
            ping, pong = h.result(timeout=self._left())
        except Exception as exc:  # noqa: BLE001 - a failed answer is counted
            rec.error = repr(exc)
            return
        rec.t_done = time.perf_counter()
        rec.ok = True
        if rec.req.keep:
            rec.image = pong if rec.req.iters % 2 else ping
        # the scheduler keeps every finished Task; drop its copy of the
        # result so a long window does not pin two frames a task on the host
        h.task.result = None

    def _left(self) -> float:
        return max(1.0, self.run.t1 + WAIT_PAST_CLOSE_S - time.perf_counter())

    def blur_closed(self, stream):
        self.go.wait()
        while not self.stop.is_set():
            req = self._next(stream)
            rec, h = self._blur(req, time.perf_counter())
            self._finish_blur(rec, h)

    def start(self):
        for s in self.streams:
            for c in range(s.clients):
                t = threading.Thread(target=self.blur_closed, args=(s,),
                                     daemon=True,
                                     name=f"perfbench-{s.kind}-{c}")
                t.start()
                self.threads.append(t)

    def join(self):
        """Wait for every client thread, at most until ``WAIT_PAST_CLOSE_S``
        past the close."""
        deadline = self.run.t1 + WAIT_PAST_CLOSE_S
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))


def _warm_up(client, streams, frames, zeros):
    """One request of every shape the mix sends."""
    shapes = sorted({(k, int(n), int(px)) for s in streams
                     for k, n in s.spec["kernels"]
                     for px in s.spec["frame_px"]})
    for kernel, iters, px in shapes:
        h = client.launch(kernel, (frames[px][0], zeros[px]), priority=4,
                          H=px, W=px, iters=iters)
        h.result(timeout=600)
        h.task.result = None


def run_cell(cell, seed: int, seconds: float, trace: bool, device=None,
             t_start: Optional[float] = None) -> Run:
    """Set up, measure ``seconds``, wait for what was sent, shut the system
    down.  ``device`` None is ``cuda:0``; ``"cpu"`` runs the plain kernels
    (tests).  ``t_start`` is when set-up began (default: now)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed, seconds, trace)
    on_card = device is None
    if on_card:
        run.device_kind = torch.cuda.get_device_name(0)
    streams = traffic.build(cell.mix, seed)
    frames = traffic.frame_pools(seed, streams)
    run.frames = frames
    zeros = {px: np.zeros_like(pool[0]) for px, pool in frames.items()}

    tracer = None
    if trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(capacity=TRACE_CAPACITY)
    import repro_torch

    client = repro_torch.Client(device=device, tracer=tracer,
                                **cell.config["client"])
    prof = None
    tmp = None
    try:
        _warm_up(client, streams, frames, zeros)
        if on_card:
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - t_start

        win = _Window(run, client, streams, frames, zeros)
        win.start()
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        with (torch.profiler.record_function(devtrace.WINDOW) if trace
              else contextlib.nullcontext()):
            run.t0 = time.perf_counter()
            run.t1 = run.t0 + seconds
            win.go.set()
            time.sleep(max(0.0, run.t1 - time.perf_counter()))
            win.stop.set()
        if prof is not None:
            if on_card:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            tmp = tempfile.NamedTemporaryFile(suffix=".json", delete=False)
            tmp.close()
            prof.export_chrome_trace(tmp.name)
            prof = None
        win.join()
        run.t_wait_end = time.perf_counter()
        if on_card:
            torch.cuda.synchronize()
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        if tracer is not None:
            run.events = tracer.events()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        client.shutdown()
    del client
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if tmp is not None:
        try:
            run.dev = devtrace.read_chrome_trace(tmp.name)
        finally:
            os.unlink(tmp.name)
    return run

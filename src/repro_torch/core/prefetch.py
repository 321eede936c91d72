"""Asynchronous bitstream prefetcher (paper §4.2 / §6.3).

The scheduler feeds it hints when tasks enter the priority queues; a
background thread generates the corresponding bitstreams (kernel library
build + chunk-entry binding)
through ``ReconfigEngine.prefetch`` *off the dispatch path*, so by the time
a region is reconfigured for the task the bitstream is already in the LRU
cache and the load costs only the ICAP transfer.  This is the mechanism
that keeps regions busy during reconfiguration — the paper's low-overhead
headline depends on it.

A hint is dropped as *stale* when its task has already left the queues
(dispatched, preempted-and-gone, done, failed) by the time the prefetcher
gets to it: compiling a bitstream nobody will load wastes the compile
bandwidth the next queued task needs.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Optional

from repro_torch.core.reconfig import ReconfigEngine
from repro_torch.core.task import Task, TaskStatus

# statuses under which a queued task still wants its bitstream
_WANTED = (TaskStatus.PENDING, TaskStatus.QUEUED)


@dataclass
class PrefetchRequest:
    kernel: str
    bundle: object           # ArgBundle
    geometry: tuple
    task: Optional[Task] = None


@dataclass
class PrefetcherStats:
    submitted: int = 0
    processed: int = 0
    dropped_full: int = 0    # hint queue overflow (bounded lookahead)


class BitstreamPrefetcher:
    """Background thread turning queue-lookahead hints into warm bitstreams.

    ``max_queue`` bounds the lookahead window; overflowing hints are dropped
    (the scheduler will simply cold-compile those if they ever dispatch).
    ``auto_start=False`` keeps the thread off so tests can call
    ``drain_once`` deterministically.
    """

    def __init__(self, engine: ReconfigEngine, max_queue: int = 64,
                 auto_start: bool = True):
        self.engine = engine
        # which program kind to warm ("chunk" | "mega"): the shell sets it
        # from its engine mode so prefetched bitstreams hit the same cache
        # entry its regions will load
        self.program = "chunk"
        self.stats = PrefetcherStats()
        self._q: "queue.Queue[PrefetchRequest]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._pending = 0          # submitted, not yet fully processed
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self.start()

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="bitstream-prefetcher", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if not t.is_alive():  # keep tracking a worker stuck in a long
                self._thread = None  # compile: it exits at the next check

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------------
    def submit(self, task: Task, geometries: Iterable[tuple]):
        """Hint: ``task`` just entered a priority queue; warm its bitstream
        for every distinct region geometry it could land on."""
        for geom in dict.fromkeys(tuple(g) for g in geometries):
            req = PrefetchRequest(task.kernel, task.args, geom, task)
            with self._cv:
                try:
                    self._q.put_nowait(req)
                except queue.Full:
                    self.stats.dropped_full += 1
                    continue
                self.stats.submitted += 1
                self._pending += 1

    def _finish_one(self):
        with self._cv:
            self._pending -= 1
            self.stats.processed += 1
            self._cv.notify_all()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every submitted hint has been processed (tests and
        benchmarks use this to make prefetch effects deterministic)."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0,
                                     timeout=timeout)

    # ------------------------------------------------------------------
    def _process(self, req: PrefetchRequest):
        def still_wanted() -> bool:
            return req.task is None or req.task.status in _WANTED

        try:
            self.engine.prefetch(req.kernel, req.bundle, req.geometry,
                                 still_wanted=still_wanted,
                                 program=self.program)
        except Exception:  # pragma: no cover - a broken hint must not
            import traceback  # kill the prefetcher; the demand path will

            traceback.print_exc()  # surface the same error loudly
        finally:
            self._finish_one()

    def drain_once(self):
        """Synchronously process everything currently queued (test hook —
        usable whether or not the thread runs)."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            self._process(req)

    def _run(self):
        while not self._stop.is_set():
            try:
                req = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._process(req)

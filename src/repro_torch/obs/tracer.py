"""Bounded ring-buffer flight recorder.

Design constraints (DESIGN.md §11):

- **Zero cost when disabled.**  Layers hold an ``Optional[Tracer]`` and
  guard every emit with ``if tr is not None``; the disabled path is one
  attribute read + a None check, with no call, no allocation.
- **Lock-cheap when enabled.**  An emit is a tuple build plus a
  ``deque.append`` under one uncontended lock (~sub-microsecond), against
  chunk granularity of tens-to-hundreds of microseconds.  The lock also
  guards snapshots: mutating a deque while ``list()`` iterates it raises
  ``RuntimeError``, and emits arrive from region worker threads, the
  scheduler loop thread, probe threads, and client threads concurrently.
- **Bounded.**  The ring is a ``deque(maxlen=capacity)``; overflow drops
  the *oldest* events (the tail of a run matters most for postmortems)
  and is accounted in ``dropped`` rather than silently ignored.
- **Monotonic clock.**  All timestamps are ``time.perf_counter()`` — the
  same clock every latency number in the repo already uses — so trace
  events and ``report()`` walls are directly comparable.  ``t0`` is
  recorded at construction for export-time normalization.

A copy of the reference's ``repro.obs.tracer``, behaviour unchanged;
"DESIGN.md" section references point at the reference's note at the
repository root.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple, Optional


class TraceEvent(NamedTuple):
    """One recorded event.

    ``t`` is the event time for instants (``dur == 0.0``) or the *start*
    time for spans (``dur > 0``), in ``perf_counter`` seconds.  ``track``
    identifies the timeline row as ``(kind, instance)`` — e.g.
    ``("region", 0)``, ``("icap", 0)``, ``("sched", 0)``, ``("cluster", 0)``,
    ``("serving", 0)``, ``("slot", 3)``.  ``tid`` is the task / sequence id
    the event belongs to (None for region-global events like resizes).
    """

    t: float
    kind: str
    track: tuple
    tid: Optional[int]
    dur: float
    attrs: Optional[dict]


class Tracer:
    """Thread-safe bounded recorder of :class:`TraceEvent`s."""

    DEFAULT_CAPACITY = 65536

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.t0 = time.perf_counter()
        self._ring = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.n_emitted = 0

    # -- recording ---------------------------------------------------------

    def emit(self, kind: str, track: tuple, /, tid: Optional[int] = None,
             t: Optional[float] = None, dur: float = 0.0, **attrs) -> None:
        """Record one event.  ``t`` defaults to *now* (instants).

        ``kind`` and ``track`` are positional-only so an attr that happens
        to share their name (e.g. ``kind="grow"``) lands in ``attrs``
        instead of raising ``TypeError: multiple values for argument``.
        Attrs named ``tid``/``t``/``dur`` still bind to the parameters —
        pick different attr names for those.
        """
        ev = TraceEvent(t if t is not None else time.perf_counter(),
                        kind, track, tid, dur, attrs or None)
        with self._lock:
            self._ring.append(ev)
            self.n_emitted += 1

    def emit_span(self, kind: str, track: tuple, t_start: float, /,
                  tid: Optional[int] = None, t_end: Optional[float] = None,
                  **attrs) -> None:
        """Record a span from ``t_start`` to ``t_end`` (default *now*)."""
        end = t_end if t_end is not None else time.perf_counter()
        self.emit(kind, track, tid=tid, t=t_start,
                  dur=max(end - t_start, 0.0), **attrs)

    # -- inspection --------------------------------------------------------

    def events(self) -> "list[TraceEvent]":
        """Consistent snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    @property
    def dropped(self) -> int:
        """Events lost to ring overflow (oldest-first eviction)."""
        with self._lock:
            return self.n_emitted - len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.n_emitted = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Tracer(capacity={self.capacity}, recorded={len(self)}, "
                f"dropped={self.dropped})")

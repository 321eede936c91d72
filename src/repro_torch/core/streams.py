"""Stream ordering of device results.

Regions are CUDA streams that time-share the card, and the serving engine
works on its thread's current stream.  A tensor written on one stream and
read on another needs an edge between the two: the producer records an
event after its last write (``mark_ready``), and every consumer makes its
own stream wait on that event before reading (``wait_ready``), or waits on
the host before copying to it (``to_host``).  A consumer stream also
``record_stream``s the tensor, so the caching allocator does not hand its
memory to new work before the consumer's reads have run.

The event rides on the tensor itself (views made later do not carry it:
wait on the base tensor first).  On the CPU nothing is marked and nothing
waits, because host code runs in program order.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

_READY = "_repro_ready_event"


def mark_ready(tensors: Iterable, event) -> None:
    """Attach ``event`` (recorded after the last write) to every CUDA tensor
    in ``tensors``; anything else is skipped."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            setattr(t, _READY, event)


def record_ready(tensors: Iterable, device) -> None:
    """Record an event on ``device``'s current stream and mark ``tensors``
    with it: the caller has just written them there."""
    tensors = [t for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda]
    if tensors:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        mark_ready(tensors, ev)


def wait_ready(t, stream=None):
    """Order ``stream`` (default: the current stream of ``t``'s device)
    after ``t``'s producer and keep ``t``'s memory until the stream's work
    on it has run.  Returns ``t``."""
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        return t
    stream = stream if stream is not None else torch.cuda.current_stream(
        t.device)
    ev = getattr(t, _READY, None)
    if ev is not None:
        stream.wait_event(ev)
    t.record_stream(stream)
    return t


def to_host(t) -> np.ndarray:
    """Host numpy copy of a (possibly device-resident) result, read after
    its producer's event."""
    if isinstance(t, torch.Tensor):
        ev = getattr(t, _READY, None)
        if ev is not None:
            ev.synchronize()
        return t.detach().cpu().numpy()
    return np.asarray(t)

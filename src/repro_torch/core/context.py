"""Kernel context — the paper's ``struct context`` (Listing 1.3), verbatim
fields, kept on the HOST:

    struct context { int var[N]; int init_var[N]; int incr_var[N];
                     int saved[N]; int valid; }

plus three runtime scalars: ``done`` (kernel finished), ``budget`` (chunk
iteration budget — the cooperative-preemption analogue of the asynchronous
RR reset) and ``intr`` (set when a ``for_save`` loop was cut short by the
budget; lets enclosing loops distinguish "inner loop completed exactly at
the budget boundary" from "inner loop interrupted" — without it the
nested-loop resume can livelock).

The reference traces every field as an i32 device array under
``lax.while_loop``.  Every value that loop control branches on is a
context field, an int argument or a static shape — never payload data — so
the port keeps the record on the host: the arrays are int32 numpy of length
``N_CTX`` and the scalars are Python ints.  Chunk control therefore never
synchronises the GPU, and every field equals the reference's after every
chunk.  A megakernel launch on the card takes the record by value as
``CTX_WORDS`` int32 words (``to_words``), runs its chunks with the words
on the device, and the host record is rebuilt from the words it writes
back (``from_words``).

``ContextRecord`` is a pytree node (``torch.utils._pytree``) whose children
are its fields in ``_FIELDS`` order as int32 numpy, the reference's leaves;
rebuilt from them, its scalars come back as Python ints.  That is how a
commit crosses the checkpoint store (``repro_torch.ckpt``).

``ContextBank`` keeps the committed copy with the paper's ``valid``-flag
protocol realized as a double-buffered commit: a crash or preemption
*during* a save leaves the previous buffer valid.

``KVBlockPool`` is the serving path's page accounting, a copy of the
reference's (``repro/core/context.py``), behaviour unchanged.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

N_CTX = 8  # compile-time N of the paper's prototype ("up to N integers")

_FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done",
           "budget", "intr")
_ARRAYS = ("var", "init_var", "incr_var", "saved")
CTX_WORDS = len(_ARRAYS) * N_CTX + len(_FIELDS) - len(_ARRAYS)  # 36


def _set(a: np.ndarray, slot: int, value) -> np.ndarray:
    out = a.copy()
    out[slot] = value
    return out


@dataclass(frozen=True, eq=False)
class ContextRecord:
    var: np.ndarray       # i32[N_CTX]
    init_var: np.ndarray  # i32[N_CTX]
    incr_var: np.ndarray  # i32[N_CTX]
    saved: np.ndarray     # i32[N_CTX]
    valid: int
    done: int
    budget: int           # remaining iterations this chunk
    intr: int             # a loop was interrupted by the budget

    def _replace(self, **kw) -> "ContextRecord":
        return dataclasses.replace(self, **kw)

    # -- construction ------------------------------------------------------
    @classmethod
    def fresh(cls, budget: int = 0) -> "ContextRecord":
        z = lambda: np.zeros((N_CTX,), np.int32)
        return cls(var=z(), init_var=z(), incr_var=z(), saved=z(),
                   valid=1, done=0, budget=int(budget), intr=0)

    def with_budget(self, budget) -> "ContextRecord":
        return self._replace(budget=int(budget), intr=0)

    # -- the paper's checkpoint()/context_vars() operations ----------------
    def checkpoint(self, slot: int, value) -> "ContextRecord":
        """checkpoint(var): store ``value`` into slot and mark it saved."""
        return self._replace(var=_set(self.var, slot, value),
                             saved=_set(self.saved, slot, 1))

    def declare(self, slot: int, init, incr) -> "ContextRecord":
        """context_vars bookkeeping: remember loop init/increment."""
        return self._replace(init_var=_set(self.init_var, slot, init),
                             incr_var=_set(self.incr_var, slot, incr))

    def resume_value(self, slot: int, start) -> int:
        """Loop start: saved value if this slot was checkpointed, else start."""
        return int(self.var[slot]) if self.saved[slot] == 1 else int(start)

    def unsave(self, slot: int) -> "ContextRecord":
        return self._replace(saved=_set(self.saved, slot, 0))

    def clear(self, slot: int) -> "ContextRecord":
        """Clear a slot after its loop completes (so re-entry restarts)."""
        return self._replace(var=_set(self.var, slot, 0),
                             saved=_set(self.saved, slot, 0))

    def finish(self) -> "ContextRecord":
        return self._replace(done=1)

    def dec_budget(self) -> "ContextRecord":
        return self._replace(budget=self.budget - 1)

    def clear_intr(self) -> "ContextRecord":
        return self._replace(intr=0)

    def mark_intr(self, flag) -> "ContextRecord":
        return self._replace(intr=int(flag))

    # -- host round trips --------------------------------------------------
    def fields(self) -> dict:
        """Every field as int32 numpy (arrays ``[N_CTX]``, scalars 0-d) —
        the layout of the reference's materialized record."""
        return {f: np.array(getattr(self, f), np.int32) for f in _FIELDS}

    @classmethod
    def from_fields(cls, leaves) -> "ContextRecord":
        """Inverse of ``fields()``: ``leaves`` maps each field name to an
        array-like (the reference's numpy leaves or ``fields()`` output)."""
        kw = {f: np.array(leaves[f], np.int32).reshape(N_CTX)
              for f in _ARRAYS}
        kw.update({f: int(np.asarray(leaves[f])) for f in _FIELDS
                   if f not in _ARRAYS})
        return cls(**kw)

    def to_words(self) -> np.ndarray:
        """The record as ``CTX_WORDS`` int32 words, in field order: the
        four arrays, then ``valid``, ``done``, ``budget``, ``intr`` — the
        layout of the persistent kernels' context (``csrc/blur.cu``,
        ``struct Ctx``)."""
        return np.concatenate(
            [np.asarray(getattr(self, f), np.int32).reshape(-1)
             for f in _FIELDS]).astype(np.int32)

    @classmethod
    def from_words(cls, words) -> "ContextRecord":
        """Inverse of ``to_words()``."""
        w = np.asarray(words, np.int32).reshape(CTX_WORDS)
        kw = {f: w[i * N_CTX:(i + 1) * N_CTX].copy()
              for i, f in enumerate(_ARRAYS)}
        kw.update({f: int(w[len(_ARRAYS) * N_CTX + i])
                   for i, f in enumerate(_FIELDS[len(_ARRAYS):])})
        return cls(**kw)


pytree.register_pytree_node(
    ContextRecord,
    lambda c: (list(c.fields().values()), None),
    lambda leaves, _: ContextRecord.from_fields(dict(zip(_FIELDS, leaves))),
    serialized_type_name="repro_torch.core.context.ContextRecord")


@dataclass
class Committed:
    """One committed context snapshot.

    Two residencies:

    - ``device=False``: ``payload`` leaves are host numpy copies, ready for
      shipping to another region (or to the reference, ``to_reference``).
    - ``device=True`` (lazy spill): the payload is still device-resident
      ``torch.Tensor``s committed by the region worker without any host
      round trip.  ``owner`` identifies the producing Region *object*; a
      resume on the same region clones them on its own stream (no host
      copy at all), while a cross-region resume calls ``materialize()``.

    The context record itself always lives on the host.
    """
    seqno: int
    context: Any          # ContextRecord
    payload: Any          # kernel state (tuple of tensors or numpy arrays)
    # which task committed this snapshot: failover recovery must never
    # resume task X from a stale commit task Y left in the same bank
    tid: Optional[int] = None
    device: bool = False           # payload still lives in device memory
    region_rid: Optional[int] = None  # region whose memory holds it
    # identity of the owning Region object (never compare rids: they
    # restart at 0 on every shell)
    owner: Any = None
    # recorded on the owner's stream after the last chunk that wrote the
    # payload; ``materialize`` waits on it before copying to the host
    ready: Any = None
    _host: Optional["Committed"] = dataclasses.field(
        default=None, repr=False, compare=False)
    _mat_lock: Any = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def materialize(self) -> "Committed":
        """The committed *host* copy, produced on demand (and cached).

        A host-resident commit returns itself; a device-resident one pays
        the device→host transfer exactly once — the actual spill, deferred
        from preemption time to the first consumer that needs host bytes.
        The copy runs on the caller's stream, so it first waits for the
        producing stream's ``ready`` event."""
        if not self.device:
            return self
        with self._mat_lock:
            if self._host is None:
                if self.ready is not None:
                    self.ready.synchronize()
                host_payload = (tuple(b.cpu().numpy() for b in self.payload)
                                if self.payload is not None else None)
                self._host = Committed(self.seqno, self.context,
                                       host_payload, tid=self.tid)
            return self._host


def from_reference(committed) -> Committed:
    """The reference's materialized ``Committed`` (numpy ``ContextRecord``
    leaves, numpy-convertible payload) as the port's host commit — a task
    checkpoint-preempted in the JAX package resumes here.  Every payload
    leaf keeps its dtype and shape: f32 images, the serving kernels' int32
    token and block tables, f32 K/V pools and weights."""
    ctx = committed.context
    ctx = ContextRecord.from_fields({f: getattr(ctx, f) for f in _FIELDS})
    payload = (tuple(np.array(b) for b in committed.payload)
               if committed.payload is not None else None)
    return Committed(committed.seqno, ctx, payload, tid=committed.tid)


def to_reference(committed: Committed) -> dict:
    """Inverse of ``from_reference``: the commit's host leaves in the
    reference's layout, ``{"seqno", "tid", "context": {field: int32
    numpy}, "payload": tuple of numpy}``.  The reference rebuilds its own
    objects from them (``Committed(seqno, ContextRecord(**context),
    payload, tid=tid)``); this package never imports it."""
    host = committed.materialize()
    payload = (tuple(np.array(b) for b in host.payload)
               if host.payload is not None else None)
    return {"seqno": host.seqno, "tid": host.tid,
            "context": host.context.fields(), "payload": payload}


class KVBlockPool:
    """Fixed-size KV block allocator (DESIGN.md §13) — the paged-KV
    analogue of the region's BRAM banking.

    The *bytes* of the pages live in two device arrays the serving
    engine threads round-to-round (``[NB, BS, KV, hd]`` pools inside the
    decode task's ArgBundle — preemption commits them through the same
    ContextBank lazy-spill path as any payload).  This object is the
    host-side book-keeping: which page ids belong to which sequence,
    the free list, and the occupancy/eviction/reuse accounting the
    telemetry gauges expose.

    Block 0 is the reserved **null page**: block tables are padded with
    it, and inactive decode rows scatter zeros into it — duplicate
    same-value writes, so page content is deterministic under any batch
    composition and resume schedule.
    """

    def __init__(self, n_blocks: int, block_size: int, metrics=None):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (block 0 is the null "
                             f"page), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # live metrics registry (``repro_torch.obs.MetricsRegistry``, the
        # serving engine's): None-guarded, zero cost when disabled
        self.metrics = metrics
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> 1, 2, ...
        self._by_sid: dict = {}        # sid -> [block ids, in position order]
        self._ever_used: set = set()
        self.in_use = 0
        self.peak_in_use = 0
        self.evictions = 0             # blocks freed back to the pool
        self.reuse = 0                 # allocations of a previously-freed id
        self.alloc_deferred = 0        # ensure() calls refused for capacity

    # -- allocation --------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions."""
        return -(-n_tokens // self.block_size)

    def ensure(self, sid: int, n_tokens: int) -> Optional[list]:
        """Grow ``sid``'s block list to cover ``n_tokens`` positions.

        Returns the sequence's full block list on success, or ``None``
        (and counts ``alloc_deferred``) when the pool cannot cover the
        growth — the caller defers admission until pages free up; the
        transaction is all-or-nothing, so a partial grab is never held
        across a deferral."""
        have = self._by_sid.setdefault(sid, [])
        need = self.blocks_for(n_tokens) - len(have)
        if need <= 0:
            return have
        if need > len(self._free):
            self.alloc_deferred += 1
            if not have:
                self._by_sid.pop(sid, None)
            return None
        for _ in range(need):
            bid = self._free.pop()
            if bid in self._ever_used:
                self.reuse += 1
            self._ever_used.add(bid)
            have.append(bid)
        self.in_use += need
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self._gauge()
        return have

    def blocks(self, sid: int) -> list:
        return self._by_sid.get(sid, [])

    def release(self, sid: int) -> int:
        """Free every page ``sid`` holds (slot eviction / failure)."""
        blocks = self._by_sid.pop(sid, [])
        if blocks:
            self._free.extend(reversed(blocks))
            self.in_use -= len(blocks)
            self.evictions += len(blocks)
            self._gauge()
            if self.metrics is not None:
                self.metrics.counter("kv_block_evictions").inc(len(blocks))
        return len(blocks)

    def _gauge(self):
        if self.metrics is not None:
            self.metrics.gauge("kv_blocks_in_use").set(self.in_use)

    # -- observability -----------------------------------------------------
    @property
    def free(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        """In-use fraction of the allocatable pool (block 0 excluded)."""
        return self.in_use / max(self.n_blocks - 1, 1)

    def stats(self) -> dict:
        return {
            "blocks_total": self.n_blocks - 1,  # allocatable (null excluded)
            "block_size": self.block_size,
            "blocks_in_use": self.in_use,
            "blocks_peak": self.peak_in_use,
            "occupancy": self.occupancy(),
            "evictions": self.evictions,
            "reuse": self.reuse,
            "alloc_deferred": self.alloc_deferred,
        }


class ContextBank:
    """Per-region context storage — the BRAM bank + CPU-visible book-keeping.

    Double-buffered commits realize the paper's ``valid`` flag: ``commit``
    writes into the non-active buffer and only then flips the active index;
    a preemption/crash mid-commit leaves the other buffer intact.  The
    ``interrupt_next_commit`` hook lets tests inject exactly the torn-write
    failure the paper's valid flag guards against.
    """

    def __init__(self):
        self._buffers: list[Optional[Committed]] = [None, None]
        self._active = -1  # no valid commit yet
        self._seq = 0
        self._lock = threading.Lock()
        self.interrupt_next_commit = False  # test hook

    def commit(self, context, payload=None, tid=None, *,
               device: bool = False, region_rid=None, owner=None,
               ready=None) -> int:
        """Commit a snapshot.  ``device=True`` is the lazy-spill path: the
        device tensors are stored as-is (no device→host copy on the
        preemption hot path) and the host copy is produced on demand by
        ``Committed.materialize()``; ``ready`` is the event that marks the
        payload final on its producing stream."""
        with self._lock:
            self._seq += 1
            target = (self._active + 1) % 2
            if device:
                committed = Committed(self._seq, context, payload, tid=tid,
                                      device=True, region_rid=region_rid,
                                      owner=owner, ready=ready)
            else:
                # eager device -> host materialization (the BRAM -> CPU copy)
                host_payload = (tuple(b.cpu().numpy()
                                      if isinstance(b, torch.Tensor) else b
                                      for b in payload)
                                if payload is not None else None)
                committed = Committed(self._seq, context, host_payload,
                                      tid=tid)
            self._buffers[target] = committed
            if self.interrupt_next_commit:
                # simulate the asynchronous reset landing mid-save: the
                # active index is NOT flipped -> previous commit stays valid
                self.interrupt_next_commit = False
                return self._active
            self._active = target
            return self._active

    def restore(self) -> Optional[Committed]:
        with self._lock:
            if self._active < 0:
                return None
            return self._buffers[self._active]

    def reset(self):
        with self._lock:
            self._buffers = [None, None]
            self._active = -1

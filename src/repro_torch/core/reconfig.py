"""Reconfiguration engine (paper §4.1/4.2).

A "bitstream" is the kernel's hand-written CUDA library, built and loaded,
plus the uniform chunk entry bound for one key (kernel, ABI signature,
region geometry, program).  Partial reconfiguration = swapping one region's
bound entry (cache hit: fast; cold generation: the library build the first
time in a process, the binding otherwise).  Full reconfiguration = tearing
down every region and reloading (the paper's baseline, §6.3 red lines).
The single ICAP port becomes a global lock: at most one bitstream *load*
is in flight — but bitstream *generation* (the library build) happens
outside the ICAP lock, so one region's cold generation never blocks
another region's cache-hit reconfiguration (§4.2: requests travel through
the region queues as internal tasks; only the port itself serializes).

The bitstream store is an LRU cache with a configurable capacity (the
off-chip bitstream repository is finite), eviction accounting, and per-key
hit/miss/inflight statistics.  ``prefetch`` generates a bitstream off the
critical path — the scheduler's background prefetcher uses it to hide
generation latency behind execution.  A staleness probe lets a prefetch be
dropped when its task already left the queues.

Optional ``simulate_partial_s`` / ``simulate_full_s`` inject the paper's
measured bitstream-load times (0.07 s / 0.22 s) so scheduler experiments can
reproduce the paper's timing regime.  Cache, stats and report keys match
the reference's ``repro.core.reconfig`` key for key, and so do the
``icap``/``compile`` spans and histograms emitted when the shell threads a
tracer or a metrics registry through the engine.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.controller.abi import ArgBundle
from repro_torch.controller.kernels import KernelDef, get_kernel
from repro_torch.core.preemption import make_megakernel, make_pipelined_chunk
from repro_torch.kernels.native import load_library

# provenance of a cached bitstream
ORIGIN_DEMAND = "demand"      # compiled inline on a region's dispatch path
ORIGIN_PREFETCH = "prefetch"  # compiled ahead of time by the prefetcher
ORIGIN_PREWARM = "prewarm"    # compiled up front by an explicit prewarm


@dataclass
class CacheEntry:
    fn: Callable
    origin: str = ORIGIN_DEMAND
    hits: int = 0
    # first demand hit on a prefetched entry = one prefetch win; later hits
    # are ordinary cache reuse and must not inflate the prefetch hit rate
    consumed: bool = False


@dataclass
class KeyStats:
    """Per-bitstream-key accounting (hit/miss/inflight)."""
    hits: int = 0
    misses: int = 0
    inflight_joins: int = 0
    evicted: int = 0
    origin: Optional[str] = None


class LRUBitstreamCache:
    """Bounded LRU store of generated bitstreams.

    ``capacity=None`` means unbounded (the seed behaviour).  Thread-safe;
    eviction order is strict least-recently-used where both ``get`` hits and
    ``put`` refresh recency.
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._od: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0
        # bounded: only the most recent evictions are kept (diagnostics),
        # so a long-running bounded cache cannot leak through its own log
        self.evicted_keys: deque = deque(maxlen=64)

    def get(self, key: tuple) -> Optional[CacheEntry]:
        with self._lock:
            entry = self._od.get(key)
            if entry is not None:
                self._od.move_to_end(key)
                entry.hits += 1
            return entry

    def peek(self, key: tuple) -> Optional[CacheEntry]:
        """Lookup without touching recency or hit counts."""
        with self._lock:
            return self._od.get(key)

    def put(self, key: tuple, entry: CacheEntry) -> list:
        """Insert (refreshing recency) and return any evicted keys."""
        evicted = []
        with self._lock:
            self._od[key] = entry
            self._od.move_to_end(key)
            while self.capacity is not None and len(self._od) > self.capacity:
                old_key, _ = self._od.popitem(last=False)
                self.evictions += 1
                self.evicted_keys.append(old_key)
                evicted.append(old_key)
        return evicted

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._od

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def keys(self) -> list:
        """Keys in LRU order (least recent first)."""
        with self._lock:
            return list(self._od.keys())


@dataclass
class ReconfigStats:
    partial_loads: int = 0
    cache_hits: int = 0
    cold_compiles: int = 0        # demand compiles on the dispatch path
    prefetch_compiles: int = 0    # background compiles, off the hot path
    prefetch_hits: int = 0        # demand loads served by a prefetched entry
    prefetch_stale_drops: int = 0  # prefetches dropped: task left the queue
    inflight_joins: int = 0       # demand loads that joined a running compile
    evictions: int = 0
    full_reconfigs: int = 0
    total_partial_s: float = 0.0
    total_compile_s: float = 0.0
    # wall time the dispatch path spent waiting for bitstream generation
    # (cold compile or join on an in-flight one) — THE stall prefetch hides
    total_stall_s: float = 0.0

    def prefetch_hit_rate(self) -> float:
        if self.partial_loads == 0:
            return 0.0
        return self.prefetch_hits / self.partial_loads


class _Inflight:
    """A bitstream generation in progress; joiners wait on the event."""

    def __init__(self, origin: str):
        self.origin = origin
        self.done = threading.Event()
        self.entry: Optional[CacheEntry] = None
        self.error: Optional[BaseException] = None


class ReconfigEngine:
    def __init__(self, simulate_partial_s: float = 0.0,
                 simulate_full_s: float = 0.0,
                 cache_capacity: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.cache = LRUBitstreamCache(cache_capacity)
        self._icap = threading.Lock()  # single ICAP port (the load itself)
        # the shell's device: on CUDA, generating a bitstream builds and
        # loads the kernel's library; on the CPU there is nothing to build
        self.device = device
        self.stats = ReconfigStats()
        self.key_stats: Dict[tuple, KeyStats] = {}
        self.simulate_partial_s = simulate_partial_s
        self.simulate_full_s = simulate_full_s
        self._lock = threading.Lock()  # stats + inflight table
        self._inflight: Dict[tuple, _Inflight] = {}
        # flight recorder and live metrics registry (``repro_torch.obs``),
        # set by the owning shell; None disables each at zero cost
        self.tracer = None
        self.metrics = None

    def cache_key(self, kernel: str, sig: tuple, geometry: tuple,
                  program: str = "chunk") -> tuple:
        """``program`` selects the entry point: ``"chunk"`` (one
        budget-bounded chunk per dispatch — the sync/pipelined engines) or
        ``"mega"`` (the whole chunk loop in one launch — the megakernel
        engine).  Same kernel + signature + geometry, distinct bitstreams.
        The key layout is the reference's, so keys compare across the
        two."""
        return (kernel, sig, geometry, program)

    def _key_stats(self, key: tuple) -> KeyStats:
        # caller holds self._lock
        ks = self.key_stats.get(key)
        if ks is None:
            ks = self.key_stats[key] = KeyStats()
        return ks

    # ------------------------------------------------------------------
    def load(self, kernel_name: str, bundle: ArgBundle, geometry: tuple,
             devices=None, program: str = "chunk") -> Tuple[Callable, float]:
        """Partial reconfiguration of one region.  Returns (executable,
        seconds).  Only the bitstream *load* holds the ICAP lock; a cold
        compile (bitstream generation) runs outside it, so other regions'
        reconfigurations proceed meanwhile."""
        kd = get_kernel(kernel_name)
        key = self.cache_key(kernel_name, bundle.signature(), geometry,
                             program)
        t0 = time.perf_counter()

        entry = self.cache.get(key)
        if entry is not None:
            with self._lock:
                self.stats.cache_hits += 1
                ks = self._key_stats(key)
                ks.hits += 1
                if entry.origin == ORIGIN_PREFETCH and not entry.consumed:
                    entry.consumed = True
                    self.stats.prefetch_hits += 1
        else:
            t_stall0 = time.perf_counter()
            entry = self._get_or_compile(key, kd, bundle, devices,
                                         origin=ORIGIN_DEMAND,
                                         program=program)
            with self._lock:
                self.stats.total_stall_s += time.perf_counter() - t_stall0
                # joining an in-flight prefetch still absorbed the compile
                # stall on the dispatch path: it is not a prefetch win, so
                # later cache hits on this entry must not claim one either
                entry.consumed = True

        t_wait0 = time.perf_counter()
        with self._icap:  # only one RR loads a bitstream at a time
            t_acq = time.perf_counter()
            if self.simulate_partial_s:
                time.sleep(self.simulate_partial_s)
        tr = self.tracer
        if tr is not None:
            # hold span on the shared-port track; acquire wait rides along
            # as an attr so the derived pass can total ICAP serialization
            tr.emit_span("icap", ("icap", 0), t_acq, kernel=kernel_name,
                         wait_s=t_acq - t_wait0)
        m = self.metrics
        if m is not None:
            now = time.perf_counter()
            m.histogram("icap_hold_seconds").observe(now - t_acq, t=now)
            m.histogram("icap_wait_seconds").observe(t_acq - t_wait0, t=now)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats.partial_loads += 1
            self.stats.total_partial_s += dt
        return entry.fn, dt

    def _get_or_compile(self, key: tuple, kd: KernelDef, bundle: ArgBundle,
                        devices, origin: str,
                        program: str = "chunk") -> CacheEntry:
        """Return the cached entry for ``key``, compiling it if needed.
        Concurrent requests for the same key are deduplicated: one thread
        compiles, the others wait on it (an 'inflight join')."""
        with self._lock:
            entry = self.cache.peek(key)
            if entry is not None:
                return entry
            inflight = self._inflight.get(key)
            if inflight is None:
                inflight = self._inflight[key] = _Inflight(origin)
                owner = True
            else:
                owner = False
                self.stats.inflight_joins += 1
                self._key_stats(key).inflight_joins += 1

        if not owner:
            # the owner always publishes entry or error before done.set()
            inflight.done.wait()
            if inflight.error is not None:
                raise inflight.error
            return inflight.entry

        try:
            fn = self._compile(kd, bundle, devices, program)
            entry = CacheEntry(fn, origin=origin)
            evicted = self.cache.put(key, entry)
            with self._lock:
                ks = self._key_stats(key)
                ks.misses += 1
                ks.origin = origin
                if origin == ORIGIN_DEMAND:
                    self.stats.cold_compiles += 1
                else:  # prefetch or prewarm: off the dispatch path
                    self.stats.prefetch_compiles += 1
                self.stats.evictions += len(evicted)
                for ek in evicted:
                    self._key_stats(ek).evicted += 1
                self._prune_key_stats()
            inflight.entry = entry
            return entry
        except BaseException as e:
            inflight.error = e
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            inflight.done.set()

    _KEY_STATS_CAP = 1024

    def _prune_key_stats(self):
        """Drop stats of long-evicted keys so a bounded cache under a
        churning workload cannot grow memory without bound.  Caller holds
        ``self._lock``."""
        if len(self.key_stats) <= self._KEY_STATS_CAP:
            return
        for k in [k for k, ks in self.key_stats.items() if ks.evicted
                  and k not in self.cache]:
            del self.key_stats[k]
            if len(self.key_stats) <= self._KEY_STATS_CAP:
                break

    def _compile(self, kd: KernelDef, bundle: ArgBundle, devices,
                 program: str = "chunk") -> Callable:
        """Generate the bitstream for this key: on a CUDA engine, build
        and load the kernel's hand-written library (``nvcc`` once per
        process, under the builder's own lock — never the ICAP lock),
        then bind the entry ``program`` names: ``"chunk"``,

            chunk(ctx, bufs, ints, floats, budget) -> (ctx, bufs, done)

        or ``"mega"`` (``core/preemption.make_megakernel``),

            mega(ctx, bufs, ints, floats, budget, flag) -> launch

        which on a CUDA engine is the kernel's persistent entry and raises
        ``NotImplementedError`` for a kernel that has none."""
        if program not in ("chunk", "mega"):
            raise ValueError(f"unknown program kind {program!r}")
        t0 = time.perf_counter()
        # bound first: a kernel the card cannot run as "mega" raises
        # before anything is built
        fn = (make_megakernel(kd, self.device) if program == "mega"
              else make_pipelined_chunk(kd.fn))
        library = ((program == "mega" and kd.mega_library) or kd.library)
        if library is not None and self.device is not None \
                and self.device.type == "cuda":
            load_library(library)
        with self._lock:
            self.stats.total_compile_s += time.perf_counter() - t0
        tr = self.tracer
        if tr is not None:
            tr.emit_span("compile", ("compile", 0), t0,
                         kernel=kd.name, program=program)
        m = self.metrics
        if m is not None:
            m.histogram("compile_seconds").observe(
                time.perf_counter() - t0)
        return fn

    # ------------------------------------------------------------------
    def prefetch(self, kernel_name: str, bundle: ArgBundle, geometry: tuple,
                 still_wanted: Optional[Callable[[], bool]] = None,
                 origin: str = ORIGIN_PREFETCH,
                 program: str = "chunk") -> str:
        """Generate a bitstream off the critical path (no ICAP involvement).

        Returns ``"cached"`` (already present or being generated),
        ``"stale"`` (``still_wanted`` said the task left the queue — the
        prefetch is dropped, nothing compiled), or ``"compiled"``.
        """
        kd = get_kernel(kernel_name)
        key = self.cache_key(kernel_name, bundle.signature(), geometry,
                             program)
        if key in self.cache:
            return "cached"
        with self._lock:
            if key in self._inflight:
                return "cached"
        if still_wanted is not None and not still_wanted():
            with self._lock:
                self.stats.prefetch_stale_drops += 1
            return "stale"
        self._get_or_compile(key, kd, bundle, None, origin=origin,
                             program=program)
        return "compiled"

    def prewarm(self, kernel_name: str, bundle: ArgBundle, geometry: tuple,
                program: str = "chunk"):
        """Synchronous up-front warm (compile noise control in benches and
        tests).  Counts as a background compile, but its later demand hits
        are plain cache reuse — NOT prefetch wins — so prewarming a
        no-prefetch baseline cannot inflate the prefetch hit rate."""
        self.prefetch(kernel_name, bundle, geometry, origin=ORIGIN_PREWARM,
                      program=program)

    # ------------------------------------------------------------------
    def full_reconfigure(self) -> float:
        """Account a full-FPGA reconfiguration (all regions stall)."""
        t0 = time.perf_counter()
        with self._icap:
            if self.simulate_full_s:
                time.sleep(self.simulate_full_s)
        with self._lock:
            self.stats.full_reconfigs += 1
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def report(self) -> dict:
        """Aggregate engine statistics (cache + prefetch + stall)."""
        s = self.stats
        with self._lock:
            per_key = {
                "|".join(str(p) for p in k): {
                    "hits": ks.hits, "misses": ks.misses,
                    "inflight_joins": ks.inflight_joins,
                    "evicted": ks.evicted, "origin": ks.origin,
                }
                for k, ks in self.key_stats.items()
            }
        return {
            "partial_loads": s.partial_loads,
            "cache_hits": s.cache_hits,
            "cold_compiles": s.cold_compiles,
            "prefetch_compiles": s.prefetch_compiles,
            "prefetch_hits": s.prefetch_hits,
            "prefetch_hit_rate": s.prefetch_hit_rate(),
            "prefetch_stale_drops": s.prefetch_stale_drops,
            "inflight_joins": s.inflight_joins,
            "evictions": s.evictions,
            "full_reconfigs": s.full_reconfigs,
            "total_partial_s": s.total_partial_s,
            "total_compile_s": s.total_compile_s,
            "total_stall_s": s.total_stall_s,
            "cache_size": len(self.cache),
            "cache_capacity": self.cache.capacity,
            "per_key": per_key,
        }

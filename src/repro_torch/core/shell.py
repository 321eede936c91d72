"""The shell (paper §4.1): the static infrastructure that owns the device
grid, instantiates the reconfigurable regions, and provides global/per-region
resets.

The port runs on one NVIDIA card by default: ``devices=None`` means
``[cuda:0]``, and regions time-share it as CUDA streams
(``allow_overlap=True``, the reference's single-device regime).  A caller
that wants the CPU passes ``devices=["cpu"]`` — there the kernels' plain
PyTorch versions run.  Without CUDA and without that request the shell
raises: it never drops to the CPU on its own.

The shell also owns the reconfiguration plumbing: the ``ReconfigEngine``
(LRU bitstream cache + single ICAP port) and the ``BitstreamPrefetcher``
that generates bitstreams off the dispatch path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.floorplan import Floorplanner
from repro_torch.core.interrupts import InterruptController
from repro_torch.core.prefetch import BitstreamPrefetcher
from repro_torch.core.reconfig import ReconfigEngine
from repro_torch.core.region import Region, check_engine_mode


def resolve_devices(devices=None) -> List[torch.device]:
    """``None`` -> ``[cuda:0]`` (raises without CUDA); otherwise the given
    devices as ``torch.device``s."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on cuda:0 by default and CUDA is not "
                "available; pass devices=['cpu'] (Client(device='cpu')) to "
                "run the plain PyTorch kernels on the CPU")
        return [torch.device("cuda", 0)]
    return [torch.device(d) for d in devices]


class Shell:
    def __init__(self, n_regions: int = 2, devices=None,
                 allow_overlap: bool = True,
                 chunk_budget: Optional[int] = None,
                 simulate_partial_s: float = 0.0,
                 simulate_full_s: float = 0.0,
                 cache_capacity: Optional[int] = None,
                 prefetch: bool = True,
                 prefetch_max_queue: int = 64,
                 region_widths: Optional[Sequence[int]] = None,
                 engine: str = "pipelined",
                 tracer=None, metrics=None):
        if tracer is not None or metrics is not None:
            raise NotImplementedError(
                "the flight recorder and live metrics (repro.obs) are not "
                "ported yet; pass tracer=None, metrics=None")
        self.devices = resolve_devices(devices)
        self.interrupts = InterruptController()
        self.engine = ReconfigEngine(simulate_partial_s=simulate_partial_s,
                                     simulate_full_s=simulate_full_s,
                                     cache_capacity=cache_capacity,
                                     device=self.devices[0])
        # the worker thread starts lazily with the scheduler's first hint
        self.prefetcher = BitstreamPrefetcher(
            self.engine, max_queue=prefetch_max_queue, auto_start=False)
        self.prefetch_enabled = prefetch
        self.chunk_budget = chunk_budget
        # region execution engine mode: "pipelined" | "sync"
        self.engine_mode = check_engine_mode(engine)
        # test/bench hook inherited by regions added later
        self.region_slowdown_s: float = 0.0
        self.floorplanner = Floorplanner(self.devices,
                                         allow_overlap=allow_overlap)
        self.regions: List[Region] = []     # active (non-retired) regions
        self._by_rid: Dict[int, Region] = {}  # every region ever created
        self._next_rid = 0
        self._shutdown = False

        for devs in self.floorplanner.initial_plan(n_regions,
                                                   widths=region_widths):
            self.add_region(devices=devs)

    # -- dynamic region list ----------------------------------------------
    def add_region(self, devices=None, width: int = 1) -> Region:
        """Create and start a new region on a floorplanned device slice.
        Region ids are monotonic and never reused."""
        if devices is None:
            devices = self.floorplanner.allocate(width)
        rid = self._next_rid
        self._next_rid += 1
        r = Region(rid, self.engine, self.interrupts,
                   devices=list(devices), geometry=(len(devices),),
                   chunk_budget=self.chunk_budget,
                   engine_mode=self.engine_mode)
        r.slowdown_s = self.region_slowdown_s
        self.floorplanner.bind(rid, devices)
        self.regions.append(r)
        self._by_rid[rid] = r
        return r

    def region(self, rid: int) -> Region:
        """Region by id, including retired ones (interrupts may outlive the
        region that raised them)."""
        return self._by_rid[rid]

    # -- resets (paper: global reset + per-RR GPIO reset) -----------------
    def global_reset(self):
        """Stop everything, clear queues and banks (full-FPGA reset)."""
        for r in self.regions:
            r.shutdown()
        for r in self.regions:
            r.bank.reset()
            r.loaded = None
            r.executable = None
            r.current_task = None
            r.start()
        self.interrupts.drain()

    def region_reset(self, rid: int):
        """Per-region reset: preempt whatever is running there."""
        self.region(rid).request_preempt()

    def shutdown(self):
        """Stop every background thread this shell owns.  Idempotent."""
        if self._shutdown:
            return
        self._shutdown = True
        self.prefetcher.stop()
        for r in self._by_rid.values():
            r.shutdown()

    def alive_regions(self) -> List[Region]:
        return [r for r in self.regions if r.alive]

    def geometries(self) -> List[tuple]:
        """Distinct geometries of alive regions (prefetch targets)."""
        return list(dict.fromkeys(r.geometry for r in self.alive_regions()))

    def reconfig_report(self) -> dict:
        """Engine + prefetcher + per-region reconfiguration statistics
        (``report_version`` stamped — see ``core/reporting.py``)."""
        from repro_torch.core.reporting import stamp

        rep = self.engine.report()
        rep["prefetcher"] = {
            "enabled": self.prefetch_enabled,
            "submitted": self.prefetcher.stats.submitted,
            "processed": self.prefetcher.stats.processed,
            "dropped_full": self.prefetcher.stats.dropped_full,
        }
        rep["regions"] = {
            r.rid: {"reconfigs": r.stats.reconfigs,
                    "reconfig_s": r.stats.reconfig_s,
                    "chunks": r.stats.chunks,
                    "chunks_pipelined": r.stats.chunks_pipelined,
                    "chunks_discarded": r.stats.chunks_discarded,
                    "host_spills_avoided": r.stats.host_spills_avoided,
                    "kernel_mode": r.stats.kernel_mode}
            for r in self.regions
        }
        return stamp("shell_reconfig", rep)

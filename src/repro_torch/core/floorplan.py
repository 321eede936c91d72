"""Runtime floorplanning: partition the device grid into region slices.

On a real FPGA the floorplan — how the reconfigurable fabric is cut into
Reconfigurable Regions — is fixed when the shell is built (the paper's 1-RR
vs 2-RR study is literally two separate builds).  Ding et al. (arXiv
2212.05397) argue partitioning and scheduling must be co-designed; here the
floorplan becomes a runtime object (DESIGN.md §6.2): the ``Floorplanner``
owns the device grid, hands out contiguous slices to regions, and replans
idle regions' slices when the elastic pool (``core/pool.py``) grows or
shrinks.

Slices may be *heterogeneous*: widths can be matched to the per-kernel
resource footprints declared on ``KernelDef.footprint`` / ``Task.footprint``
(``widths_for_footprints``), so a wide kernel gets a wide region while
narrow kernels pack into the rest of the grid.

Invariant (checked at plan time): in disjoint mode every device belongs to
exactly one slice — no remainder device is ever stranded (the seed shell's
``per = n_dev // n_regions`` slicing dropped the tail of the device list
whenever ``n_dev % n_regions != 0``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class FloorplanError(ValueError):
    """The requested floorplan cannot be realised on this device grid."""


def partition(devices: Sequence, n_slices: int) -> List[list]:
    """Split ``devices`` into ``n_slices`` contiguous near-equal slices that
    cover every device: the first ``len(devices) % n_slices`` slices take
    one extra device each (remainder distribution)."""
    if n_slices < 1:
        raise FloorplanError(f"need >= 1 slice, got {n_slices}")
    n_dev = len(devices)
    if n_dev < n_slices:
        raise FloorplanError(
            f"{n_slices} disjoint slices need >= {n_slices} devices "
            f"(have {n_dev})")
    base, extra = divmod(n_dev, n_slices)
    slices, i = [], 0
    for k in range(n_slices):
        w = base + (1 if k < extra else 0)
        slices.append(list(devices[i:i + w]))
        i += w
    assert i == n_dev, "partition dropped devices"
    return slices


def partition_widths(devices: Sequence, widths: Sequence[int]) -> List[list]:
    """Split ``devices`` into contiguous slices of the requested
    (heterogeneous) widths.  ``sum(widths)`` may undershoot the grid — the
    remainder is spread one device at a time across the slices in order —
    but every slice must get at least one device and no device may be left
    over."""
    widths = [int(w) for w in widths]
    if not widths or any(w < 1 for w in widths):
        raise FloorplanError(f"every region width must be >= 1, got {widths}")
    n_dev = len(devices)
    if sum(widths) > n_dev:
        raise FloorplanError(
            f"widths {widths} need {sum(widths)} devices, have {n_dev}")
    widths = list(widths)
    k = 0
    while sum(widths) < n_dev:  # full coverage: spread the remainder
        widths[k % len(widths)] += 1
        k += 1
    slices, i = [], 0
    for w in widths:
        slices.append(list(devices[i:i + w]))
        i += w
    assert i == n_dev, "partition_widths dropped devices"
    return slices


def widths_for_footprints(footprints: Sequence[int], n_regions: int,
                          n_devices: int) -> List[int]:
    """Heterogeneous region widths matched to per-kernel footprints: the
    ``n_regions`` largest declared footprints become the target widths,
    shrunk (widest first) until they fit the grid and then padded back out
    so the whole grid is covered."""
    if n_regions < 1:
        raise FloorplanError(f"need >= 1 region, got {n_regions}")
    if n_devices < n_regions:
        raise FloorplanError(
            f"{n_regions} disjoint regions need >= {n_regions} devices "
            f"(have {n_devices})")
    fps = sorted((max(1, int(f)) for f in footprints), reverse=True)
    fps = (fps + [1] * n_regions)[:n_regions]
    while sum(fps) > n_devices:
        fps[fps.index(max(fps))] -= 1
    k = 0
    while sum(fps) < n_devices:
        fps[k % n_regions] += 1
        k += 1
    return fps


class Floorplanner:
    """Owns the device grid and the region-id -> device-slice assignment.

    Two modes, decided at plan time exactly like the seed shell:

    - **disjoint** (``n_dev >= n_regions``): contiguous non-overlapping
      slices covering every device;
    - **overlapped** (``n_dev < n_regions`` and ``allow_overlap``): regions
      time-share the full grid (the single-CpuDevice container case,
      DESIGN.md §2.1(5)).  Overlap is one-way: once any slice shares a
      device, free-device accounting and replanning are disabled.
    """

    def __init__(self, devices: Sequence, allow_overlap: bool = True):
        self.devices = list(devices)
        if not self.devices:
            raise FloorplanError("cannot floorplan an empty device grid")
        self.allow_overlap = allow_overlap
        self._assigned: Dict[int, list] = {}   # rid -> device slice
        self._overlapped = False

    # -- planning --------------------------------------------------------
    def initial_plan(self, n_regions: int,
                     widths: Optional[Sequence[int]] = None) -> List[list]:
        """Slices for the shell's initial regions (not yet bound)."""
        if n_regions < 1:
            raise FloorplanError(f"need >= 1 region, got {n_regions}")
        n_dev = len(self.devices)
        if widths is not None:
            if len(widths) != n_regions:
                raise FloorplanError(
                    f"{n_regions} regions but {len(widths)} widths")
            if sum(int(w) for w in widths) <= n_dev:
                return partition_widths(self.devices, widths)
            if not self.allow_overlap:
                raise FloorplanError(
                    f"widths {list(widths)} need "
                    f"{sum(int(w) for w in widths)} devices (have {n_dev}); "
                    f"pass allow_overlap=True to time-share")
            self._overlapped = True
            return [list(self.devices[:max(1, min(int(w), n_dev))])
                    for w in widths]
        if n_dev >= n_regions:
            return partition(self.devices, n_regions)
        if not self.allow_overlap:
            raise ValueError(
                f"{n_regions} regions need >= {n_regions} devices "
                f"(have {n_dev}); pass allow_overlap=True to time-share")
        self._overlapped = True
        return [list(self.devices) for _ in range(n_regions)]

    # -- assignment bookkeeping ------------------------------------------
    @property
    def overlapped(self) -> bool:
        return self._overlapped

    def bind(self, rid: int, devices: Sequence) -> None:
        self._assigned[rid] = list(devices)

    def release(self, rid: int) -> None:
        self._assigned.pop(rid, None)

    def assignment(self, rid: int) -> Optional[list]:
        return self._assigned.get(rid)

    def free_devices(self) -> list:
        """Devices not assigned to any region (identity-based; meaningless
        — and empty — once slices overlap)."""
        if self._overlapped:
            return []
        taken = {id(d) for devs in self._assigned.values() for d in devs}
        return [d for d in self.devices if id(d) not in taken]

    def allocate(self, width: int = 1) -> list:
        """A slice for a new region: free devices first; else, with
        ``allow_overlap``, a time-shared slice of the full grid."""
        width = max(1, int(width))
        free = self.free_devices()
        if len(free) >= width:
            return free[:width]
        if free:
            return free  # undersized; a replan can widen it later
        if self.allow_overlap:
            self._overlapped = True
            return list(self.devices[:min(width, len(self.devices))])
        raise FloorplanError(
            f"no free devices for a new {width}-wide region "
            f"(grid fully assigned, allow_overlap=False)")

    def coverage_ok(self) -> bool:
        """Every device is either assigned to a region or free (true by
        construction; exposed for tests/assertions)."""
        if self._overlapped:
            return True
        seen = {id(d) for devs in self._assigned.values() for d in devs}
        seen.update(id(d) for d in self.free_devices())
        return seen == {id(d) for d in self.devices}

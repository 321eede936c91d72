"""Tiny copies of the benchmark's cells for the CPU tests: the same
configurations and mixes with small frames and small pools."""
from __future__ import annotations

import copy

from perfbench.harness import spec


def tiny_cell(name: str):
    """The cell ``name`` with small frames (buffers of 128 and 256)."""
    cell = copy.deepcopy(spec.resolve(name))
    for s in cell.mix["streams"]:
        s.update(frame_px=[60, 130], frames=2, check_share=0.5)
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 11, seconds: float = 1.5,
             trace: bool = False, cell=None):
    """The result line's object of a CPU run (with ``_run`` kept)."""
    from perfbench import run as R

    return R.execute(name, seed, seconds, trace, device="cpu",
                     cell=cell or tiny_cell(name))

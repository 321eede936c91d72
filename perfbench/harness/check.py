"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference, after the window has closed and the system is
shut down.

- ``blur_max_abs_err``: every blur answer drawn for the check (its request's
  ``keep``), against the reference's passes over the same input frame: the
  largest absolute difference of any pixel, ring included.

``control=True`` also computes the number for the control: the reference
in the nearest lower precision (bfloat16 passes) put in the program's
place.  The benchmark's own runs do not compute it.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.harness.drive import Run
from perfbench.harness.traffic import BLUR_KERNELS
from perfbench.reference import blur


def _device(run: Run) -> torch.device:
    return torch.device("cuda", 0) if run.device_kind != "cpu" else \
        torch.device("cpu")


def blur_err(run: Run, control: bool = False):
    """(largest error, answers compared) over the kept blur answers: the
    program's, and with ``control`` also the control's (else None)."""
    dev = _device(run)
    worst, worst_ctl, n = 0.0, 0.0, 0
    for rec in run.blur:
        if rec.image is None:
            continue
        frame = torch.from_numpy(run.frames[rec.req.px][rec.req.frame]).to(dev)
        kind = BLUR_KERNELS[rec.req.kernel]
        ref = blur.blur_task(frame, kind, rec.req.iters)
        got = torch.from_numpy(rec.image).to(dev)
        worst = max(worst, float((got - ref).abs().max()))
        if control:
            low = blur.blur_task(frame, kind, rec.req.iters, torch.bfloat16)
            worst_ctl = max(worst_ctl, float((low - ref).abs().max()))
        n += 1
    return worst, (worst_ctl if control else None), n


def checks(run: Run, control: bool = False) -> List[Dict]:
    """Each number compared: name, value, limit, how many it covers, and
    with ``control`` the control's value of it."""
    limits = run.config["limits"]
    v, c, n = blur_err(run, control)
    return [{"name": "blur_max_abs_err", "value": v, "control": c,
             "limit": limits["blur_max_abs_err"], "n": n}]

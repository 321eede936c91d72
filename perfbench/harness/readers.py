"""What the metric readers (``perfbench/metrics/<name>.py``) share: the
window's answers, the program's flight-recorder events in the window, and
roofline shares."""
from __future__ import annotations

from typing import Optional

from perfbench.harness.drive import Run


def done_in_window(run: Run) -> list:
    """Blur answers in hand inside the window."""
    return [r for r in run.blur if r.ok and run.in_window(r.t_done)]


def share(bound_s: Optional[float], device_s: float) -> Optional[float]:
    """Roofline share in %, None where there is nothing to read."""
    if bound_s is None or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def kernel_seconds(run: Run, name_part: str) -> float:
    if run.dev is None:
        return 0.0
    return sum(e.dur_us for e in run.dev.kernels(name_part)) / 1e6

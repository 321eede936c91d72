"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.  NVIDIA's H100 SXM data sheet,
dense rates: HBM3 at 3.35 TB/s, float32 outside the tensor cores at
67 TFLOP/s; at the card's full 700 W limit."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}


def peak(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind``, or None for a card not listed."""
    return PEAKS.get(kind)


def bound_s(n_bytes: float, n_ops: float, kind: str) -> Optional[float]:
    """The least seconds the card could take: the larger of the bytes at
    peak bandwidth and the float32 operations at peak rate."""
    p = peak(kind)
    if p is None:
        return None
    return max(n_bytes / p["bytes_per_s"], n_ops / p["f32_ops_per_s"])

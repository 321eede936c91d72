"""Work of the blur task set on a padded float32 frame ``[h + 2, w + 2]``.

Counting rule.  A pass reads the padded frame once and writes the ``h x w``
interior once.  Its operations per interior pixel: the median of nine takes
19 compare-exchanges in the shortest known network (Paeth's), 2 operations
each, 38; the binomial 3x3 mean takes 9 products and 8 sums, 17.
B1 (``blur_rows_kernel``) is counted per pass: its runs of row blocks make
up the passes, and halo rows that two runs both read count once.  ``h`` and
``w`` are the buffer's interior, the rows and columns a pass writes.
"""
from __future__ import annotations

from typing import Tuple

F32 = 4
OPS_PER_PIXEL = {"median": 38, "gaussian": 17}


def frame_bytes(h: int, w: int) -> Tuple[int, int]:
    """(bytes read, bytes written) of reading a padded frame once and
    writing its interior once."""
    return (h + 2) * (w + 2) * F32, h * w * F32


def pass_work(h: int, w: int, kind: str) -> Tuple[int, int]:
    """(bytes, operations) of one pass: B1's unit."""
    rd, wr = frame_bytes(h, w)
    return rd + wr, h * w * OPS_PER_PIXEL[kind]

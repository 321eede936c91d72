"""Uniform kernel ABI (paper §5.1).

DPR requires every kernel loaded into an RR to present the *same* external
interface; the paper pads the HLS signature with dummy arguments
(``i_args_<n>``, unused float and pointer args).  Here the same role is
played by ``ArgBundle``: a fixed number of buffer slots plus fixed-width
int/float argument vectors, dummy-padded.  Every region worker therefore has
ONE dispatch path — launching a different kernel never changes the host-side
call structure, only the bound chunk entry ("bitstream").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

N_BUF_SLOTS = 6    # pointer args (HitTiles); unused slots hold (1,1) dummies
N_INT_ARGS = 8     # the paper pads to 8 integer scalars
N_FLOAT_ARGS = 8   # ... and 8 float scalars


@dataclass
class ArgBundle:
    """Uniform argument record.  ``bufs`` are numpy arrays (HitTile data);
    ints/floats are padded to fixed width."""
    bufs: Tuple[Any, ...] = ()
    ints: Tuple[int, ...] = ()
    floats: Tuple[float, ...] = ()
    # memoized signature: it is read on every scheduler dispatch/affinity
    # check and prefetch hint, and the shapes never change after creation
    _sig: Optional[tuple] = field(default=None, repr=False, compare=False)
    # memoized padded() result.  The int/float vectors stay HOST values:
    # they feed the host-side chunk control (loop bounds, iteration
    # counts), never a device tensor.  The buffer slots stay host numpy —
    # a launch uploads them once and thereafter the payload lives on the
    # device for the task's whole life on a region.
    _padded: Optional[tuple] = field(default=None, repr=False, compare=False)

    def padded(self):
        if self._padded is None:
            bufs = list(self.bufs)[:N_BUF_SLOTS]
            while len(bufs) < N_BUF_SLOTS:
                bufs.append(np.zeros((1, 1), np.float32))  # dummy pointer arg
            ints = list(self.ints)[:N_INT_ARGS]
            ints += [0] * (N_INT_ARGS - len(ints))
            floats = list(self.floats)[:N_FLOAT_ARGS]
            floats += [0.0] * (N_FLOAT_ARGS - len(floats))
            self._padded = (tuple(bufs), np.asarray(ints, np.int32),
                            np.asarray(floats, np.float32))
        return self._padded

    def signature(self) -> tuple:
        """Shape/dtype signature — the 'interface' a region must be
        configured for (kernel + signature = one bitstream).  Equal to the
        reference's tuple for the same numpy inputs: numpy dtype names
        (``'float32'``), shapes as int tuples."""
        if self._sig is None:
            bufs, _, _ = self.padded()
            self._sig = tuple((tuple(b.shape), np.asarray(b).dtype.name)
                              for b in bufs)
        return self._sig


def abi_signature(bundle: ArgBundle) -> tuple:
    return bundle.signature()

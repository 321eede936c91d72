"""HitTile — the Controller model's multi-dimensional array wrapper [7].

Non-scalar kernel arguments are HitTiles; the runtime moves them between
host and device transparently (the Zynq zero-copy shared memory becomes an
explicit copy to the device that is a no-op once resident).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class HitTile:
    def __init__(self, data, name: str = ""):
        self._data = data
        self.name = name

    @classmethod
    def zeros(cls, shape: Tuple[int, ...], dtype=np.float32, name: str = ""):
        return cls(np.zeros(shape, dtype), name=name)

    @classmethod
    def of(cls, array, name: str = ""):
        return cls(np.asarray(array), name=name)

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        d = self._data
        return d.dtype if isinstance(d, torch.Tensor) else np.asarray(d).dtype

    def device(self, device):
        """Host->device transfer (idempotent)."""
        self._data = torch.as_tensor(self._data, device=device)
        return self._data

    def host(self):
        """Device->host transfer."""
        if isinstance(self._data, torch.Tensor):
            self._data = self._data.cpu().numpy()
        return self._data

    @property
    def data(self):
        return self._data

    def __repr__(self):
        return f"HitTile({self.name or 'anon'} {self.shape} {self.dtype})"

"""Production and region meshes: the port of the reference's
``repro/launch/mesh.py``.

Both build a mesh of the single-process binding (``sharding.spmd.Mesh``):
a grid of torch devices with a name per axis.  The production meshes keep
the reference's TPU-pod shapes, so that the specs stay comparable; on one
H100 all 256 (or 512) entries are ``cuda:0`` and every shard shares the
card.  Building a mesh touches no device state (a grid of
``torch.device`` names); importing this module does nothing at all.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sharding.spmd import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 shards a pod; the multi-pod mesh adds a leading 2-pod
    axis.  Axes: ("data", "model") single-pod, ("pod", "data", "model")
    multi-pod.  Every entry is ``device``: ``cuda:0`` by default (raises
    without CUDA), ``"cpu"`` where the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on cuda:0 by default and "
                               "CUDA is not available; pass device='cpu'")
        device = torch.device("cuda", 0)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(shape, dtype=object)
    grid.fill(torch.device(device))
    return Mesh(grid, axes)


def make_region_mesh(devices, axis_names=("data", "model")) -> Mesh:
    """Mesh for a scheduler *region*: ``devices`` is a 2-D grid (a numpy
    array or nested lists) of torch devices or their names."""
    return Mesh(devices, axis_names)

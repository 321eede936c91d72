"""Carry the reference's parameter and cache trees into the port.

The reference's ``init_params`` and decode caches are pytrees of nested
dicts and lists; the port's are the same trees of tensors.  The caller
hands the reference's leaves over as numpy arrays (or anything
``numpy.asarray`` takes); the tests use this to run both packages on the
same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

PyTree = Any


def _to_tensor(leaf, device) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, copy=True)).to(device)


def _map(tree: PyTree, fn) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_reference(tree: PyTree, device) -> PyTree:
    """The reference's ``init_params`` tree (``embed``, ``final_norm``,
    ``unembed``, ``blocks[slot][name]`` stacked on the leading axis, the
    ``tail`` list) -> the port's identical tree of tensors on ``device``."""
    return _map(tree, lambda leaf: _to_tensor(leaf, device))


def cache_from_reference(tree: PyTree, device) -> PyTree:
    """A reference decode cache -> the port's: the same tree of tensors,
    with ``pos`` as a host int."""
    out = {k: v for k, v in tree.items() if k != "pos"}
    out = params_from_reference(out, device)
    out["pos"] = int(np.asarray(tree["pos"]))
    return out

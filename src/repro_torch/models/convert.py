"""Carry the reference's parameter and cache trees into the port.

The reference's ``init_params``, train states and decode caches are
pytrees of nested dicts and lists; the port's are the same trees of
tensors.  The caller
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
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def _map(tree: PyTree, fn) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_reference(tree: PyTree, device) -> PyTree:
    """The reference's ``init_params`` tree (``embed``, ``final_norm``,
    ``unembed``, ``frontend_proj``, ``blocks[slot][name]`` stacked on the
    leading axis, the ``tail`` list, ``encoder``, ``enc_norm``) -> the
    port's identical tree of tensors on ``device``."""
    return _map(tree, lambda leaf: _to_tensor(leaf, device))


def cache_from_reference(tree: PyTree, device) -> PyTree:
    """A reference decode cache -> the port's: the same tree of tensors
    (an encoder-decoder's ``enc`` included), with ``pos`` as a host int."""
    out = {k: v for k, v in tree.items() if k != "pos"}
    out = params_from_reference(out, device)
    out["pos"] = int(np.asarray(tree["pos"]))
    return out


def train_state_from_reference(tree: PyTree, device) -> PyTree:
    """A reference train state (``init_train_state``'s ``params``,
    ``master``, ``m``, ``v`` and ``step``) -> the port's: the same trees of
    tensors on ``device`` (bfloat16 leaves stay bfloat16), ``step`` an
    int32 0-d tensor."""
    out = {k: params_from_reference(tree[k], device)
           for k in ("params", "master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=device)
    return out

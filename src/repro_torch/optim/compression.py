"""Gradient compression: the port of the reference's
``repro/optim/compression.py``.

int8 blockwise quantization with error feedback: the quantization residual
is carried to the next step so the compression is unbiased in the long run.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
are the reference's bit for bit.

Usage:
    comp = Int8Compressor()
    train_step = make_train_step(..., grad_compression=comp.pair())
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: f32[...] -> (int8 codes [n_blocks, BLOCK], f32 per-block
    scales)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape)


def _is_compressed(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], tuple))


def compress_tree(tree: Any) -> Any:
    """Every tensor leaf -> ((codes, scales), shape)."""
    return pytree.tree_map(lambda g: (_quantize(g), tuple(g.shape)), tree)


def decompress_tree(ctree: Any) -> Any:
    def one(leaf):
        (q, scale), shape = leaf
        return _dequantize(q, scale, shape)

    return pytree.tree_map(one, ctree, is_leaf=_is_compressed)


class Int8Compressor:
    """Error-feedback int8 compressor (the residual is carried by the
    caller)."""

    def pair(self):
        return (compress_tree, decompress_tree)

    @staticmethod
    def apply_with_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
        """(grads+residual) -> (dequantized grads, new residual)."""
        flat_g, spec = pytree.tree_flatten(grads)
        deq, res = [], []
        for g, r in zip(flat_g, pytree.tree_leaves(residual)):
            x = g + r
            q, scale = _quantize(x)
            d = _dequantize(q, scale, tuple(x.shape))
            deq.append(d)
            res.append(x - d)
        return (pytree.tree_unflatten(deq, spec),
                pytree.tree_unflatten(res, spec))

    @staticmethod
    def init_residual(params: Any) -> Any:
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

"""Collective analysis of a step's op log: the port of the reference's
``repro/launch/hlo_analysis.py``.

The reference reads the collectives out of compiled HLO text.  The port
has no HLO: the dry run (``launch/dryrun.py``) records every aten op that
rank 0 runs below DTensor, and this module reads the collectives out of
that log.  A functional collective (``_c10d_functional.*``, and DTensor's
``_dtensor.shard_dim_alltoall``) is recorded
with its result dtypes and shapes and the size of its process group;
``wait_tensor`` is its ``-done`` half and is skipped, as the reference
skips ``-done`` lines.  Per-device bytes follow the reference's ring
factors:

- all-reduce          result S             -> 2 (g-1)/g * S
- all-gather          result S (gathered)  ->   (g-1)/g * S
- reduce-scatter      result S (shard)     ->   (g-1)   * S
- all-to-all          result S             ->   (g-1)/g * S
- collective-permute  result S             ->             S

A group of one moves nothing and is skipped, except for a permute.
Eager PyTorch runs every block of the stack, so no collective is counted
once for a loop body (the reference's scan caveat has no counterpart).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, NamedTuple, Optional, Tuple

import torch

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

# functional collective (op packet name) -> the reference's HLO op name;
# None marks the "-done" half
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_out": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "_c10d_functional.wait_tensor": None,
}


class OpRecord(NamedTuple):
    """One logged op: its name (``aten.mm.default``), its result and
    operand tensors as (dtype, shape) pairs, and, for a collective, the
    size of its group and the reference's op name (``kind``; ``done``
    for the ``-done`` half of a pair)."""

    op: str
    results: Tuple[Tuple[torch.dtype, tuple], ...]
    operands: Tuple[Tuple[torch.dtype, tuple], ...] = ()
    group: int = 1
    kind: Optional[str] = None
    done: bool = False


def collective_kind(op: str) -> Tuple[Optional[str], bool]:
    """(reference op name, is the -done half) of an op name, or (None,
    False) for an op that is no collective."""
    packet = op.rsplit(".", 1)[0] if op.count(".") >= 2 else op
    if packet not in _COLLECTIVES:
        return None, False
    kind = _COLLECTIVES[packet]
    return kind, kind is None


def tensor_bytes(pairs: Iterable) -> int:
    """Bytes of (dtype, shape) pairs; a dtype without a size counts 0, as
    the reference skips an HLO type it does not know."""
    total = 0
    for dt, shape in pairs:
        n = 1
        for d in shape:
            n *= int(d)
        total += n * DTYPE_BYTES.get(dt, 0)
    return total


@dataclass
class CollectiveStats:
    """Per-device estimated bytes moved over the links, by op kind."""
    by_op: dict = field(default_factory=dict)
    count: int = 0

    @property
    def total_bytes(self) -> float:
        return float(sum(self.by_op.values()))

    def add(self, op: str, nbytes: float):
        self.by_op[op] = self.by_op.get(op, 0.0) + nbytes
        self.count += 1


def _collectives(log):
    for r in log:
        if r.kind is not None and not r.done:
            yield r.kind, tensor_bytes(r.results), r.group


def collective_bytes(log) -> CollectiveStats:
    """Per-device bytes moved by each collective of ``log`` (ring
    algorithms; module docstring)."""
    stats = CollectiveStats()
    for op, size, g in _collectives(log):
        if g <= 1 and op != "collective-permute":
            continue
        if op == "all-reduce":
            nb = 2.0 * (g - 1) / g * size
        elif op == "all-gather":
            nb = (g - 1) / g * size
        elif op == "reduce-scatter":
            nb = float(g - 1) * size
        elif op == "all-to-all":
            nb = (g - 1) / g * size
        else:  # collective-permute
            nb = float(size)
        stats.add(op, nb)
    return stats


def count_ops(log, opname: str) -> int:
    """Records of ``log`` named ``opname``: an op name with or without its
    overload (``aten.mm.default``, ``aten.mm``) or a collective's
    reference name (``all-reduce``; its ``-done`` half not counted)."""
    n = 0
    for r in log:
        packet = r.op.rsplit(".", 1)[0] if r.op.count(".") >= 2 else r.op
        if opname in (r.op, packet) or (r.kind == opname and not r.done):
            n += 1
    return n


def summarize_collectives(log, top: int = 12) -> list[str]:
    """Human-readable collective schedule lines (op, shape, groupsize), in
    the reference's format."""
    c = Counter(f"{op:20s} bytes={size:>14,d} group={g}"
                for op, size, g in _collectives(log))
    return [f"{k}   x{v}" for k, v in c.most_common(top)]

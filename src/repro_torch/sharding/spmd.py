"""Partition specs, meshes and ``shard_map``: the port's counterparts of
``jax.sharding.PartitionSpec``/``NamedSharding``/``Mesh`` and of
``jax.shard_map`` with the three collectives the reference's MoE bodies use
(``psum``, ``all_to_all``, ``axis_index``).

A per-shard body is written once, as a generator function: it ``yield``s
each collective it needs (``psum(t, axes)``, ``all_to_all(t, axis, split,
concat, tiled)``, ``axis_index(axis)``) and receives its result; it
``return``s its outputs.  ``shard_map(body, mesh, in_specs, out_specs)``
runs it under one of two bindings, chosen by the mesh:

- **single-process** (a ``Mesh`` below, a grid of torch devices that may
  all be one card, or the CPU): every shard lives in this process.  The
  global inputs are split by ``in_specs`` (views, no copies), the shards'
  bodies are stepped in lockstep to their next collective, the collective
  is performed across them, and the outputs are reassembled by
  ``out_specs``.  It is the counterpart of ``shard_map`` over forced host
  devices, and what runs the production meshes on one H100.
- **torch.distributed** (a ``torch.distributed.device_mesh.DeviceMesh``
  with ``mesh_dim_names``): this process is one shard.  Every rank passes
  the global inputs; the rank takes its block by its mesh coordinate, runs
  the body with the collectives of the mesh dims' process groups
  (functional collectives), and all-gathers the outputs by ``out_specs``,
  so every rank returns the global result.

A dim sharded over several axes, ``("model", "data")``, is split
major-to-minor in the spec's order on both bindings, as ``shard_map``
does.  DTensor orders the shards of one dim by mesh-dim index instead
(data-major on a ``("data", "model")`` mesh): per-device shapes agree,
block ownership does not.  ``NamedSharding.placements`` hands DTensor its
own order; nothing in the port reads ownership of such a dim.

``all_to_all`` has ``jax.lax.all_to_all``'s semantics.  Tiled: the split
dim is cut into one block per shard of ``axis``; block ``j`` goes to shard
``j``; the blocks received are concatenated along ``concat`` in the order
of their sources.  Not tiled: ``t.shape[split]`` equals the axis size, the
split dim is removed, and a new dim indexed by the source shard is
inserted at ``concat`` of the result.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

Axes = Union[None, str, Tuple[str, ...]]


def _norm(part) -> Axes:
    """PartitionSpec's normalisation of one entry: a 1-tuple is its axis,
    an empty tuple is ``None``."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        if not part:
            return None
        if len(part) == 1:
            return part[0]
    return part


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    a mesh axis name, or a tuple of them (major to minor).  Trailing dims
    without an entry are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_norm(p) for p in parts))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def spec_axes(part: Axes) -> Tuple[str, ...]:
    """The axes of one spec entry, major to minor."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def is_device_mesh(mesh) -> bool:
    """A ``torch.distributed`` DeviceMesh (it names its dims)."""
    return getattr(mesh, "mesh_dim_names", None) is not None


def mesh_shape(mesh) -> dict:
    """{axis name: size} in mesh order, for a ``Mesh``, a named
    ``DeviceMesh`` or any mesh with ``axis_names`` and a ``shape`` mapping
    (``jax.sharding.AbstractMesh`` among them)."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    return tuple(mesh_shape(mesh))


class Mesh:
    """A mesh of the single-process binding: an n-d grid of torch devices
    (all ``cuda:0`` on one H100) with a name per grid dim."""

    def __init__(self, devices, axis_names: Tuple[str, ...]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: the counterpart of ``NamedSharding``."""

    mesh: Any
    spec: P

    def shard_shape(self, global_shape) -> tuple:
        """The per-device shape of a ``global_shape`` tensor."""
        sizes = mesh_shape(self.mesh)
        out = list(global_shape)
        for d, part in enumerate(self.spec):
            n = math.prod(sizes[a] for a in spec_axes(part))
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(global_shape)} does not "
                                 f"divide into {n} shards ({self.spec})")
            out[d] //= n
        return tuple(out)

    @property
    def placements(self) -> tuple:
        """The DTensor placements: ``Shard(d)`` on each mesh dim that
        shards tensor dim ``d``, ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {a: d for d, part in enumerate(self.spec)
                  for a in spec_axes(part)}
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in axis_names(self.mesh))


def with_sharding_constraint(t, sharding: Optional[NamedSharding]):
    """The reference's layout hint: a DTensor is redistributed to
    ``sharding``; a plain tensor (the single-process binding holds global
    tensors) is returned as it is."""
    from torch.distributed.tensor import DTensor

    if sharding is None or not isinstance(t, DTensor):
        return t
    return t.redistribute(sharding.mesh, sharding.placements)


# --------------------------------------------------------------------------
# Collectives a body yields
# --------------------------------------------------------------------------
class Collective(NamedTuple):
    op: str                      # "psum" | "all_to_all" | "axis_index"
    tensor: Optional[torch.Tensor]
    axes: Tuple[str, ...]
    split: int = 0
    concat: int = 0
    tiled: bool = False


def psum(t: torch.Tensor, axes) -> Collective:
    """Sum of ``t`` over the shards of ``axes`` (a name or a tuple)."""
    return Collective("psum", t, spec_axes(_norm(axes)))


def all_to_all(t: torch.Tensor, axis: str, split: int, concat: int,
               tiled: bool = False) -> Collective:
    """``jax.lax.all_to_all(t, axis, split, concat, tiled=tiled)``."""
    return Collective("all_to_all", t, (axis,), split, concat, tiled)


def axis_index(axis: str) -> Collective:
    """This shard's index along ``axis``."""
    return Collective("axis_index", None, (axis,))


def run_alone(gen):
    """Run a body's generator as the only shard of a one-device mesh: every
    axis has size 1, so a psum or an all-to-all returns its input and the
    axis index is 0."""
    value = None
    while True:
        try:
            req = gen.send(value)
        except StopIteration as stop:
            return stop.value
        if req.op == "axis_index":
            value = 0
        elif req.op == "psum":
            value = req.tensor
        else:
            value = _exchange([req.tensor], req.split, req.concat,
                              req.tiled)[0]


# --------------------------------------------------------------------------
# Specs over pytrees of dicts, tuples and lists
# --------------------------------------------------------------------------
def _map_specs(fn: Callable, specs, tree):
    if isinstance(specs, P):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], tree[k]) for k in specs}
    if isinstance(specs, (tuple, list)):
        return type(specs)(_map_specs(fn, s, t) for s, t in zip(specs, tree))
    raise TypeError(f"not a spec tree: {specs!r}")


def _block(t: torch.Tensor, spec: P, coord: dict, sizes: dict):
    """The block of global ``t`` that the shard at ``coord`` holds (a
    view)."""
    for d, part in enumerate(spec):
        axes = spec_axes(part)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"into {n} shards ({spec})")
        c = t.shape[d] // n
        t = t.narrow(d, idx * c, c)
    return t


# --------------------------------------------------------------------------
# The single-process binding
# --------------------------------------------------------------------------
def _exchange(ts: list, split: int, concat: int, tiled: bool) -> list:
    """``all_to_all`` across the shards of one group, in axis order."""
    n = len(ts)
    out = []
    for j in range(n):
        if tiled:
            chunks = [t.chunk(n, dim=split)[j] for t in ts]
            out.append(torch.cat(chunks, dim=concat))
        else:
            out.append(torch.stack([t.select(split, j) for t in ts],
                                   dim=concat))
    return out


def _groups(coords: list, axes: Tuple[str, ...]) -> dict:
    """Shard indices grouped by their coordinates off ``axes``, each group
    in the order of its coordinates on ``axes`` (major to minor)."""
    groups: dict = {}
    for i, c in enumerate(coords):
        key = tuple((a, v) for a, v in c.items() if a not in axes)
        groups.setdefault(key, []).append(i)
    for members in groups.values():
        members.sort(key=lambda i: tuple(coords[i][a] for a in axes))
    return groups


def _perform(reqs: list, coords: list) -> list:
    first = reqs[0]
    for r in reqs:
        if (r.op, r.axes, r.split, r.concat, r.tiled) != (
                first.op, first.axes, first.split, first.concat,
                first.tiled):
            raise RuntimeError(f"shards out of lockstep: {first.op} "
                               f"{first.axes} against {r.op} {r.axes}")
    if first.op == "axis_index":
        return [c[first.axes[0]] for c in coords]
    out = [None] * len(reqs)
    for members in _groups(coords, first.axes).values():
        ts = [reqs[i].tensor for i in members]
        if first.op == "psum":
            total = ts[0]
            for t in ts[1:]:
                total = total + t
            res = [total] * len(ts)
        else:
            res = _exchange(ts, first.split, first.concat, first.tiled)
        for i, r in zip(members, res):
            out[i] = r
    return out


def _assemble(outs: list, coords: list, spec: P, sizes: dict):
    """The global tensor of the shards' blocks ``outs`` under ``spec``;
    a mesh axis the spec does not name is replicated (shard 0's copy)."""
    index = {tuple(c.values()): i for i, c in enumerate(coords)}
    names = list(sizes)
    sharded = [(d, spec_axes(part)) for d, part in enumerate(spec)
               if spec_axes(part)]

    def leaf(blocks: tuple):
        coord = dict.fromkeys(names, 0)
        for (_, axes), b in zip(sharded, blocks):
            for a in reversed(axes):
                coord[a] = b % sizes[a]
                b //= sizes[a]
        return outs[index[tuple(coord[a] for a in names)]]

    def cat(k: int, blocks: tuple):
        if k == len(sharded):
            return leaf(blocks)
        d, axes = sharded[k]
        n = math.prod(sizes[a] for a in axes)
        return torch.cat([cat(k + 1, blocks + (b,)) for b in range(n)],
                         dim=d)

    return cat(0, ())


def _run_local(body, mesh: Mesh, in_specs, out_specs, args):
    sizes = mesh_shape(mesh)
    coords = [dict(zip(sizes, c)) for c in
              itertools.product(*(range(s) for s in sizes.values()))]
    gens = [body(*_map_specs(lambda s, t: _block(t, s, c, sizes),
                             in_specs, args)) for c in coords]
    values = [None] * len(gens)
    while True:
        reqs, outs = [], []
        for i, g in enumerate(gens):
            v, values[i] = values[i], None  # the body decides its lifetime
            try:
                reqs.append(g.send(v))
            except StopIteration as stop:
                outs.append(stop.value)
        if outs:
            if reqs:
                raise RuntimeError("shards out of lockstep: some returned "
                                   "while others wait on a collective")
            break
        values = _perform(reqs, coords)

    return _assemble_tree(out_specs, outs, coords, sizes)


def _assemble_tree(specs, outs: list, coords: list, sizes: dict):
    if isinstance(specs, P):
        return _assemble(outs, coords, specs, sizes)
    if isinstance(specs, dict):
        return {k: _assemble_tree(s, [o[k] for o in outs], coords, sizes)
                for k, s in specs.items()}
    return type(specs)(_assemble_tree(s, [o[i] for o in outs], coords, sizes)
                       for i, s in enumerate(specs))


# --------------------------------------------------------------------------
# The torch.distributed binding
# --------------------------------------------------------------------------
def _collective_dist(req: Collective, mesh, coord: dict):
    import torch.distributed._functional_collectives as funcol

    if req.op == "axis_index":
        return coord[req.axes[0]]
    t = req.tensor.contiguous()
    if req.op == "psum":
        for a in req.axes:
            t = funcol.wait_tensor(
                funcol.all_reduce(t, "sum", mesh.get_group(a)))
        return t
    (a,) = req.axes
    n = mesh_shape(mesh)[a]
    moved = t.movedim(req.split, 0).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(
        moved, None, None, mesh.get_group(a)))
    if not req.tiled:  # got[s] is source s's slice
        return got.movedim(0, req.concat)
    parts = got.reshape(n, moved.shape[0] // n, *moved.shape[1:]).unbind(0)
    return torch.cat([p.movedim(0, req.split) for p in parts],
                     dim=req.concat)


def _gather_dist(t: torch.Tensor, spec: P, mesh):
    import torch.distributed._functional_collectives as funcol

    for d, part in enumerate(spec):
        for a in reversed(spec_axes(part)):  # minor axis first
            t = funcol.wait_tensor(funcol.all_gather_tensor(
                t.contiguous(), d, mesh.get_group(a)))
    return t


def _run_distributed(body, mesh, in_specs, out_specs, args):
    sizes = mesh_shape(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    gen = body(*_map_specs(lambda s, t: _block(t, s, coord, sizes),
                           in_specs, args))
    value = None
    while True:
        try:
            req = gen.send(value)
        except StopIteration as stop:
            outs = stop.value
            break
        value = _collective_dist(req, mesh, coord)
    return _map_specs(lambda s, t: _gather_dist(t, s, mesh), out_specs, outs)


def shard_map(body, mesh, in_specs, out_specs):
    """``jax.shard_map(body, mesh=mesh, in_specs=..., out_specs=...)`` for a
    generator ``body`` (module docstring).  Spec trees are ``P`` leaves in
    dicts, tuples and lists matching the arguments and outputs."""
    run = _run_distributed if is_device_mesh(mesh) else _run_local

    def mapped(*args):
        return run(body, mesh, in_specs, out_specs, args)

    return mapped

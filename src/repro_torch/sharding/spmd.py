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
  so every rank returns the global result.  Given DTensors, a rank's
  block is its local shard after a redistribute to ``in_specs``, and the
  outputs are returned as DTensors placed by ``out_specs``, not
  gathered.  Its gradient takes each rank's backward as one term of a
  sum: an input replicated over a mesh dim gets partial sums over it, an
  output replicated over ``n`` ranks hands each ``1/n`` of its gradient,
  and ``psum`` and ``all_to_all`` are their own adjoints.  (The
  reference's ``shard_map`` tracks which values vary across a mesh dim
  and transposes ``psum`` to a broadcast; this binding does not track
  it, so its backward all-reduces where the reference's broadcasts.)

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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
        shards tensor dim ``d``, ``Replicate()`` on the others and on a
        mesh dim of size 1 (one shard is the whole; DTensor would refuse
        to view a size-1 dim "sharded" over it away)."""
        sizes = mesh_shape(self.mesh)
        dim_of = {a: d for d, part in enumerate(self.spec)
                  for a in spec_axes(part)}
        return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1
                     else Replicate() for a in axis_names(self.mesh))


def with_sharding_constraint(t, sharding: Optional[NamedSharding]):
    """The reference's layout hint: a DTensor is redistributed to
    ``sharding``, and so is its gradient, as XLA constrains the cotangent
    of a constrained value too (DTensor alone would carry the gradient's
    partial sums on, and the next product's backward would gather its
    weight instead of reducing them); a plain tensor (the single-process
    binding holds global tensors) is returned as it is."""
    if sharding is None or not isinstance(t, DTensor):
        return t
    return _Constrain.apply(t, sharding.mesh, sharding.placements)


def hold_layout(t):
    """A DTensor as it is, whose gradient is redistributed to its layout
    (XLA gives a cotangent its primal's sharding); a plain tensor as it
    is.  Where a product shards a dim its producer replicated (attention
    heads that do not divide the model axis, an output projection whose
    rows do), DTensor would hand the producer's backward a sharded
    gradient that its view cannot split."""
    if not isinstance(t, DTensor):
        return t
    return _Constrain.apply(t, t.device_mesh, t.placements)


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return t.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def keep_shards(placements, dims: dict) -> tuple:
    """Placements for a tensor laid out along ``placements`` (those of
    another tensor) at the dims named in ``dims``, {dim there: dim here}:
    a mesh dim that shards one of those dims shards its image here, every
    other mesh dim replicates."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in placements)


def on_shards(fn, mesh, in_placements, out_placements, *args):
    """``fn(*args)`` run by each rank on its local shards, through torch's
    ``local_map``: each tensor argument is redistributed to its entry of
    ``in_placements`` (a plain tensor is taken as replicated), and each
    output comes back as a DTensor placed by ``out_placements`` (one
    tuple of placements an output, or a list for a single output).  A
    function independent along the sharded dims (batch rows, heads,
    channels) so computes the global result; one that needs the other
    shards reduces over them itself (``all_reduce_over``).  An argument
    replicated over a mesh dim that shards an output (or leaves it
    partial) gets its gradient as partial sums over that dim, one from
    each rank's output: ``local_map``'s ``in_grad_placements``."""
    rep = (Replicate(),) * mesh.ndim
    args = tuple(DTensor.from_local(a, mesh, rep, run_check=False)
                 if isinstance(a, torch.Tensor)
                 and not isinstance(a, DTensor) else a for a in args)
    in_pl = tuple(pl if isinstance(a, torch.Tensor) else None
                  for a, pl in zip(args, in_placements))
    outs = (out_placements,) if isinstance(out_placements, list) \
        else out_placements
    differ = [any(isinstance(o[d], Shard) or o[d].is_partial() for o in outs)
              for d in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and differ[d] else p
        for d, p in enumerate(pl)) for pl in in_pl)
    return local_map(fn, out_placements, in_pl, grad_pl, mesh,
                     redistribute_inputs=True)(*args)


def all_reduce_over(t: torch.Tensor, mesh, dims, op: str = "sum"):
    """A local tensor ``t`` reduced (``"sum"`` or ``"max"``) across the
    ranks of the mesh dims ``dims``, inside ``on_shards``."""
    import torch.distributed._functional_collectives as funcol

    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op,
                                                 (mesh, d)))
    return t


def reduce_partial(t):
    """A DTensor's pending partial sums (or maxima) reduced now, each
    partial mesh dim made replicated; a plain tensor as it is.  Left to
    itself, DTensor often reduce-scatters a reduction's partials over
    another dim (the sequence), and every later op and its gradient
    follows that layout."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def replicate_dim(t, dim: int):
    """A DTensor with its dim ``dim`` gathered on every mesh dim that
    shards it (the rest of its placements kept); a plain tensor as it
    is.  DTensor cannot view a sharded dim as [n, size/n] unless n
    divides into its shards, so a dim is gathered before such a view."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in t.placements])


def lookup_rows(table, ids, lookup, dim: int):
    """``lookup(table, ids)``, which reads ``table`` at ``ids`` along its
    dim ``dim`` (the embedding's rows, a gather's last dim), for a
    DTensor ``table`` that one mesh dim shards over that dim: each rank
    looks up the ids its block holds, zeros the others, and the partial
    sums over that mesh dim are reduced.  (DTensor's own masked partials
    cannot be reduced once another op has run, nor differentiated back
    into a plain partial.)  Returns None where ``table`` is not such a
    DTensor: the caller then runs ``lookup`` itself.  ``lookup(t, i)`` takes local tensors and is given
    ids clamped into the block; its result has ``ids``'s dims first."""
    if not isinstance(table, DTensor):
        return None
    dim %= table.dim()
    mds = [i for i, p in enumerate(table.placements)
           if isinstance(p, Shard) and p.dim == dim]
    if len(mds) != 1:
        return None
    (md,) = mds
    mesh = table.device_mesh
    rows = table.to_local().shape[dim]
    first = mesh.get_coordinate()[md] * rows
    n_ids = ids.dim()
    id_pl = tuple(p if i != md and isinstance(p, Shard) and p.dim < n_ids
                  else Replicate()
                  for i, p in enumerate(getattr(ids, "placements",
                                                (Replicate(),) * mesh.ndim)))

    def local(t, i):
        i = i.long() - first
        ok = (i >= 0) & (i < rows)
        val = lookup(t, i.clamp(0, rows - 1))
        return val * ok.reshape(ok.shape + (1,) * (val.dim() - ok.dim())
                                ).to(val.dtype)

    out = on_shards(local, mesh, (table.placements, id_pl),
                    [Partial() if i == md else p for i, p in enumerate(id_pl)],
                    table, ids)
    return out.redistribute(mesh, [Replicate() if i == md else p
                                   for i, p in enumerate(out.placements)])


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
class _SelfAdjoint(torch.autograd.Function):
    """A collective that is its own adjoint: an all-reduce's sum, or an
    all-to-all of equal blocks.  Its backward is the same collective on
    the gradient."""

    @staticmethod
    def forward(ctx, t, run):
        ctx.run = run
        return run(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.run(grad.contiguous()), None


def _collective_dist(req: Collective, mesh, coord: dict):
    import torch.distributed._functional_collectives as funcol

    if req.op == "axis_index":
        return coord[req.axes[0]]
    t = req.tensor.contiguous()
    if req.op == "psum":
        for a in req.axes:
            t = _SelfAdjoint.apply(t, lambda u, g=mesh.get_group(a):
                                   funcol.wait_tensor(
                                       funcol.all_reduce(u, "sum", g)))
        return t
    (a,) = req.axes
    n = mesh_shape(mesh)[a]
    moved = t.movedim(req.split, 0).contiguous()
    got = _SelfAdjoint.apply(moved, lambda u, g=mesh.get_group(a):
                             funcol.wait_tensor(funcol.all_to_all_single(
                                 u, None, None, g)))
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


class _ShareGrad(torch.autograd.Function):
    """Identity; the gradient is divided by ``n``, the ranks that hold
    the value replicated, so that their gradients sum to it."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def _run_distributed(body, mesh, in_specs, out_specs, args):
    sizes = mesh_shape(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    dtensors = any(isinstance(t, DTensor) for t in _leaves(args))

    def block(spec, t):
        if isinstance(t, DTensor):
            # its block by DTensor's own layout; each rank's gradient is
            # one term of the sum over the mesh dims that replicate it
            pl = NamedSharding(mesh, spec).placements
            return t.redistribute(mesh, pl).to_local(grad_placements=[
                Partial() if isinstance(p, Replicate) else p for p in pl])
        return _block(t, spec, coord, sizes)

    gen = body(*_map_specs(block, in_specs, args))
    value = None
    while True:
        try:
            req = gen.send(value)
        except StopIteration as stop:
            outs = stop.value
            break
        value = _collective_dist(req, mesh, coord)
    if dtensors:  # the outputs stay sharded, as DTensors

        def out(spec, t):
            pl = NamedSharding(mesh, spec).placements
            n = math.prod(mesh.size(d) for d, p in enumerate(pl)
                          if isinstance(p, Replicate))
            if n > 1 and t.requires_grad:
                t = _ShareGrad.apply(t, n)
            return DTensor.from_local(t, mesh, pl, run_check=False)

        return _map_specs(out, out_specs, outs)
    return _map_specs(lambda s, t: _gather_dist(t, s, mesh), out_specs, outs)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_map(body, mesh, in_specs, out_specs):
    """``jax.shard_map(body, mesh=mesh, in_specs=..., out_specs=...)`` for a
    generator ``body`` (module docstring).  Spec trees are ``P`` leaves in
    dicts, tuples and lists matching the arguments and outputs."""
    run = _run_distributed if is_device_mesh(mesh) else _run_local

    def mapped(*args):
        return run(body, mesh, in_specs, out_specs, args)

    return mapped

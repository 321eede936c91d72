"""The port's sharding rules, production meshes and cell specs
(``repro_torch.sharding``, ``launch/{mesh,specs}.py``) against the
reference's on the CPU.

Specs are compared bitwise, leaf for leaf by path: the port's ``P`` tuples
against the reference's ``PartitionSpec``s taken on
``jax.sharding.AbstractMesh`` (no devices), for every registry config on
both production meshes, ``param_specs`` in ``tp`` and ``fsdp`` under
``MOE_MODE`` ``tp`` and ``ep_decode``, ``train_state_specs``,
``cache_specs``, and the cells' ``batch_specs``/``input_shardings``/
``output_shardings``/``default_microbatches`` for every ``SHAPES`` cell.
``input_specs``' ``meta`` tensors are held to the reference's
``ShapeDtypeStruct``s (shape and dtype).  Under a fake process group of
world size 256, distributing ``meta`` tensors by ``named()``'s DTensor
placements gives ``shard_shape``'s local shapes.

The reference's abstract inputs (``input_specs`` for every cell, ~18 s)
are built once, in a module-scoped fixture.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import torch.utils._pytree as pytree  # noqa: E402
from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.configs import all_configs as ref_configs  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.sharding import rules as RR  # noqa: E402
from repro_torch.configs import SHAPES, all_configs  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_region_mesh)
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding.spmd import P, NamedSharding  # noqa: E402

ARCHS = sorted(all_configs())
MESHES = ("pod", "multi_pod")
DECODE_SHAPES = [n for n, s in SHAPES.items() if s.is_decode]


def _ref_mesh(which):
    if which == "multi_pod":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _mesh(which):
    return make_production_mesh(multi_pod=which == "multi_pod", device="cpu")


def _key(entry) -> str:
    k = getattr(entry, "key", None)
    return str(k if k is not None else getattr(entry, "idx"))


def _ref_leaves(tree) -> dict:
    """{path: leaf} of a reference tree (PartitionSpecs are leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_key(e) for e in path): leaf for path, leaf in flat}


def _port_leaves(tree) -> dict:
    flat = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(e) for e in path): leaf for path, leaf in flat}


def _spec(x) -> tuple:
    """A spec or a sharding's spec as a plain tuple."""
    if isinstance(x, (NamedSharding, jax.sharding.NamedSharding)):
        x = x.spec
    return tuple(x)


def _assert_specs_equal(got, want):
    g, w = _port_leaves(got), _ref_leaves(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    bad = {p: (_spec(g[p]), _spec(w[p])) for p in w
           if _spec(g[p]) != _spec(w[p])}
    assert not bad, bad


@pytest.fixture(scope="module")
def ref_args():
    return {(a, s): RS.input_specs(ref_configs()[a], RSHAPES[s])
            for a in ARCHS for s in SHAPES}


@pytest.fixture(scope="module")
def port_args():
    return {(a, s): S.input_specs(all_configs()[a], SHAPES[s])
            for a in ARCHS for s in SHAPES}


@pytest.fixture(params=["tp", "ep_decode"])
def moe_mode(request, monkeypatch):
    monkeypatch.setattr(RM, "MOE_MODE", request.param)
    monkeypatch.setattr(M, "MOE_MODE", request.param)
    return request.param


def test_production_and_region_meshes():
    for which, shape in (("pod", {"data": 16, "model": 16}),
                         ("multi_pod", {"pod": 2, "data": 16, "model": 16})):
        mesh = _mesh(which)
        assert mesh.shape == shape == dict(_ref_mesh(which).shape)
        assert mesh.axis_names == _ref_mesh(which).axis_names
        assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    grid = np.array([["cpu", "cpu"], ["cpu", "meta"]], dtype=object)
    region = make_region_mesh(grid)
    assert region.shape == {"data": 2, "model": 2}
    assert region.devices[1, 1] == torch.device("meta")
    assert R.data_axes(_mesh("multi_pod")) == ("pod", "data")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_production_mesh()


def test_spec_normalisation_matches_partition_spec():
    for parts in ((), (None, None), ((),), (("data",), None), (["data"],),
                  (("pod", "data"), "model"), (("model", "data"),)):
        assert tuple(P(*parts)) == tuple(jax.sharding.PartitionSpec(*parts))


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, which, moe_mode, ref_args,
                                     port_args):
    cfg, rcfg = all_configs()[arch], ref_configs()[arch]
    params, rparams = port_args[arch, "prefill_32k"][0], \
        ref_args[arch, "prefill_32k"][0]
    for mode in ("tp", "fsdp"):
        _assert_specs_equal(
            R.param_specs(cfg, _mesh(which), params, mode=mode),
            RR.param_specs(rcfg, _ref_mesh(which), rparams, mode=mode))


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_reference(arch, which, ref_args, port_args):
    state = port_args[arch, "train_4k"][0]
    rstate = ref_args[arch, "train_4k"][0]
    _assert_specs_equal(
        R.train_state_specs(all_configs()[arch], _mesh(which), state),
        RR.train_state_specs(ref_configs()[arch], _ref_mesh(which), rstate))


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, which, shape, ref_args,
                                     port_args):
    cache, rcache = port_args[arch, shape][1], ref_args[arch, shape][1]
    _assert_specs_equal(
        R.cache_specs(all_configs()[arch], _mesh(which), cache),
        RR.cache_specs(ref_configs()[arch], _ref_mesh(which), rcache))


def _sds_leaves(tree) -> dict:
    return {p: (tuple(x.shape), str(x.dtype))
            for p, x in _ref_leaves(tree).items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes_and_dtypes_match_reference(arch, shape, ref_args,
                                                       port_args):
    got, want = port_args[arch, shape], ref_args[arch, shape]
    if SHAPES[shape].is_decode:
        # the PRNG key's slot holds the port's optional generator: None
        assert got[3] is None and want[3].shape == ()
        got, want = got[:3], want[:3]
    g = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
         if isinstance(x, torch.Tensor) else ((), "int32")  # cache "pos"
         for p, x in _port_leaves(got).items()}
    assert g == _sds_leaves(want)
    for x in _port_leaves(got).values():
        assert not isinstance(x, torch.Tensor) or x.device.type == "meta"


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shardings_match_reference(arch, shape, which, ref_args,
                                        port_args, monkeypatch):
    cfg, rcfg = all_configs()[arch], ref_configs()[arch]
    sh, rsh = SHAPES[shape], RSHAPES[shape]
    mesh, rmesh = _mesh(which), _ref_mesh(which)
    args, rargs = port_args[arch, shape], ref_args[arch, shape]
    for mode in ("tp", "ep_decode"):
        monkeypatch.setattr(RM, "MOE_MODE", mode)
        monkeypatch.setattr(M, "MOE_MODE", mode)
        for sh_mode in ("tp", "fsdp"):
            _assert_specs_equal(
                S.input_shardings(cfg, sh, mesh, args, sh_mode),
                RS.input_shardings(rcfg, rsh, rmesh, rargs, sh_mode))
            _assert_specs_equal(
                S.output_shardings(cfg, sh, mesh, args, sh_mode),
                RS.output_shardings(rcfg, rsh, rmesh, rargs, sh_mode))
    if not sh.is_decode:
        batch, rbatch = args[1], rargs[1]
        _assert_specs_equal(R.batch_specs(cfg, sh, mesh, batch),
                            RR.batch_specs(rcfg, rsh, rmesh, rbatch))
    assert S.default_microbatches(cfg, sh, mesh) == \
        RS.default_microbatches(rcfg, rsh, rmesh)
    assert S.cell_opt(cfg).state_dtype == RS.cell_opt(rcfg).state_dtype


def test_named_shard_shapes_match_reference_and_dtensor(port_args):
    """Every distinct (shape, spec) of the param (tp, fsdp), train-state
    and cache specs on the 16x16 mesh: ``shard_shape`` equals the
    reference's ``NamedSharding.shard_shape``, and a ``meta`` tensor
    distributed by ``named().placements`` under a fake process group of
    world size 256 has that local shape on rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh, rmesh = _mesh("pod"), _ref_mesh("pod")
    pairs = set()
    for arch in ARCHS:
        cfg = all_configs()[arch]
        trees = [(R.param_specs(cfg, mesh, port_args[arch, "prefill_32k"][0],
                                mode=m), port_args[arch, "prefill_32k"][0])
                 for m in ("tp", "fsdp")]
        state = port_args[arch, "train_4k"][0]
        trees.append((R.train_state_specs(cfg, mesh, state), state))
        for shape in DECODE_SHAPES:
            cache = port_args[arch, shape][1]
            trees.append((R.cache_specs(cfg, mesh, cache), cache))
        for specs, tree in trees:
            sp, tr = _port_leaves(specs), _port_leaves(tree)
            pairs.update((tuple(tr[p].shape), tuple(sp[p]), tr[p].dtype)
                         for p in sp if isinstance(tr[p], torch.Tensor))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        dmesh = init_device_mesh("cpu", (16, 16),
                                 mesh_dim_names=("data", "model"))
        for shape, spec, dtype in sorted(pairs, key=str):
            want = jax.sharding.NamedSharding(
                rmesh, jax.sharding.PartitionSpec(*spec)).shard_shape(shape)
            assert R.named(mesh, P(*spec)).shard_shape(shape) == want
            local = distribute_tensor(
                torch.empty(shape, dtype=dtype, device="meta"), dmesh,
                R.named(dmesh, P(*spec)).placements,
                src_data_rank=None).to_local()
            assert tuple(local.shape) == want, (shape, spec)
    finally:
        dist.destroy_process_group()
    assert len(pairs) > 100


@pytest.mark.parametrize("dims,names,spec", [
    ((2, 4), ("data", "model"), P(None, None, ("model", "data"))),
    ((2, 4), ("data", "model"), P(None, ("model", "data"), None)),
    ((2, 4), ("data", "model"), P(("data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), P(None, ("model", "pod", "data"))),
    ((2, 2, 2), ("pod", "data", "model"), P(("model", "data"), "pod")),
    ((2, 1, 2), ("pod", "data", "model"), P(None, ("model", "pod", "data"))),
], ids=["w1-2x4", "w2-2x4", "mesh-order-2x4", "w1-2x2x2", "mixed-2x2x2",
        "w1-2x1x2"])
@pytest.mark.parametrize("order", ["torch", "mesh-major"])
def test_multi_axis_dims_are_placed_in_the_spec_order(dims, names, spec, order,
                                                      monkeypatch):
    """A dim sharded over several axes is split major-to-minor in the
    spec's order, as the reference's ``shard_map`` does and as the port's
    single-process binding does (``spmd._block``, held to it by
    ``test_torch_moe_mesh.py``): ``named().placements`` hands DTensor
    ``_StridedShard``s where the mesh order differs, and every mesh
    coordinate's DTensor shard is the block ``_block`` gives it.  That
    holds where DTensor takes a ``_StridedShard`` (``spmd.SPEC_ORDER``,
    torch 2.13 on); on older torch, or with ``order="mesh-major"``, the
    placements are ``Shard``s and each shard is the block of the spec with
    every dim's axes in mesh order, DTensor's own (ROADMAP §C.4)."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.sharding import spmd
    from repro_torch.sharding.spmd import _block, spec_axes

    if order == "mesh-major":
        monkeypatch.setattr(spmd, "SPEC_ORDER", False)
    sizes = dict(zip(names, dims))
    mesh = make_region_mesh(np.full(dims, "cpu", dtype=object), names)
    pl = NamedSharding(mesh, spec).placements
    shape = (4, 16, 32)[3 - len(spec):]
    full = torch.arange(int(np.prod(shape))).reshape(shape)
    mixed = any(list(a) != sorted(a, key=names.index)
                for a in map(spec_axes, spec))
    assert any(isinstance(p_, _StridedShard) for p_ in pl) == (
        mixed and spmd.SPEC_ORDER)
    if not spmd.SPEC_ORDER:
        spec = P(*(tuple(sorted(spec_axes(x), key=names.index)) or None
                   for x in spec))
    for coord in np.ndindex(*dims):
        local, offset = _compute_local_shape_and_global_offset(
            shape, dims, list(coord), pl)
        want = _block(full, spec, dict(zip(names, coord)), sizes)
        got = full
        for d, (n, o) in enumerate(zip(local, offset)):
            got = got.narrow(d, o, n)
        assert torch.equal(got, want), (coord, pl)

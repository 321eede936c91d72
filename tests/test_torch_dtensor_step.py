"""The model stack on real DTensors: ``specs.step_fn`` run by 4 CPU ranks
under ``gloo`` on meshes 2x2 and 1x4, its inputs placed by
``specs.input_shardings`` and its outputs by ``output_shardings`` (the
layout the dry run analyses), gathered and held against the same step on
plain tensors (a one-device mesh), which the model tests hold against the
reference.

Every cell of the reduced configs runs in one spawn of 4 processes: dense
prefill, train (two microbatches) and decode, whose ring is sharded over
its sequence so that attention merges its softmax across the shards; a
windowed ring (``h2o-danube-3-4b``, prefill past the window); the MoE at a
capacity that drops no token (a data shard routes its own tokens with its
own capacity), its decode in both ``MOE_MODE``s; RWKV-6 (its chunked
form on both sides: a DTensor takes it); RG-LRU (``recurrentgemma-9b``);
whisper-tiny.  Caches, logits, the train state and its metrics within
1e-5 of each leaf's largest magnitude (at least 1); tokens, ``pos`` and
``step`` equal.
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import numpy as np  # noqa: E402

TIMEOUT_S = 600
MESHES = ("2x2", "1x4")
TOL = 1e-5

# (arch, cell kind, MOE_MODE)
CELLS = [(a, k, "tp") for a in ("qwen3-8b", "dbrx-132b", "rwkv6-1.6b",
                                "recurrentgemma-9b", "whisper-tiny")
         for k in ("prefill", "train", "decode")]
CELLS += [("h2o-danube-3-4b", "prefill", "tp"),
          ("h2o-danube-3-4b", "decode", "tp"),
          ("dbrx-132b", "decode", "ep_decode")]
CELLS += [("granite-20b", k, "tp") for k in ("prefill", "train", "decode")]
CELLS += [("llava-next-34b", k, "tp") for k in ("prefill", "decode")]
CELLS += [("mixtral-8x22b", k, "tp") for k in ("prefill", "decode")]
CELLS += [("phi4-mini-3.8b", k, "tp") for k in ("prefill", "train")]
CASES = [(a, k, mode, m) for a, k, mode in CELLS for m in MESHES]
# the multi-pod mesh's three axes, ("pod", "data", "model") = 2x1x2: a
# dense and a MoE config, every cell kind
CASES += [(a, k, "tp", "2x1x2") for a in ("qwen3-8b", "dbrx-132b")
          for k in ("prefill", "train", "decode")]

_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_region_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as RW

torch.set_num_threads(1)
rank, world, init, out, cases = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
# prefill runs past the reduced window (16): the ring keeps the last 16
# tokens rotated by 40 mod 16
SHAPES = {"train": ShapeConfig("train_4k", 32, 4, "train"),
          "prefill": ShapeConfig("prefill_32k", 40, 4, "prefill"),
          "decode": ShapeConfig("decode_32k", 64, 4, "decode")}
merges = [0]
all_reduce_over = L.all_reduce_over


def counted(*a, **k):
    merges[0] += 1
    return all_reduce_over(*a, **k)


L.all_reduce_over = counted


def config(arch):
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:  # no token dropped
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def draw(cfg, shape, specs):
    rng = np.random.default_rng(0)

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not t.dtype.is_floating_point:
            if t.dim() == 0:
                return torch.zeros((), dtype=t.dtype)
            return torch.from_numpy(rng.integers(
                0, cfg.vocab_size, t.shape)).to(t.dtype)
        return torch.from_numpy(
            rng.normal(size=t.shape).astype(np.float32) * 0.1).to(t.dtype)

    vals = pytree.tree_map(one, specs)
    if shape.kind == "train":  # second moments are not negative
        vals[0]["v"] = pytree.tree_map(torch.abs, vals[0]["v"])
    if shape.is_decode:  # a ring written round more than once
        vals[1]["pos"] = shape.seq_len + 3
    return vals


def copy(tree):
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def leaves(tree):
    return [np.asarray(t.float() if t.is_floating_point() else t)
            if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in pytree.tree_leaves(tree)]


res, meta = {}, {}
try:
    for arch, kind, mode, ms in json.loads(cases):
        name = f"{arch}-{kind}-{mode}-{ms}"
        M.MOE_MODE = mode
        cfg, shape = config(arch), SHAPES[kind]
        specs = S.input_specs(cfg, shape, param_dtype=torch.float32)
        vals = draw(cfg, shape, specs)
        dims = tuple(int(v) for v in ms.split("x"))
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=(
            ("pod", "data", "model") if len(dims) == 3 else ("data", "model")))
        fn = S.step_fn(cfg, shape, mesh, remat="2level", microbatches=2)
        args = D.distribute(copy(vals), S.input_shardings(cfg, shape, mesh,
                                                          specs))
        merges[0] = 0
        with implicit_replication():
            outs = D.place(fn(*args),
                           S.output_shardings(cfg, shape, mesh, specs))
        n_dt = sum(isinstance(t, DTensor) for t in pytree.tree_leaves(outs))
        got = pytree.tree_map(lambda t: t.full_tensor()
                              if isinstance(t, DTensor) else t, outs)
        if rank == 0:
            plain = S.step_fn(cfg, shape, make_region_mesh([["cpu"]]),
                              remat="2level", microbatches=2)
            # a DTensor takes RWKV-6's chunked form; so does the plain
            # step here, in place of B5's (the forms agree to rounding,
            # tests/test_torch_recurrent_kernels.py)
            b5, RW.ops.rwkv6 = RW.ops.rwkv6, RW.rwkv_time_mix_chunked
            try:
                want = plain(*copy(vals))
            finally:
                RW.ops.rwkv6 = b5
            g, w = leaves(got), leaves(want)
            meta[name] = {"n": len(w), "n_got": len(g), "dtensors": n_dt,
                          "merges": merges[0]}
            for i, (a, b) in enumerate(zip(g, w)):
                res[f"{name}/got/{i}"], res[f"{name}/want/{i}"] = a, b
    if rank == 0:
        np.savez(out + ".npz", **res)
        with open(out + ".json", "w") as f:
            json.dump(meta, f)
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, run once by 4 gloo ranks (meeting through a file store,
    ``torch_gloo.run_ranks``): rank 0's gathered outputs and the plain
    step's, with what each run did."""
    from torch_gloo import run_ranks

    tmp = tmp_path_factory.mktemp("dtensor_step")
    out = str(tmp / "runs")
    run_ranks(_WORKER, [out, json.dumps(CASES)], tmp / "gloo", TIMEOUT_S)
    with open(out + ".json") as f:
        meta = json.load(f)
    return dict(np.load(out + ".npz")), meta


@pytest.mark.parametrize("arch,kind,mode,mesh", CASES,
                         ids=["-".join(c) for c in CASES])
def test_sharded_step_matches_plain(runs, arch, kind, mode, mesh):
    arrays, meta = runs
    name = f"{arch}-{kind}-{mode}-{mesh}"
    m = meta[name]
    assert m["n_got"] == m["n"] > 0
    assert m["dtensors"] > 0  # the step ran on DTensors
    if kind == "decode" and arch != "rwkv6-1.6b":
        # the ring is sharded over its sequence: the softmax was merged
        assert m["merges"] > 0
    for i in range(m["n"]):
        got, want = arrays[f"{name}/got/{i}"], arrays[f"{name}/want/{i}"]
        assert got.shape == want.shape, (name, i)
        if np.issubdtype(want.dtype, np.floating):
            scale = max(1.0, float(np.abs(want).max(initial=0.0)))
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                                       err_msg=f"{name} leaf {i}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {i}")

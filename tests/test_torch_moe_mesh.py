"""The port's MoE over a mesh (``models/moe.py``: ``moe_ffn(mesh)``,
``moe_ffn_decode_ep``, ``moe_ep_ffn``, and ``forward``/``decode_step``/the
train step with ``mesh``) on the CPU, at 1e-5 in f32.

The single-process binding runs meshes 1x2, 1x4, 2x2 and 2x4 against:
- the reference's ``moe_ffn(x, p, moe, mesh)`` and ``moe_ffn_decode_ep``
  under ``jax.shard_map`` over 8 forced host devices.  They are computed
  in ONE subprocess for the file, with ``XLA_FLAGS`` set only in the
  child's environment (the test process keeps its one CPU device), and
  read back from an npz;
- ``moe_ffn_local`` per data shard, for ``moe_ep_ffn``.  The reference's
  ``moe_ep_ffn`` scrambles its expert slots (ROADMAP §C), so the port is
  held to what it means to compute; its output is matched by the port's
  body without the axis move, which pins the fault down;
- a reduced mixtral's ``forward``, ``decode_step`` and loss gradients with
  ``mesh`` against the same calls with ``mesh=None``.

The ``torch.distributed`` binding runs once: 4 spawned CPU processes with
``gloo``, meshes 2x2 and 1x4, against the same numbers.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.launch.mesh import make_region_mesh  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
MESHES = ((1, 2), (1, 4), (2, 2), (2, 4))
CFS = (1.0, 8.0)           # 1.0 drops tokens at these sizes, 8.0 none
E, K, D, F = 8, 2, 16, 32
DIST_MESHES = ((2, 2), (1, 4))
TIMEOUT_S = 240

_REF_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import MoEConfig
from repro.models import moe as RM
inp = dict(np.load(sys.argv[1]))
meshes = [tuple(int(v) for v in s.split("x")) for s in sys.argv[3].split(",")]
cfs = [float(v) for v in sys.argv[4].split(",")]
p = {k: jnp.asarray(inp[k]) for k in ("router", "w1", "w3", "w2")}
out = {}
for shape in meshes:
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    tag = "%dx%d" % shape

    @jax.jit  # one compile a mesh: eager shard_map takes seconds a call
    def run(x, xd, p):
        res = {}
        for cf in cfs:
            moe = MoEConfig(int(inp["E"]), int(inp["K"]), cf)
            res[f"tp_{tag}_{cf}"] = RM.moe_ffn(x, p, moe, mesh)
            res[f"dec_{tag}_{cf}"] = RM.moe_ffn_decode_ep(xd, p, moe, mesh)
            res[f"refep_{tag}_{cf}"] = RM.moe_ep_ffn(x, p, moe, mesh)
        return res

    for k, (y, aux) in run(jnp.asarray(inp["x"]), jnp.asarray(inp["xd"]),
                           p).items():
        out[k + "_y"], out[k + "_aux"] = y, aux
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""

_DIST_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as M
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
try:
    inp = dict(np.load(sys.argv[4]))
    p = {k: torch.tensor(inp[k]) for k in ("router", "w1", "w3", "w2")}
    x, xd = torch.tensor(inp["x"]), torch.tensor(inp["xd"])
    out = {}
    for s in sys.argv[6].split(","):
        shape = tuple(int(v) for v in s.split("x"))
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for cf in [float(v) for v in sys.argv[7].split(",")]:
            moe = MoEConfig(int(inp["E"]), int(inp["K"]), cf)
            for name, fn, xx in (("tp", M.moe_ffn, x),
                                 ("dec", M.moe_ffn_decode_ep, xd),
                                 ("ep", M.moe_ep_ffn, x)):
                y, aux = fn(xx, p, moe, mesh)
                out[f"{name}_{s}_{cf}_y"] = y.numpy()
                out[f"{name}_{s}_{cf}_aux"] = aux.numpy()
    np.savez(f"{sys.argv[5]}.{rank}.npz", **out)
finally:
    dist.destroy_process_group()
"""


def _tag(shape) -> str:
    return "%dx%d" % shape


def _moe(cf) -> MoEConfig:
    return MoEConfig(E, K, cf)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {
        "x": rng.normal(size=(2, 32, D)).astype(np.float32),
        "xd": rng.normal(size=(16, 1, D)).astype(np.float32),
        "router": (rng.normal(size=(D, E)) * 0.02).astype(np.float32),
        "w1": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
        "w3": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32),
        "w2": (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32),
        "E": np.int64(E), "K": np.int64(K),
    }
    path = tmp_path_factory.mktemp("moe_mesh") / "inputs.npz"
    np.savez(path, **inp)
    return path, inp


def _run(args, env, timeout=TIMEOUT_S):
    proc = subprocess.run(args, capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


@pytest.fixture(scope="module")
def ref_out(inputs):
    """The reference's mesh outputs, from one child process with 8 forced
    host devices (``XLA_FLAGS`` in its environment only)."""
    path, _ = inputs
    out = path.with_name("ref_out.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    _run([sys.executable, "-c", _REF_CHILD, str(path), str(out),
          ",".join(map(_tag, MESHES)), ",".join(map(str, CFS))], env)
    return dict(np.load(out))


def _params(inp):
    return {k: torch.tensor(inp[k]) for k in ("router", "w1", "w3", "w2")}


def _mesh(shape):
    return make_region_mesh(np.full(shape, "cpu", dtype=object))


def _local_per_data_shard(x, p, moe, d):
    return torch.cat([M.moe_ffn_local(xb, p, moe)[0]
                      for xb in x.chunk(d, dim=0)])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_ffn_tp_matches_reference(shape, cf, inputs, ref_out):
    _, inp = inputs
    y, aux = M.moe_ffn(torch.tensor(inp["x"]), _params(inp), _moe(cf),
                       _mesh(shape))
    _close(y, ref_out[f"tp_{_tag(shape)}_{cf}_y"])
    _close(aux, ref_out[f"tp_{_tag(shape)}_{cf}_aux"])


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_ffn_decode_ep_matches_reference(shape, cf, inputs, ref_out,
                                             monkeypatch):
    _, inp = inputs
    xd, p, mesh = torch.tensor(inp["xd"]), _params(inp), _mesh(shape)
    want = ref_out[f"dec_{_tag(shape)}_{cf}_y"]
    y, aux = M.moe_ffn_decode_ep(xd, p, _moe(cf), mesh)
    _close(y, want)
    _close(aux, ref_out[f"dec_{_tag(shape)}_{cf}_aux"])
    # moe_ffn dispatches one-token rows there under MOE_MODE="ep_decode"
    monkeypatch.setattr(M, "MOE_MODE", "ep_decode")
    _close(M.moe_ffn(xd, p, _moe(cf), mesh)[0], want)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_ep_ffn_matches_local_per_data_shard(shape, cf, inputs, ref_out):
    _, inp = inputs
    x, p = torch.tensor(inp["x"]), _params(inp)
    y, aux = M.moe_ep_ffn(x, p, _moe(cf), _mesh(shape))
    _close(y, _local_per_data_shard(x, p, _moe(cf), shape[0]))
    # the aux sums are global over the data axes, as TP's
    _close(aux, ref_out[f"tp_{_tag(shape)}_{cf}_aux"])


def _unmoved_ep_local(x, p, moe, model_axis, data_axes, n_ep):
    """``moe_ep_ffn_local`` as the reference writes it: the exchanged
    ``[e_loc, C, n_ep, D]`` reshaped without moving the source axis."""
    B, T, D = x.shape
    e_loc = moe.n_experts // n_ep
    C = M.local_capacity(B * T, moe)
    xe, dest, topk_w, sums = M._dispatch(x.reshape(B * T, D), p, moe, C)
    xr = yield M.all_to_all(xe.reshape(n_ep, e_loc, C, D), model_axis,
                            split=0, concat=2, tiled=False)
    yr = M._experts(xr.reshape(e_loc, n_ep * C, D), p)
    yr = yr.reshape(e_loc, n_ep, C, D).transpose(0, 1)
    ye = yield M.all_to_all(yr, model_axis, split=0, concat=0, tiled=True)
    y = M._combine(ye.reshape(moe.n_experts, C, D), dest, topk_w)
    aux = yield from M._aux(sums, moe.n_experts, data_axes)
    return y.reshape(B, T, D), aux


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_reference_moe_ep_ffn_is_the_unmoved_layout(shape, inputs, ref_out,
                                                    monkeypatch):
    """The reference's ``moe_ep_ffn`` is far from its own TP output, and
    equal to the port's EP body with the source axis left in place: the
    port's ``all_to_all`` has JAX's semantics, and the fault is the
    missing ``moveaxis`` alone."""
    _, inp = inputs
    x, p = torch.tensor(inp["x"]), _params(inp)
    for cf in CFS:
        want = ref_out[f"refep_{_tag(shape)}_{cf}_y"]
        assert np.abs(want - ref_out[f"tp_{_tag(shape)}_{cf}_y"]).max() > 0.1
        monkeypatch.setattr(M, "moe_ep_ffn_local", _unmoved_ep_local)
        _close(M.moe_ep_ffn(x, p, _moe(cf), _mesh(shape))[0], want)
        monkeypatch.undo()


def test_moe_ep_ffn_refuses_experts_off_the_model_axis(inputs):
    _, inp = inputs
    with pytest.raises(ValueError):
        M.moe_ep_ffn(torch.tensor(inp["x"]), _params(inp), MoEConfig(6, K),
                     _mesh((1, 4)))


@pytest.fixture(scope="module")
def mixtral():
    """A reduced mixtral (4 experts, top-2) at a capacity that drops no
    token: a data shard routes its own tokens with its own capacity, so
    only then is the sharded forward the unsharded one."""
    cfg = get_config("mixtral-8x22b").reduced()
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    params = TF.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 12)), dtype=torch.int32)
    with torch.no_grad():
        logits, cache, aux = TF.forward(params, tokens, cfg, want_cache=True,
                                        q_chunk=12)
    return cfg, params, tokens, (logits, cache, aux)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_forward_over_mesh_matches_unsharded(shape, mixtral):
    cfg, params, tokens, (logits, cache, aux) = mixtral
    with torch.no_grad():
        got, got_cache, got_aux = TF.forward(params, tokens, cfg,
                                             mesh=_mesh(shape),
                                             want_cache=True, q_chunk=12)
    _close(got, logits)
    _close(got_aux, aux)
    for a, b in zip(torch.utils._pytree.tree_leaves(got_cache),
                    torch.utils._pytree.tree_leaves(cache)):
        _close(a, b)


@pytest.mark.parametrize("mode", ["tp", "ep_decode"])
def test_decode_step_over_mesh_matches_unsharded(mode, mixtral, monkeypatch):
    cfg, params, tokens, _ = mixtral
    monkeypatch.setattr(M, "MOE_MODE", mode)
    step_none = LM.make_decode_step(cfg)
    step_mesh = LM.make_decode_step(cfg, mesh=_mesh((2, 4)))
    with torch.no_grad():
        caches = [LM.make_prefill_step(cfg, mesh=m, q_chunk=12)(
            params, {"tokens": tokens})[0] for m in (None, _mesh((2, 4)))]
        tok = tokens[:, -1:]
        for _ in range(3):
            want, caches[0] = step_none(params, caches[0], tok)
            got, caches[1] = step_mesh(params, caches[1], tok)
            assert torch.equal(got, want)
            tok = want
    for a, b in zip(torch.utils._pytree.tree_leaves(caches[1]),
                    torch.utils._pytree.tree_leaves(caches[0])):
        _close(a, b)


def test_loss_gradients_over_mesh_match_unsharded(mixtral):
    """Autograd through the single-process binding: every gradient leaf of
    the loss over a 2x2 mesh equals the unsharded one."""
    cfg, params, tokens, _ = mixtral
    batch = {"tokens": tokens, "labels": tokens}

    def grads(mesh):
        flat, spec = torch.utils._pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        loss_fn = LM.make_loss_fn(cfg, mesh=mesh, remat="none", q_chunk=12)
        total, _ = loss_fn(torch.utils._pytree.tree_unflatten(leaves, spec),
                           batch)
        return total, torch.autograd.grad(total, leaves, allow_unused=True,
                                          materialize_grads=True)

    (t0, g0), (t1, g1) = grads(None), grads(_mesh((2, 2)))
    _close(t1.detach(), t0.detach())
    for a, b in zip(g1, g0):
        _close(a, b)


def test_step_fn_train_step_over_mesh_matches_unsharded(mixtral):
    """``launch/specs.step_fn``'s train step over a 2x2 mesh (the mesh to
    the MoE, the ZeRO-1 accumulator and microbatch shardings, 2
    microbatches) against ``make_train_step`` without a mesh: the metrics
    and every state leaf after one step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import cell_opt, step_fn

    cfg, params, tokens, _ = mixtral
    opt = cell_opt(cfg)
    batch = {"tokens": tokens, "labels": tokens}
    shape = ShapeConfig("train_tiny", tokens.shape[1], tokens.shape[0],
                        "train")
    steps = (step_fn(cfg, shape, _mesh((2, 2)), remat="none", q_chunk=12,
                     microbatches=2),
             LM.make_train_step(cfg, opt, remat="none", q_chunk=12,
                                microbatches=2))
    out = []
    for step in steps:
        state = LM.init_train_state(cfg, opt, generator=None, device="cpu",
                                    param_dtype=torch.float32)
        state["params"] = torch.utils._pytree.tree_map(torch.clone, params)
        state["master"] = torch.utils._pytree.tree_map(torch.clone, params)
        out.append(step(state, batch))
    (s1, m1), (s0, m0) = out
    for k in m0:
        _close(m1[k], m0[k])
    for a, b in zip(torch.utils._pytree.tree_leaves(s1),
                    torch.utils._pytree.tree_leaves(s0)):
        _close(a, b)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_distributed_binding_matches_over_gloo(inputs, ref_out):
    """The ``torch.distributed`` binding: 4 ranks under gloo, meshes 2x2
    and 1x4 (``init_device_mesh``), the same numbers as above."""
    path, inp = inputs
    out = path.with_name("dist_out.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = str(_free_port())
    args = [str(path), str(out), ",".join(map(_tag, DIST_MESHES)),
            ",".join(map(str, CFS))]
    procs = [subprocess.Popen([sys.executable, "-c", _DIST_WORKER, str(r),
                               "4", port] + args, env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    logs = []
    try:
        for proc in procs:
            o, e = proc.communicate(timeout=TIMEOUT_S)
            logs.append(o[-2000:] + e[-2000:])
    finally:
        for proc in procs:
            proc.kill()
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(logs)
    x, p = torch.tensor(inp["x"]), _params(inp)
    for rank in range(4):  # every rank returns the global result
        _check_dist(dict(np.load(f"{out}.{rank}.npz")), x, p, ref_out)


def _check_dist(got, x, p, ref_out):
    for shape in DIST_MESHES:
        for cf in CFS:
            t = f"{_tag(shape)}_{cf}"
            _close(got[f"tp_{t}_y"], ref_out[f"tp_{t}_y"])
            _close(got[f"tp_{t}_aux"], ref_out[f"tp_{t}_aux"])
            _close(got[f"dec_{t}_y"], ref_out[f"dec_{t}_y"])
            _close(got[f"dec_{t}_aux"], ref_out[f"dec_{t}_aux"])
            _close(got[f"ep_{t}_y"],
                   _local_per_data_shard(x, p, _moe(cf), shape[0]))
            _close(got[f"ep_{t}_aux"], ref_out[f"tp_{t}_aux"])

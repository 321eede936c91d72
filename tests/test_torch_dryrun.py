"""The port's dry run (``repro_torch.launch.dryrun``) and its collective
analysis (``repro_torch.launch.comm_analysis``) on the CPU.

- (a) ring factors and schedule lines bitwise against the reference's
  ``repro.launch.hlo_analysis``, on seeded collectives written both as
  HLO lines and as op-log records;
- (b) analytic cases under a fake process group: a sharded product that
  needs no collective, a row-parallel one that all-reduces, and the MoE's
  expert-parallel bodies' collectives derived from their shapes;
- (c) the reference's own ``dryrun_cell`` in ONE child process (its module
  sets ``XLA_FLAGS`` when imported, so it is never imported here) on 2x4
  and 2x2x2 meshes with reduced configs, against the port's on the same
  cells: status, skip reasons, key sets, mesh, and the argument, output
  and alias bytes exactly;
- (d) flops: the 1x1 dry run against ``FlopCounterMode`` over a real CPU
  run of the same step, exactly; a 2x4 dry run's per-device flops x 8
  against the 1x1 count, exactly, with the replicated products named;
- (e) the CLI in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import numpy as np  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import comm_analysis as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_region_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.sharding.spmd import Mesh, NamedSharding, P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

# ---------------------------------------------------------------------------
# (a) ring factors and schedule lines against hlo_analysis
# ---------------------------------------------------------------------------
_HLO_DTYPES = {
    "pred": torch.bool, "s8": torch.int8, "u8": torch.uint8,
    "s16": torch.int16, "u16": torch.uint16, "bf16": torch.bfloat16,
    "f16": torch.float16, "s32": torch.int32, "u32": torch.uint32,
    "f32": torch.float32, "s64": torch.int64, "u64": torch.uint64,
    "f64": torch.float64, "c64": torch.complex64, "c128": torch.complex128,
}
_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")


def _collectives(seed: int, n: int = 60):
    """Seeded collectives: (op, [(dtype, dims), ...], group, async)."""
    rng = np.random.default_rng(seed)
    names = sorted(_HLO_DTYPES)
    out = []
    for _ in range(n):
        op = _OPS[rng.integers(len(_OPS))]
        shapes = [(names[rng.integers(len(names))],
                   tuple(int(d) for d in rng.integers(1, 64,
                                                      rng.integers(0, 4))))
                  for _ in range(int(rng.integers(1, 3)))]
        group = int(rng.choice([1, 2, 4, 8, 16]))
        out.append((op, shapes, group, bool(rng.integers(2))))
    return out


def _hlo(colls) -> str:
    lines = ["HloModule m", "ENTRY %main {"]
    for i, (op, shapes, g, is_async) in enumerate(colls):
        parts = [f"{dt}[{','.join(map(str, dims))}]" for dt, dims in shapes]
        res = parts[0] if len(parts) == 1 else "(" + ", ".join(parts) + ")"
        groups = (f"replica_groups=[{16 // g if g <= 16 else 1},{g}]<=[16]"
                  if i % 2 else
                  "replica_groups={{" + ",".join(map(str, range(g))) + "}}")
        name = op + ("-start" if is_async else "")
        lines.append(f"  %c{i} = {res} {name}(%p), {groups}")
        if is_async:
            lines.append(f"  %d{i} = {res} {op}-done(%c{i})")
    lines.append("}")
    return "\n".join(lines)


def _records(colls) -> list:
    log = [C.OpRecord("aten.mm.default",
                      ((torch.float32, (4, 4)),))]  # not a collective
    for op, shapes, g, is_async in colls:
        res = tuple((_HLO_DTYPES[dt], dims) for dt, dims in shapes)
        log.append(C.OpRecord(f"collective.{op}", res, (), g, op))
        if is_async:
            log.append(C.OpRecord("_c10d_functional.wait_tensor.default",
                                  res, res, 1, None, True))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_factors_and_schedule_match_hlo_analysis(seed):
    colls = _collectives(seed)
    assert {op for op, *_ in colls} == set(_OPS)
    assert any(g == 1 for _, _, g, _ in colls)
    assert any(len(s) > 1 for _, s, _, _ in colls)
    hlo, log = _hlo(colls), _records(colls)
    ref, port = H.collective_bytes(hlo), C.collective_bytes(log)
    assert port.by_op == ref.by_op
    assert port.count == ref.count
    assert port.total_bytes == ref.total_bytes
    for top in (3, 12):
        assert C.summarize_collectives(log, top) == \
            H.summarize_collectives(hlo, top)


def test_collective_kinds_and_count_ops():
    assert C.collective_kind("_c10d_functional.all_reduce.default") == \
        ("all-reduce", False)
    assert C.collective_kind("_dtensor.shard_dim_alltoall.default") == \
        ("all-to-all", False)
    assert C.collective_kind("_c10d_functional.wait_tensor.default") == \
        (None, True)
    assert C.collective_kind("aten.mm.default") == (None, False)
    log = _records(_collectives(3))
    assert C.count_ops(log, "aten.mm") == C.count_ops(log,
                                                      "aten.mm.default") == 1
    for op in _OPS:
        assert C.count_ops(log, op) == sum(r.kind == op for r in log)


# ---------------------------------------------------------------------------
# (b) analytic cases under a fake process group
# ---------------------------------------------------------------------------
def _grid(shape, axes=("data", "model")) -> Mesh:
    return Mesh(np.full(shape, "cpu", dtype=object), axes)


def _colls(log) -> list:
    return [(r.kind, C.tensor_bytes(r.results), r.group) for r in log
            if r.kind is not None and not r.done]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_sharded_products_under_fake_256_ranks():
    """x P("data", None) @ w P(None, "model") into P("data", "model"):
    no collective; P(None, "model") @ P("model", None) made replicated:
    one all-reduce of 2*15/16*M*N*2 bytes."""
    Mn = Kn = Nn = 8192
    with D.fake_world(256):
        mesh = D.device_mesh(_grid((16, 16)))
        args = D.distribute((_meta(Mn, Kn), _meta(Kn, Nn)),
                            (NamedSharding(mesh, P("data", None)),
                             NamedSharding(mesh, P(None, "model"))))
        out, log = D.run_logged(lambda x, w: D.place(
            x @ w, NamedSharding(mesh, P("data", "model"))), args)
        assert D.local_bytes(args) == (Mn * Kn // 16 + Kn * Nn // 16) * 2
        assert C.collective_bytes(log.log).count == 0
        assert tuple(out.to_local().shape) == (Mn // 16, Nn // 16)
        assert log.flops == 2 * Mn * Kn * Nn // 256

        args = D.distribute((_meta(Mn, Kn), _meta(Kn, Nn)),
                            (NamedSharding(mesh, P(None, "model")),
                             NamedSharding(mesh, P("model", None))))
        _, log = D.run_logged(lambda x, w: D.place(
            x @ w, NamedSharding(mesh, P())), args)
        stats = C.collective_bytes(log.log)
        assert _colls(log.log) == [("all-reduce", Mn * Nn * 2, 16)]
        assert stats.by_op == {"all-reduce": 2 * 15 / 16 * Mn * Nn * 2}
    import torch.distributed as dist
    assert not dist.is_initialized()


_MOE = MoEConfig(n_experts=8, top_k=2)
_E, _Dm, _F = 8, 16, 32


def _moe_args(mesh, B, T, pspec):
    x = _meta(B, T, _Dm, dtype=torch.float32)
    p = {"router": _meta(_Dm, _E, dtype=torch.float32),
         "w1": _meta(_E, _Dm, _F, dtype=torch.float32),
         "w3": _meta(_E, _Dm, _F, dtype=torch.float32),
         "w2": _meta(_E, _F, _Dm, dtype=torch.float32)}
    xs = P(None, None, None) if T == 1 else P("data", None, None)
    sh = (NamedSharding(mesh, xs),
          {k: NamedSharding(mesh, v) for k, v in pspec.items()})
    return D.distribute((x, p), sh)


def test_moe_expert_parallel_collectives_on_2x4():
    """``moe_ffn_decode_ep``: a psum of this shard's experts' slots over
    "data" and of the whole slot table over "model"; ``moe_ep_ffn``: the
    two all-to-alls of the slots over "model" and the psum of the
    load-balance sums over "data".  Bytes from the bodies' shapes."""
    with D.fake_world(8):
        mesh = D.device_mesh(_grid((2, 4)))
        B = 16
        C_dec = M.local_capacity(B, _MOE)
        args = _moe_args(mesh, B, 1, {
            "router": P(None, None), "w1": P("model", None, "data"),
            "w3": P("model", None, "data"), "w2": P("model", "data", None)})
        (y, _), log = D.run_logged(
            lambda x, p: M.moe_ffn_decode_ep(x, p, _MOE, mesh), args)
        assert tuple(y.shape) == (B, 1, _Dm)
        assert _colls(log.log) == [
            ("all-reduce", (_E // 4) * C_dec * _Dm * 4, 2),
            ("all-reduce", _E * C_dec * _Dm * 4, 4)]

        T = 8
        C_ep = M.local_capacity(B // 2 * T, _MOE)
        args = _moe_args(mesh, B, T, {
            "router": P(None, None), "w1": P("model", None, None),
            "w3": P("model", None, None), "w2": P("model", None, None)})
        (y, _), log = D.run_logged(
            lambda x, p: M.moe_ep_ffn(x, p, _MOE, mesh), args)
        assert tuple(y.to_local().shape) == (B // 2, T, _Dm)
        slots = _E * C_ep * _Dm * 4
        assert _colls(log.log) == [("all-to-all", slots, 4),
                                   ("all-to-all", slots, 4),
                                   ("all-reduce", (2 * _E + 1) * 4, 2)]
        assert C.collective_bytes(log.log).by_op == {
            "all-to-all": 2 * 3 / 4 * slots,
            "all-reduce": 2 * 1 / 2 * (2 * _E + 1) * 4}


def test_fake_world_refuses_a_live_group():
    with D.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialised"):
            with D.fake_world(4):
                pass


# ---------------------------------------------------------------------------
# (c) the reference's own dryrun_cell, in a child process
# ---------------------------------------------------------------------------
SHAPES = {"train_4k": ["train_4k", 32, 8, "train"],
          "prefill_32k": ["prefill_32k", 32, 4, "prefill"],
          "decode_32k": ["decode_32k", 64, 8, "decode"],
          "long_500k": ["long_500k", 128, 1, "long_decode"]}
CELLS = ([["qwen3-8b", s, False] for s in SHAPES]
         + [["qwen3-8b", "decode_32k", True],
            ["dbrx-132b", "prefill_32k", False],
            ["dbrx-132b", "train_4k", False],
            ["h2o-danube-3-4b", "prefill_32k", False],  # a windowed ring
            ["rwkv6-1.6b", "long_500k", False],
            ["rwkv6-1.6b", "train_4k", False],
            ["rwkv6-1.6b", "prefill_32k", True]])

# the reference's make_production_mesh, shrunk; Auto axes, as the mesh its
# specs were written for (jax.make_mesh now defaults to Explicit axes)
_REF_DRYRUN = r"""
import json, os, sys
import repro.launch.dryrun as RD  # sets XLA_FLAGS on import
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_config
from repro.configs.base import ShapeConfig
cells, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
RD.SHAPES = {k: ShapeConfig(*v) for k, v in shapes.items()}
RD.get_config = lambda a: get_config(a).reduced()
def mesh(multi_pod=False):
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
RD.make_production_mesh = mesh
out = [RD.dryrun_cell(a, s, multi_pod=mp, verbose=False) for a, s, mp in cells]
print("RECORDS" + json.dumps(out))
"""


def _small_meshes(monkeypatch):
    def make(multi_pod=False, device=None):
        return (_grid((2, 2, 2), ("pod", "data", "model")) if multi_pod
                else _grid((2, 4)))
    monkeypatch.setattr(D, "make_production_mesh", make)


@pytest.fixture(scope="module")
def ref_child():
    """The reference's records, computed in a child process that runs
    while the test computes the port's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _REF_DRYRUN,
                             json.dumps(CELLS), json.dumps(SHAPES)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _ref_records(proc) -> list:
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.split("RECORDS", 1)[1])


def _keys(rec, prefix=()) -> set:
    out = set()
    for k, v in rec.items():
        out.add(prefix + (k,))
        if isinstance(v, dict) and k not in ("by_op", "mesh"):
            out |= _keys(v, prefix + (k,))
    return out


def test_records_match_reference_dryrun_cell(ref_child, monkeypatch):
    monkeypatch.setattr(D, "SHAPES",
                        {k: ShapeConfig(*v) for k, v in SHAPES.items()})
    monkeypatch.setattr(D, "get_config", lambda a: get_config(a).reduced())
    _small_meshes(monkeypatch)
    records = [D.dryrun_cell(arch, shape, multi_pod=mp, verbose=False)
               for arch, shape, mp in CELLS]
    ref_records = _ref_records(ref_child)
    assert len(ref_records) == len(CELLS)
    for (arch, shape, mp), rec, ref in zip(CELLS, records, ref_records):
        cell = (arch, shape, mp)
        assert rec["status"] == ref["status"], cell
        assert _keys(rec) == _keys(ref), cell
        if ref["status"] == "skipped":
            assert rec["reason"] == ref["reason"]
            continue
        assert rec["n_chips"] == ref["n_chips"] == 8
        assert rec["mesh"] == ref["mesh"], cell
        for k in ("argument_bytes", "output_bytes", "alias_bytes"):
            assert rec["memory"][k] == ref["memory"][k], (cell, k)
        m = rec["memory"]
        assert m["per_device_total"] == (m["argument_bytes"]
                                         + m["output_bytes"] + m["temp_bytes"]
                                         - m["alias_bytes"])
        assert rec["hlo_flops_raw"] > 0 and rec["hlo_bytes_raw"] > 0
        assert rec["collectives"]["count"] > 0


# ---------------------------------------------------------------------------
# (d) flops
# ---------------------------------------------------------------------------
DENSE = dataclasses.replace(get_config("qwen3-8b").reduced(), n_heads=8,
                            n_kv_heads=4)   # every product shards on 2x4
MOE = dataclasses.replace(get_config("dbrx-132b").reduced(), n_heads=8,
                          n_kv_heads=4)     # E=4, top-2
FLOP_SHAPES = {"train": ShapeConfig("train_4k", 32, 4, "train"),
               "prefill": ShapeConfig("prefill_32k", 64, 2, "prefill"),
               "decode": ShapeConfig("decode_32k", 64, 4, "decode")}


def _dry_flops(monkeypatch, cfg, shape, grid):
    monkeypatch.setattr(D, "SHAPES", {"cell": shape})
    monkeypatch.setattr(D, "get_config", lambda a: cfg)
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False, device=None: _grid(grid))
    return D.dryrun_cell("cell", "cell", verbose=False)["hlo_flops_raw"]


def _real_flops(cfg, shape) -> int:
    """FlopCounterMode over the step run for real on the CPU, its
    arguments drawn from a seed."""
    g = torch.Generator().manual_seed(0)

    def draw(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not t.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, t.shape, generator=g,
                                 dtype=t.dtype)
        return (torch.randn(t.shape, generator=g) * 0.02).to(t.dtype)

    args = pytree.tree_map(draw, S.input_specs(cfg, shape))
    fn = S.step_fn(cfg, shape, make_region_mesh([["cpu"]]), remat="2level")
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_exact_on_one_device_and_sharded(kind, monkeypatch):
    shape = FLOP_SHAPES[kind]
    one = _dry_flops(monkeypatch, DENSE, shape, (1, 1))
    assert one == _real_flops(DENSE, shape)
    assert _dry_flops(monkeypatch, DENSE, shape, (2, 4)) * 8 == one


def test_moe_flops_exact_with_the_replicated_router(monkeypatch):
    """On 2x4 every data shard routes its own tokens with its own
    capacity (64 tokens: 40 slots an expert, half of the 1x1 cell's 80),
    and the router's product is replicated over "model": named and
    added."""
    shape = FLOP_SHAPES["prefill"]
    one = _dry_flops(monkeypatch, MOE, shape, (1, 1))
    assert one == _real_flops(MOE, shape)
    n_tok = shape.global_batch * shape.seq_len
    assert M.local_capacity(n_tok, MOE.moe) == \
        2 * M.local_capacity(n_tok // 2, MOE.moe)
    router = 2 * n_tok * MOE.d_model * MOE.moe.n_experts * MOE.n_layers
    assert _dry_flops(monkeypatch, MOE, shape, (2, 4)) * 8 == \
        one + (4 - 1) * router


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------
def test_cli_writes_one_ok_record(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert "1 ok / 0 skipped / 0 FAILED" in proc.stdout

"""Dry run: every (architecture x input shape) cell's step, run once on
rank 0 of a fake process group as large as the production mesh, with
memory, cost and collective analysis; the port of the reference's
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell over 256/512 forced host
devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
compiled HLO.  Here a cell's ``specs.step_fn`` runs once, eagerly, on
DTensors whose local shards live on ``meta`` (no storage), over an
``init_device_mesh`` with the production mesh's shape and axis names on a
fake process group (``FakeStore``; its collectives return at once).  A
``TorchDispatchMode`` records every aten op that rank 0 runs below DTensor
(``OpLog``): from it come the flops (``torch.utils.flop_counter``'s
formulas, per device), the bytes (operands and results of every op that
moves data: eager PyTorch fuses nothing), the peak of live storages and
the collectives (``launch/comm_analysis.py``).  No device is touched, so
the dry run is the one entry point that runs without the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out f.json]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from typing import NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, all_configs, get_config
from repro_torch.launch import comm_analysis as C
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.spmd import mesh_shape

# NVIDIA H100 80GB HBM3 (SXM) per card -- roofline constants: NVIDIA's
# data sheet, dense rates at the full 700 W power limit, and the card's
# torch.cuda.get_device_properties(0).total_memory as chip_smoke.py read it
# (NVIDIA H100 80GB HBM3, 700.00 W; torch 2.11.0+cu128)
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9  # NVLink 4: 18 links x 25 GB/s each way
HBM_BYTES = 85_017_493_504

# ops that write their destination without reading it
_PURE_WRITES = {"aten.copy_.default", "aten.fill_.Scalar", "aten.fill_.Tensor",
                "aten.zero_.default"}
# factories that take only the shape and dtype of their tensor argument
_LIKE = {"aten.zeros_like.default", "aten.ones_like.default",
         "aten.full_like.default", "aten.new_zeros.default",
         "aten.new_ones.default", "aten.new_full.default"}

# ops that move no data: views (an aliasing result), fresh allocations and
# the functional collectives' bookkeeping
_NO_TRAFFIC = {
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default",
    "_c10d_functional.wait_tensor.default",
    "_c10d_functional._wrap_tensor_autograd.default",
}


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree, out: list) -> list:
    """The tensors of an op's arguments or result (tensors, and lists and
    tuples of them), in order."""
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


def _pairs(ts) -> tuple:
    return tuple((t.dtype, tuple(t.shape)) for t in ts)


class _Op(NamedTuple):
    """What the log needs of an op, looked up once an overload."""
    name: str
    kind: Optional[str]
    done: bool
    moves: str       # "all" | "results" | "none"
    composite: bool  # has a decomposition (CompositeImplicitAutograd)
    flop: Optional[object]


_OPS: dict = {}


def _op(func) -> _Op:
    info = _OPS.get(func)
    if info is None:
        name = str(func)
        kind, done = C.collective_kind(name)
        moves = ("results" if name in _LIKE else "none"
                 if name in _NO_TRAFFIC or _is_view(func) else "all")
        composite = func is not torch.ops.prim.device.default and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        info = _OPS[func] = _Op(name, kind, done, moves, composite,
                                flop_registry.get(func._overloadpacket))
    return info


def _group_size(func, args, kwargs) -> int:
    """The size of a functional collective's process group (its
    ``group_name`` argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a.name for a in func._schema.arguments]
    g = (kwargs["group_name"] if "group_name" in kwargs
         else args[names.index("group_name")])
    if isinstance(g, torch.distributed.ProcessGroup):
        return g.size()
    return _resolve_process_group(g).size()


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by all its views."""
    return t.untyped_storage()._cdata


class OpLog(TorchDispatchMode):
    """Records the ops run on plain tensors, which under DTensor are the
    ops on this rank's local shards: a DTensor op is handed back
    (``NotImplemented``), DTensor unwraps it and its local ops come back
    through this mode.  The fake tensors of DTensor's sharding propagation
    (global shapes) are not recorded.  Keeps the log (``comm_analysis.
    OpRecord``s), the flops, the bytes moved and the peak of live
    storages: a storage counts once, whatever views it has, from the op
    that made it until its last tensor dies.  ``read`` holds the storages
    that some op read (a view reads nothing, ``copy_`` does not read its
    destination)."""

    def __init__(self):
        super().__init__()
        self.log: list = []
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.read: set = set()
        self._seen: dict = {}

    def track(self, t: torch.Tensor):
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key):
        n, _ = self._seen.pop(key, (0, None))
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        op = _op(func)
        if op.composite:
            # as FlopCounterMode: an op with a decomposition (a composite
            # op reaching the dispatcher) is counted through it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,),
                        [])
        if not outs or isinstance(outs[0], FakeTensor):
            return out  # metadata, or a factory call of the propagation
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs.values(), ins)
        operands, results = _pairs(ins), _pairs(outs)
        self.log.append(C.OpRecord(
            op.name, results, operands,
            _group_size(func, args, kwargs) if op.kind else 1, op.kind,
            op.done))
        if op.flop is not None:
            self.flops += op.flop(*args, **kwargs, out_val=out)
        if op.moves == "results":
            self.bytes += C.tensor_bytes(results)
        elif op.moves == "all":
            self.bytes += C.tensor_bytes(operands) + C.tensor_bytes(results)
            skip = args[0] if op.name in _PURE_WRITES else None
            self.read.update(storage_key(t) for t in ins if t is not skip)
        for t in outs:
            self.track(t)
        return out


# --------------------------------------------------------------------------
# The fake process group and the cell's DTensor arguments
# --------------------------------------------------------------------------
class fake_world:
    """A fake process group of ``world`` ranks, this process rank 0, set
    up on entry and destroyed on exit.  Raises if a group is already
    initialised (it would be torn down with this one)."""

    def __init__(self, world: int):
        self.world = world

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("a process group is already initialised; "
                               "the dry run sets up its own fake group")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.world)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        return False


def device_mesh(mesh):
    """The ``DeviceMesh`` of the fake group with ``mesh``'s shape and
    axis names.  Its device type is CUDA, as on the cluster it models:
    DTensor then moves a shard between dims with an all-to-all (on a CPU
    mesh it would all-gather, as gloo has no all-to-all).  The shards stay
    on ``meta``, so no device is touched, and none is needed."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(mesh)
    return init_device_mesh("cuda", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def _is_sharding(x) -> bool:
    return hasattr(x, "placements") and hasattr(x, "spec")


def distribute(args, shardings):
    """Each ``meta`` leaf of ``args`` as a DTensor placed by its
    ``NamedSharding``; the local shard is on ``meta`` as well.  Other
    leaves (the cache's host ``pos``, the decode cell's ``None``) are
    kept."""
    from torch.distributed.tensor import distribute_tensor

    def one(sh, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, sh.mesh, sh.placements,
                                 src_data_rank=None)

    return pytree.tree_map(one, shardings, args, is_leaf=_is_sharding)


def place(outs, shardings):
    """The step's outputs redistributed to their ``NamedSharding``s, as
    jit's ``out_shardings`` (a leaf that is not a DTensor is kept)."""
    from torch.distributed.tensor import DTensor

    def one(sh, leaf):
        if isinstance(leaf, DTensor):
            return leaf.redistribute(sh.mesh, sh.placements)
        return leaf

    return pytree.tree_map(one, shardings, outs, is_leaf=_is_sharding)


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(tree) -> list:
    """The tensor and host-int leaves of ``tree`` (the cache's ``pos`` is
    the reference's int32 scalar)."""
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)
            or (isinstance(x, int) and not isinstance(x, bool))]


def local_bytes(tree, read=None) -> int:
    """Bytes of the local shards of ``tree``'s leaves, a host int as 4.
    With ``read`` (storage keys), only the tensors whose storage was read:
    jit drops the arguments its computation does not use."""
    n = 0
    for leaf in _leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            n += 4
            continue
        t = _local(leaf)
        if read is None or storage_key(t) in read:
            n += t.numel() * t.element_size()
    return n


def storages(tree) -> dict:
    """{storage key: bytes} of the storages that the local shards of
    ``tree``'s tensor leaves view, each once (``OpLog``'s count)."""
    out = {}
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            st = _local(leaf).untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def run_logged(fn, args):
    """``fn(*args)`` under an ``OpLog`` with DTensor's implicit
    replication (plain tensors the step makes, positions and masks, are
    replicated).  Returns (outputs, log)."""
    from torch.distributed.tensor.experimental import implicit_replication

    log = OpLog()
    for leaf in pytree.tree_leaves(args):
        if isinstance(leaf, torch.Tensor):
            log.track(_local(leaf))
    with implicit_replication(), log:
        out = fn(*args)
    return out, log


# --------------------------------------------------------------------------
# One cell
# --------------------------------------------------------------------------
def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                verbose: bool = True, remat: str = "2level",
                q_chunk: int = 1024, microbatches: Optional[int] = None,
                donate: bool = True) -> dict:
    """The reference's record for one cell on a production mesh, key for
    key (``dryrun_step``); a long-decode cell of a quadratic model is
    skipped with the reference's reason."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "long_decode" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "full quadratic attention (DESIGN.md §4)"}
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           **dryrun_step(cfg, shape, mesh, remat=remat, q_chunk=q_chunk,
                         microbatches=microbatches, donate=donate)}
    if verbose:
        hbm = rec["memory"]["per_device_total"]
        print(f"[dryrun] {arch} x {shape_name} "
              f"{'2-pod' if multi_pod else '1-pod'}: OK  "
              f"run={rec['lower_s']:.1f}s  per-device={hbm/1e9:.2f} GB "
              f"(fits {HBM_BYTES/2**30:.1f} GiB HBM: {rec['fits_hbm']})")
        print(f"  memory: {rec['memory']}")
        print(f"  cost: flops={rec['hlo_flops_raw']:.3e} "
              f"bytes={rec['hlo_bytes_raw']:.3e}")
        for line in rec["schedule"][:8]:
            print(f"  {line}")
    return rec


def dryrun_step(cfg, shape, mesh, *, remat: str = "2level",
                q_chunk: int = 1024, microbatches: Optional[int] = None,
                donate: bool = True) -> dict:
    """The record of ``specs.step_fn(cfg, shape)`` run once on rank 0 of a
    fake process group with ``mesh``'s shape and axis names (any mesh
    with both: ``make_production_mesh``, ``make_region_mesh``): from
    ``status`` on, the reference's keys.  ``lower_s`` is the traced run's
    time, ``compile_s`` the analysis of its log."""
    sizes = mesh_shape(mesh)
    n_chips = math.prod(sizes.values())
    with fake_world(n_chips):
        dmesh = device_mesh(mesh)
        specs = S.input_specs(cfg, shape)
        in_sh = S.input_shardings(cfg, shape, dmesh, specs)
        out_sh = S.output_shardings(cfg, shape, dmesh, specs)
        fn = S.step_fn(cfg, shape, dmesh, remat=remat, q_chunk=q_chunk,
                       microbatches=microbatches)
        args = distribute(specs, in_sh)
        donated = ()
        if donate:
            donated = (0,) if shape.kind == "train" else (
                (1,) if shape.is_decode else ())

        t0 = time.time()
        outs, log = run_logged(lambda *a: place(fn(*a), out_sh), args)
        t_lower = time.time() - t0
        t0 = time.time()
        # an argument no op read is dropped, as jit drops unused ones; a
        # donated argument is written in place, or replaced (the step
        # counter, the cache's pos), and aliased as the reference's
        arg_bytes = local_bytes(args, log.read)
        alias_bytes = sum(local_bytes(args[i], log.read) for i in donated)
        # XLA's output size holds the flat output tuple, a pointer a leaf
        out_bytes = local_bytes(outs) + 8 * len(_leaves(outs))
        colls = C.collective_bytes(log.log)
        schedule = C.summarize_collectives(log.log)
        # the peak holds every argument's storage (read or not) and the
        # outputs that are not written into one; temp is what it holds
        # above them
        arg_st = storages(args)
        fresh = sum(t.numel() * t.element_size()
                    for t in map(_local, _leaves(outs))
                    if isinstance(t, torch.Tensor)
                    and storage_key(t) not in arg_st)
        temp = log.peak - sum(arg_st.values()) - fresh
        if temp < 0:
            raise RuntimeError(f"peak {log.peak} B below the {fresh} B of "
                               f"outputs and the arguments' "
                               f"{sum(arg_st.values())} B")
        t_compile = time.time() - t0
        del outs, args

    total = arg_bytes + out_bytes + temp - alias_bytes
    return {
        "status": "ok",
        "fits_hbm": bool(total < HBM_BYTES),
        # an XLA:CPU artifact of the reference's; nothing to subtract here
        "f32_normalization_artifact_bytes": 0,
        "per_device_corrected": int(total),
        "fits_hbm_corrected": bool(total < HBM_BYTES),
        "n_chips": int(n_chips),
        "mesh": dict(sizes),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias_bytes,
            "code_bytes": 0,
            "per_device_total": total,
        },
        # every op of every block ran: no loop body is counted once
        "hlo_flops_raw": float(log.flops),
        "hlo_bytes_raw": float(log.bytes),
        "collectives": {
            "per_device_bytes_raw": colls.total_bytes,
            "by_op": colls.by_op,
            "count": colls.count,
        },
        "schedule": schedule,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--remat", type=str, default="2level")
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args()

    cells = []
    archs = sorted(all_configs()) if (args.all or not args.arch) else [args.arch]
    for a in archs:
        shapes = [args.shape] if args.shape else list(SHAPES)
        for s in shapes:
            meshes = [False, True] if args.both_meshes else [args.multi_pod]
            for mp in meshes:
                cells.append((a, s, mp))

    records = []
    for a, s, mp in cells:
        try:
            records.append(dryrun_cell(a, s, multi_pod=mp,
                                       remat=args.remat,
                                       microbatches=args.microbatches))
        except Exception as e:  # a failure here is a bug in the system
            traceback.print_exc()
            records.append({"arch": a, "shape": s, "multi_pod": mp,
                            "status": "FAIL",
                            "error": f"{type(e).__name__}: {e}"})
    ok = sum(r["status"] == "ok" for r in records)
    sk = sum(r["status"] == "skipped" for r in records)
    fail = [r for r in records if r["status"] == "FAIL"]
    print(f"\n[dryrun] {ok} ok / {sk} skipped / {len(fail)} FAILED "
          f"of {len(records)} cells")
    for r in fail:
        print(f"  FAIL {r['arch']} x {r['shape']} "
              f"{'2pod' if r['multi_pod'] else '1pod'}: {r['error']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

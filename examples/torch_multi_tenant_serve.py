"""Multi-tenant accelerator on the PyTorch/CUDA port, the twin of
``examples/multi_tenant_serve.py``: LM *training* and LM *serving* tasks
coexist as preemptible kernels on the same regions.  Serving requests
(priority 0) preempt the background training job (priority 4), which
resumes from its context: the paper's FPGA scenario at LM scale.

The training job is a kernel registered with ``register_kernel_def``
whose context slot 0 counts training steps (``for_save``, budget 2: a
chunk is two steps); the model and optimizer state ride in its buffer
slots (flattened), so ``abi.N_BUF_SLOTS`` is widened, as the reference
does.  A serving request prefills a prompt batch and writes its last
logits into buffer slot 1.

The reference lets three requests trickle in with sleeps.  Here they
arrive at the training task's first chunk boundary, from the regions'
``on_chunk`` hook, which then holds the workers until the scheduler has
asked the training region to preempt: at least one preemption lands
whatever the timing.  The run is checked against an uninterrupted run of
the same training task: the final state must be equal bit for bit.

    PYTHONPATH=src python examples/torch_multi_tenant_serve.py               # cuda:0
    PYTHONPATH=src python examples/torch_multi_tenant_serve.py --device cpu
"""
import argparse
import functools
import threading
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

import repro_torch
from repro_torch.configs import get_config
from repro_torch.controller import abi
from repro_torch.controller.abi import ArgBundle
from repro_torch.controller.kernels import KernelDef, register_kernel_def
from repro_torch.core.preemption import for_save
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.shell import Shell
from repro_torch.core.task import Task
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.lm import (init_train_state, make_prefill_step,
                                   make_train_step)
from repro_torch.optim import AdamWConfig

CFG = get_config("h2o-danube-3-4b").reduced()
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
DATA = SyntheticTokens(DataConfig(seed=5, vocab_size=CFG.vocab_size,
                                  seq_len=64, global_batch=4))
TRAIN_STEPS = 12
N_REQUESTS = 3
HOLD_S = 120.0  # the most a hook holds a worker for the preemption
_train_step = make_train_step(CFG, OPT, remat="full", q_chunk=16)
_prefill = make_prefill_step(CFG, q_chunk=16)


@functools.lru_cache(maxsize=None)
def initial_state():
    """(the train state's leaves as numpy, its spec, the params' spec):
    seed-0 f32 weights, drawn on the CPU."""
    state = init_train_state(CFG, OPT,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu", param_dtype=torch.float32)
    leaves, spec = pytree.tree_flatten(state)
    return ([t.numpy() for t in leaves], spec,
            pytree.tree_structure(state["params"]))


def train_kernel(ctx, bufs, ints, floats):
    """Preemptible LM-training kernel: context slot 0 = training step."""
    leaves, spec, _ = initial_state()
    n = len(leaves)
    state = pytree.tree_unflatten(list(bufs[:n]), spec)
    batch = DATA.batch(0)

    def body(ctx, step, state):
        state, _ = _train_step(state, batch)
        ctx = ctx.checkpoint(0, step + 1)
        return ctx, state

    ctx, state = for_save(ctx, 0, 0, int(ints[0]), 1, body, state)
    if ctx.intr == 0:
        ctx = ctx.finish()
    return ctx, tuple(pytree.tree_leaves(state)) + tuple(bufs[n:])


def serve_kernel(ctx, bufs, ints, floats):
    """One-shot serving request: prefill a prompt batch, write the last
    logits into the ``out`` buffer (slot 1); every slot keeps its shape."""
    _, _, pspec = initial_state()
    params = pytree.tree_unflatten(list(bufs[2:2 + pspec.num_leaves]), pspec)
    with torch.no_grad():
        _, last = _prefill(params, {"tokens": bufs[0]})
    out = (bufs[0], last[:, :CFG.vocab_size].float()) + tuple(bufs[2:])
    return ctx.finish(), out


def register():
    """Register the two tenant kernels with wide buffer ABIs and widen
    ``abi.N_BUF_SLOTS`` to hold them (returns the old width)."""
    leaves, _, pspec = initial_state()
    register_kernel_def(KernelDef(
        name="TrainLM", backend="PYNQ", fn=train_kernel,
        ktile_args=tuple(f"s{i}" for i in range(len(leaves))),
        int_args=("steps",), float_args=(), default_budget=2,
        device_result=True))
    register_kernel_def(KernelDef(
        name="ServeLM", backend="PYNQ", fn=serve_kernel,
        ktile_args=("tokens", "out") + tuple(f"p{i}" for i in
                                             range(pspec.num_leaves)),
        int_args=(), float_args=(), default_budget=1))
    old = abi.N_BUF_SLOTS
    abi.N_BUF_SLOTS = max(len(leaves), pspec.num_leaves + 2)
    return old


class Arrivals:
    """The regions' ``on_chunk`` hook (one object on every region).  At
    the training task's first chunk boundary it submits the serving
    requests; it then holds that worker, and every serving worker that
    finishes a chunk before the preemption, until the scheduler has asked
    the training region to preempt (or ``HOLD_S`` has passed), so the
    requests cannot all slip onto an idle region first."""

    def __init__(self, client, prompts, logits_buf, p_leaves):
        self.client = client
        self.bundle = (prompts, logits_buf) + tuple(p_leaves)
        self.handles = []
        self.train = None  # (region, task) of the training task
        self._lock = threading.Lock()

    def _preempting(self) -> bool:
        region, task = self.train
        return region._preempt.is_set() or task.n_preemptions > 0

    def _hold(self):
        deadline = time.monotonic() + HOLD_S
        while not self._preempting() and time.monotonic() < deadline:
            time.sleep(1e-3)

    def __call__(self, region, task):
        with self._lock:
            first = task.kernel == "TrainLM" and self.train is None
            if first:
                self.train = (region, task)
        if first:
            for _ in range(N_REQUESTS):
                self.handles.append(self.client.submit(Task(
                    kernel="ServeLM",
                    args=ArgBundle(bufs=self.bundle, ints=()),
                    priority=0, tenant="serving")))
            self._hold()
        elif task.kernel == "ServeLM" and self.train is not None:
            self._hold()


def _numpy(result) -> list:
    """Device results as numpy, after the region's stream has run them."""
    if any(t.is_cuda for t in result):
        torch.cuda.synchronize()
    return [t.cpu().numpy() for t in result]


def run(device=None, n_regions: int = 2, serve: bool = True,
        steps: int = TRAIN_STEPS, timeout: float = 600.0) -> dict:
    """One run behind ``repro_torch.Client``: the training task, and with
    ``serve`` the serving requests placed by ``Arrivals``.  Returns the
    training task's final state leaves (numpy), its preemptions, the
    serving logits and the client's report."""
    leaves, _, pspec = initial_state()
    shell = Shell(n_regions=n_regions, chunk_budget=2,
                  devices=None if device is None else [device])
    client = repro_torch.Client(
        backend=shell, scheduler_config=SchedulerConfig(preemption=True))
    old = register()
    try:
        prompts = DATA.batch(3)["tokens"][:, :32]
        logits_buf = np.zeros((prompts.shape[0], CFG.vocab_size), np.float32)
        arrivals = Arrivals(client, prompts, logits_buf,
                            leaves[:pspec.num_leaves])
        if serve:
            for region in shell.regions:
                region.on_chunk = arrivals
        train_task = Task(kernel="TrainLM",
                          args=ArgBundle(bufs=tuple(leaves), ints=(steps,)),
                          priority=4, tenant="training")
        t0 = time.perf_counter()
        handle = client.submit(train_task)
        state = _numpy(handle.result(timeout=timeout)[:len(leaves)])
        logits = [h.result(timeout=timeout)[1] for h in arrivals.handles]
        rep = client.drain(timeout=60.0)
        wall_s = time.perf_counter() - t0
    except BaseException:
        client.shutdown()
        raise
    finally:
        shell.shutdown()
        abi.N_BUF_SLOTS = old
    return {"state": state, "preemptions": train_task.n_preemptions,
            "regions": list(train_task.region_history), "logits": logits,
            "report": rep, "wall_s": wall_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path; default cuda:0")
    ap.add_argument("--regions", type=int, default=2)
    args = ap.parse_args(argv)
    got = run(args.device, n_regions=args.regions)
    want = run(args.device, n_regions=args.regions, serve=False)
    rep = got["report"]
    for i, logits in enumerate(got["logits"]):
        print(f"[client] serve request {i} done (logits {logits.shape})")
    print("\n--- multi-tenant report ---")
    print(f"done={rep['n_done']} preemptions={rep['preemptions']} "
          f"wall={got['wall_s']:.1f}s "
          f"per-tenant={ {k: v['n'] for k, v in rep['per_tenant'].items()} } "
          f"stranded={rep['stranded_handles']}")
    same = all(np.array_equal(a, b) for a, b in zip(got["state"],
                                                     want["state"]))
    print(f"training was preempted {got['preemptions']}x by serving requests "
          f"(regions {got['regions']}) and still completed; final state "
          f"{'equal' if same else 'NOT equal'} to an uninterrupted run")
    if got["preemptions"] < 1 or not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

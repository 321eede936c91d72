"""Kernel registry — the ``CTRL_KERNEL_FUNCTION`` analogue (paper §5.1).

    @ctrl_kernel(name="MedianBlur", backend="PYNQ",
                 ktile_args=("input_array", "output_array"),
                 int_args=("H", "W", "iters"), library="blur")
    def median_blur(ctx, bufs, ints, floats): ...

registers a preemptible kernel with the uniform chunk ABI
``(ContextRecord, bufs, i32[N_INT], f32[N_FLOAT]) -> (ContextRecord, bufs)``.
The decorator records the *declared* argument names (for user-facing argument
construction) while the generated callable always takes the padded uniform
interface — the code-generation step of Listing 1.2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

from repro_torch.controller.abi import ArgBundle


@dataclass(frozen=True)
class KernelDef:
    name: str
    backend: str
    fn: Callable          # uniform chunk fn (ctx, bufs, ints, floats)
    ktile_args: tuple
    int_args: tuple
    float_args: tuple
    # per-chunk iteration budget default (preemption latency knob)
    default_budget: int = 64
    # resource footprint: minimum region width, in devices, this kernel
    # needs — the floorplanner sizes region slices against it
    footprint: int = 1
    # the hand-written CUDA library (``repro_torch/csrc/<library>.cu``) the
    # kernel body launches on a CUDA device; None = plain tensor code only.
    # Bitstream generation builds and loads it, and regions record the
    # resolved kernel mode ("cuda" | "torch") in their stats
    library: Optional[str] = None
    # hand the final buffers back as device tensors (serving kernels: the
    # engine threads K/V pools and state into the next round), each marked
    # with the event recorded after the task's last launch; False = the
    # first two buffers as host numpy
    device_result: bool = False
    # the persistent entry the megakernel engine launches on a CUDA device:
    # mega(ctx_words, bufs, ints, floats, budget, flag) -> a launch with
    # query() and result() -> (ctx_words, n_chunks), the whole chunk loop
    # of a task in one kernel (``core/preemption.make_megakernel``); None =
    # the kernel has none, and megakernel mode refuses it on the card
    mega: Optional[Callable] = None
    # the library the persistent entry launches, where the chunk body
    # launches none (the surrogate LM's M2/M3 in ``csrc/seq_lm.cu``); the
    # "mega" program's generation builds it.  None = ``library``
    mega_library: Optional[str] = None

    def bundle(self, *bufs, **scalars) -> ArgBundle:
        """Build an ArgBundle from declared argument names."""
        ints = tuple(int(scalars[k]) for k in self.int_args)
        floats = tuple(float(scalars.get(k, 0.0)) for k in self.float_args)
        return ArgBundle(bufs=tuple(bufs), ints=ints, floats=floats)


_REGISTRY: Dict[str, KernelDef] = {}


def ctrl_kernel(name: str, backend: str = "PYNQ",
                ktile_args: Sequence[str] = (),
                int_args: Sequence[str] = (),
                float_args: Sequence[str] = (),
                default_budget: int = 64,
                footprint: int = 1,
                library: Optional[str] = None,
                device_result: bool = False,
                mega: Optional[Callable] = None,
                mega_library: Optional[str] = None):
    def deco(fn):
        kd = KernelDef(name=name, backend=backend, fn=fn,
                       ktile_args=tuple(ktile_args), int_args=tuple(int_args),
                       float_args=tuple(float_args),
                       default_budget=default_budget,
                       footprint=footprint,
                       library=library,
                       device_result=device_result,
                       mega=mega, mega_library=mega_library)
        _REGISTRY[name] = kd
        return fn

    return deco


def register_kernel_def(kd: KernelDef):
    """Register a ``KernelDef`` built by hand (the decorator's
    counterpart for kernels whose argument lists are built at run time)."""
    _REGISTRY[kd.name] = kd


def _register_builtin():
    # importing the task modules registers the paper's workload set (blur)
    # and the token-serving prefill/decode kernels (surrogate + attention)
    import repro_torch.kernels.blur.tasks  # noqa: F401
    import repro_torch.serving.attention  # noqa: F401
    import repro_torch.serving.kernels  # noqa: F401


def get_kernel(name: str) -> KernelDef:
    _register_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"kernel {name!r} not registered; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def kernel_names() -> list:
    _register_builtin()
    return sorted(_REGISTRY)


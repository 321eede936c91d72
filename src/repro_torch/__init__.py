"""repro_torch: the preemptive region scheduler on PyTorch and CUDA.

The port of ``repro`` (the JAX/Pallas reference) to one NVIDIA H100:
regions are CUDA streams that time-share the card, chunk control runs on
the host, and the Pallas kernels are hand-written CUDA for ``sm_90a``
(see ``DESIGN.md`` in this package).  Entry points run on ``cuda:0``
unless the caller asks for ``device="cpu"``.
"""
__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing ``repro_torch`` must stay free of torch/scheduler imports
    if name == "Client":
        from repro_torch.client import Client

        return Client
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

from repro_torch.controller.abi import ArgBundle, abi_signature  # noqa: F401
from repro_torch.controller.hittile import HitTile  # noqa: F401
from repro_torch.controller.kernels import ctrl_kernel, get_kernel, kernel_names  # noqa: F401


def __getattr__(name):  # lazy: Controller pulls in core.* (avoid import cycle)
    if name == "Controller":
        from repro_torch.controller.controller import Controller

        return Controller
    raise AttributeError(name)

from repro_torch.controller.abi import ArgBundle, abi_signature  # noqa: F401
from repro_torch.controller.hittile import HitTile  # noqa: F401
from repro_torch.controller.kernels import ctrl_kernel, get_kernel, kernel_names  # noqa: F401

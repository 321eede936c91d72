"""Assigned architecture configs.  Importing this package registers all ten
architectures (plus the paper's own blur-task workload set)."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    all_configs,
    get_config,
)
from repro_torch.configs import (  # noqa: F401
    dbrx_132b,
    mixtral_8x22b,
    qwen3_8b,
    granite_20b,
    phi4_mini_3_8b,
    h2o_danube3_4b,
    recurrentgemma_9b,
    whisper_tiny,
    rwkv6_1_6b,
    llava_next_34b,
)

ARCH_IDS = sorted(all_configs().keys())

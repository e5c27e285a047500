from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import (
    ASSIGNED_ARCHS,
    SKIPS,
    dryrun_pairs,
    get_config,
    get_shape,
    get_smoke_config,
    list_archs,
)

__all__ = [
    "INPUT_SHAPES", "InputShape", "ModelConfig", "ASSIGNED_ARCHS", "SKIPS",
    "dryrun_pairs", "get_config", "get_shape", "get_smoke_config", "list_archs",
]

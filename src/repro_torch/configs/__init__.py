from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    ShapeSpec,
    get_config,
    get_shape,
    reduce_config,
)

from repro_torch.configs.base import (
    ALIASES,
    ARCH_IDS,
    PORTED,
    SHAPES,
    ArchConfig,
    ShapeConfig,
    get_config,
    get_reduced,
)

__all__ = ["ALIASES", "ARCH_IDS", "PORTED", "SHAPES", "ArchConfig", "ShapeConfig",
           "get_config", "get_reduced"]

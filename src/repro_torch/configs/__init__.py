from .base import (
    INPUT_SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    get_config,
    list_archs,
    register,
    smoke_variant,
)

__all__ = [
    "INPUT_SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "get_config",
    "list_archs",
    "register",
    "smoke_variant",
]

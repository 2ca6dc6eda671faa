"""Architecture registry: one module per assigned architecture (+ shapes)."""
from .base import (
    ModelConfig,
    ShapeConfig,
    SHAPES,
    all_archs,
    get_config,
    register,
    smoke_config,
    supports_shape,
)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "all_archs", "get_config",
    "register", "smoke_config", "supports_shape",
]

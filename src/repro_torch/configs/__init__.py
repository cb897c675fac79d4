from repro_torch.configs.base import (
    GraphConfig,
    LM_SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    shapes_for,
)

__all__ = [
    "GraphConfig",
    "LM_SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "shapes_for",
]

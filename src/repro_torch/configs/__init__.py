"""Config registry: a ``ModelConfig`` per assigned arch (and the paper's GNN
configs in ``flowgnn.py``), the shape set and the reduced variants. The
twin of ``repro/configs/__init__.py``."""

from repro_torch.configs.archs import (ARCHS, LONG_CONTEXT_OK, REDUCED,
                                       shape_applicable)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      TrainConfig)


def get_config(arch: str) -> ModelConfig:
    return ARCHS[arch]


def get_reduced(arch: str) -> ModelConfig:
    return REDUCED[arch]


__all__ = ["ARCHS", "LONG_CONTEXT_OK", "REDUCED", "SHAPES", "ModelConfig",
           "ShapeConfig", "TrainConfig", "get_config", "get_reduced",
           "shape_applicable"]

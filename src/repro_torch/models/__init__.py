"""repro_torch.models — the model zoo of the port: the dense, MoE, SSM,
hybrid, encoder-decoder and vlm families.

Shares the parameter-dict style and the ``Model`` API of ``repro.models``.
"""
from repro_torch.models.api import Model, build_model
from repro_torch.models.config import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    shape_applicable,
)

__all__ = [
    "Model", "build_model",
    "ModelConfig", "MoEConfig", "SSMConfig", "EncoderConfig", "ShapeSpec",
    "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "shape_applicable",
]

"""Unified model API: the port of ``repro.models.api``.

``Model`` wraps init / train-loss / prefill / decode behind one interface.
The port runs the dense family (phi3, qwen3, gemma2, internlm2) and the SSM
family (mamba2); ``build_model`` raises ``NotImplementedError`` naming any
other family.  ``param_specs`` and ``input_specs`` (the dry run) wait for a
later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

_NOT_YET = {
    "moe": "MoE layers (models/moe.py)",
    "hybrid": "MoE layers (models/moe.py)",
    "encdec": "the encoder-decoder (models/encdec.py)",
    "vlm": "M-RoPE and frontend embeddings",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator) -> dict:
        """Random f32 parameters on ``generator.device``."""
        return lm.init_lm(generator, self.cfg)

    def loss(self, params, batch: dict[str, Any]):
        """Mean next-token loss of ``batch`` (``tokens``, ``labels`` with
        -100 masked, optional ``positions``): a 0-d f32 tensor."""
        return lm.lm_loss(params, self.cfg, batch["tokens"], batch["labels"],
                          positions=batch.get("positions"))

    def prefill(self, params, batch: dict[str, Any], max_len: int):
        return lm.prefill(params, self.cfg, batch["tokens"], max_len,
                          positions=batch.get("positions"))

    def decode_step(self, params, caches, token, pos):
        return lm.decode_step(params, self.cfg, caches, token, pos)

    def init_caches(self, batch: int, max_len: int, device=None):
        return lm.init_caches(self.cfg, batch, max_len, device)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in _NOT_YET:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family needs {_NOT_YET[cfg.family]},"
            " which the port does not run yet")
    return Model(cfg)

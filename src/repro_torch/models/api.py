"""Unified model API: the port of ``repro.models.api``.

``Model`` wraps init / train-loss / prefill / decode behind one interface
for every family of the model zoo, routing the encoder-decoder (whisper) to
``models/encdec.py`` and the rest (dense, MoE, SSM, hybrid, vlm) to
``models/lm.py``.  A batch is a dict: ``tokens``, and ``labels`` for the
loss; ``frames`` (encdec); ``frontend_embeds`` and ``positions`` (vlm:
``[3, B, S]`` M-RoPE positions).  ``param_specs`` and ``input_specs`` (the
dry run) wait for ``launch/dryrun.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator) -> dict:
        """Random f32 parameters on ``generator.device``."""
        if self.cfg.family == "encdec":
            return encdec.init_encdec(generator, self.cfg)
        return lm.init_lm(generator, self.cfg)

    def loss(self, params, batch: dict[str, Any]):
        """Mean next-token loss of ``batch`` (``labels`` with -100 masked):
        a 0-d f32 tensor."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.encdec_loss(params, cfg, batch["frames"],
                                      batch["tokens"], batch["labels"])
        return lm.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                          positions=batch.get("positions"),
                          frontend_embeds=batch.get("frontend_embeds"))

    def prefill(self, params, batch: dict[str, Any], max_len: int):
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.encdec_prefill(params, cfg, batch["frames"],
                                         batch["tokens"], max_len)
        return lm.prefill(params, cfg, batch["tokens"], max_len,
                          positions=batch.get("positions"),
                          frontend_embeds=batch.get("frontend_embeds"))

    def decode_step(self, params, caches, token, pos):
        if self.cfg.family == "encdec":
            return encdec.encdec_decode_step(params, self.cfg, caches, token,
                                             pos)
        return lm.decode_step(params, self.cfg, caches, token, pos)

    def init_caches(self, batch: int, max_len: int, device=None):
        if self.cfg.family == "encdec":
            return encdec.init_encdec_caches(self.cfg, batch, max_len, device)
        return lm.init_caches(self.cfg, batch, max_len, device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

"""Unified model API: the port of ``repro.models.api``.

``Model`` wraps init / train-loss / prefill / decode behind one interface
for every family of the model zoo, routing the encoder-decoder (whisper) to
``models/encdec.py`` and the rest (dense, MoE, SSM, hybrid, vlm) to
``models/lm.py``.  A batch is a dict: ``tokens``, and ``labels`` for the
loss; ``frames`` (encdec); ``frontend_embeds`` and ``positions`` (vlm:
``[3, B, S]`` M-RoPE positions).  ``param_specs`` and ``input_specs`` give
``ShapeDtype`` stand-ins for the parameters and for every entry point at a
shape cell, without allocating anything (``FakeTensorMode``): the input of
``dist.param_pspec_tree`` / ``input_pspec_tree`` at any size.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype, without its data."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def _stand_ins(values):
    return tree.map_tree(lambda x: ShapeDtype(tuple(x.shape), x.dtype),
                         values)


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

    def param_specs(self) -> dict:
        """The parameter tree as ``ShapeDtype``s: ``init`` traced under
        ``FakeTensorMode``, so the full configurations allocate nothing."""
        with FakeTensorMode():
            return _stand_ins(self.init(torch.Generator()))

    def input_specs(self, shape: ShapeSpec) -> dict[str, Any]:
        """``ShapeDtype`` stand-ins for one shape cell: train -> the
        ``loss`` batch, prefill -> the ``prefill`` batch, decode -> the
        caches, token and pos of ``decode_step``."""
        cfg = self.cfg
        i32 = torch.int32
        B, S = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            batch: dict[str, Any] = {}
            s_tok = S
            if cfg.family == "encdec":
                batch["frames"] = ShapeDtype((B, cfg.encoder.n_ctx,
                                              cfg.d_model), cfg.compute_dtype)
            if cfg.family == "vlm" and cfg.n_frontend_tokens:
                s_tok = S - cfg.n_frontend_tokens
                batch["frontend_embeds"] = ShapeDtype(
                    (B, cfg.n_frontend_tokens, cfg.d_model),
                    cfg.compute_dtype)
                batch["positions"] = ShapeDtype((3, B, S), i32)
            batch["tokens"] = ShapeDtype((B, s_tok), i32)
            if shape.kind == "train":
                batch["labels"] = ShapeDtype((B, S), i32)
            return {"batch": batch}
        with FakeTensorMode():
            caches = _stand_ins(self.init_caches(B, S, device="cpu"))
        return {"caches": caches, "token": ShapeDtype((B, 1), i32),
                "pos": ShapeDtype((B,), i32)}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

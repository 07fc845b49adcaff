"""Decoder-only LM, dense family: the port of ``repro.models.lm``.

The parameter tree is the reference's: nested dicts, with the layer stack
under ``periods`` stacked on a leading ``n_periods`` axis, so that
``convert.params_from_arrays`` is a map over leaves and caches compare leaf
by leaf.  The reference scans over periods; the port loops over them in
Python.  Weights stay f32 and are cast to the compute dtype at each use, as
in the reference.

Ported: ``init_lm``, ``forward_hidden``, ``lm_logits``, ``init_caches``
(attention entries), ``prefill`` and ``decode_step``.  An SSM mixer or an MoE
MLP raises ``NotImplementedError``; ``lm_loss`` waits for the training slice.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def _dense_only(cfg: ModelConfig) -> None:
    for i in range(cfg.period):
        if cfg.mixer_kind(i) != "attn":
            raise NotImplementedError(
                f"{cfg.name}: SSM mixers are not ported yet")
        if cfg.mlp_kind(i) != "dense":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.mlp_kind(i)} MLPs are not ported yet")
    if cfg.family in ("vlm", "encdec") or cfg.n_frontend_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet")


def _period(periods: dict, n: int) -> dict:
    """Period ``n``'s parameters (or caches): views into the stacked leaves."""
    return {k: _period(v, n) if isinstance(v, dict) else v[n]
            for k, v in periods.items()}


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_period(generator: torch.Generator, cfg: ModelConfig) -> dict:
    p = {}
    dev = generator.device
    for i in range(cfg.period):
        p[f"sub{i}"] = {
            "norm1": layers.init_rms_norm(cfg.d_model, dev),
            "mixer": attn.init_attention(generator, cfg),
            "norm2": layers.init_rms_norm(cfg.d_model, dev),
            "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff),
        }
    return p


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``generator.device``, drawn from it in order."""
    _dense_only(cfg)
    params = {
        "embed": layers.init_embed(generator, cfg.vocab, cfg.d_model),
        "final_norm": layers.init_rms_norm(cfg.d_model, generator.device),
        "periods": _stack([_init_period(generator, cfg)
                           for _ in range(cfg.n_periods)]),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.trunc_normal(generator, (cfg.d_model, cfg.vocab))
    return params


# ---------------------------------------------------------------------------
# forward (full-sequence trunk)
# ---------------------------------------------------------------------------

def _mlp_block(cfg: ModelConfig, sub: dict, x: Tensor) -> Tensor:
    h = layers.rms_norm(x, sub["norm2"], cfg.norm_eps)
    return x + layers.mlp(sub["mlp"], h)


def _apply_period(cfg: ModelConfig, pp: dict, x: Tensor, positions) -> Tensor:
    for i in range(cfg.period):
        sub = pp[f"sub{i}"]
        h = layers.rms_norm(x, sub["norm1"], cfg.norm_eps)
        x = x + attn.attention(sub["mixer"], cfg, h, positions, causal=True,
                               window=cfg.layer_window(i))
        x = _mlp_block(cfg, sub, x)
    return x


def forward_hidden(params: dict, cfg: ModelConfig, tokens: Tensor,
                   positions: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Returns (final hidden ``[B, S, D]``, aux loss); the aux loss is the
    MoE balance term, zero for the dense family."""
    _dense_only(cfg)
    x = layers.embed(params["embed"], tokens, cfg.compute_dtype)
    for n in range(cfg.n_periods):
        x = _apply_period(cfg, _period(params["periods"], n), x, positions)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def _unembed_table(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def lm_logits(params, cfg, tokens, positions=None):
    """Full logits ``[B, S, V]`` (small models and tests only)."""
    hidden, _ = forward_hidden(params, cfg, tokens, positions)
    return layers.unembed(hidden, _unembed_table(params, cfg), cfg.final_softcap)


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-period caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> dict:
    """Stacked per-period KV caches ``[n_periods, batch, Hk, max_len, Dh]``
    in the compute dtype, zeros, on ``device`` (``None``: the GPU)."""
    _dense_only(cfg)
    device = resolve_device(device)
    shape = (cfg.n_periods, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    dt = cfg.compute_dtype
    return {f"sub{i}": {"k": torch.zeros(shape, dtype=dt, device=device),
                        "v": torch.zeros(shape, dtype=dt, device=device)}
            for i in range(cfg.period)}


def decode_step(params: dict, cfg: ModelConfig, caches: dict, token: Tensor,
                pos: Tensor) -> tuple[Tensor, dict]:
    """One decode step: logits ``[B, V]``, and the caches with this token's
    k/v written at ``pos`` (in place: the returned dict is ``caches``)."""
    _dense_only(cfg)
    x = layers.embed(params["embed"], token, cfg.compute_dtype)  # [B,1,D]
    for n in range(cfg.n_periods):
        pp = _period(params["periods"], n)
        cache_p = _period(caches, n)
        for i in range(cfg.period):
            sub = pp[f"sub{i}"]
            h = layers.rms_norm(x, sub["norm1"], cfg.norm_eps)
            h, _ = attn.attention_decode(
                sub["mixer"], cfg, h, cache_p[f"sub{i}"]["k"],
                cache_p[f"sub{i}"]["v"], pos, window=cfg.layer_window(i))
            x = _mlp_block(cfg, sub, x + h)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x[:, 0], _unembed_table(params, cfg),
                            cfg.final_softcap)
    return logits, caches


def prefill(params: dict, cfg: ModelConfig, tokens: Tensor, max_len: int,
            positions: Tensor | None = None) -> tuple[Tensor, dict]:
    """Process a prompt ``[B, S]``: last-position logits ``[B, V]`` and the
    caches, filled to ``S`` and zero-padded to ``max_len``."""
    _dense_only(cfg)
    x = layers.embed(params["embed"], tokens, cfg.compute_dtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    per_period = []
    for n in range(cfg.n_periods):
        pp = _period(params["periods"], n)
        cache_out = {}
        for i in range(cfg.period):
            sub = pp[f"sub{i}"]
            h = layers.rms_norm(x, sub["norm1"], cfg.norm_eps)
            h, (kT, vT) = attn.attention_prefill(
                sub["mixer"], cfg, h, positions, window=cfg.layer_window(i))
            pad = (0, 0, 0, max_len - S)
            cache_out[f"sub{i}"] = {"k": torch.nn.functional.pad(kT, pad),
                                    "v": torch.nn.functional.pad(vT, pad)}
            x = _mlp_block(cfg, sub, x + h)
        per_period.append(cache_out)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x[:, -1], _unembed_table(params, cfg),
                            cfg.final_softcap)
    return logits, _stack(per_period)

"""Whisper-style encoder-decoder backbone (audio frontend stubbed): the port of
``repro.models.encdec``.

The conv frontend is a stub, as in the reference: callers pass precomputed
frame embeddings ``[B, n_ctx, D]`` (whisper-large-v3: 1500 x 1280).
Positions are learned and absolute (``enc_pos``, ``dec_pos``, added to the
embeddings), so attention runs without rotation.  Decoder layer = causal
self-attention + cross-attention over the encoder output + SwiGLU MLP.

The parameter tree is the reference's: ``enc_layers`` and ``dec_layers``
stacked on a leading layer axis, so that ``convert.params_from_arrays``
carries it unchanged.  The reference scans over the stacks; the port loops
over them in Python.  Every attention with more than one query row, and the
cross-attention of a decode step (one query row against the encoder's
frames, the reference's ``_sdpa`` there), goes through
``ops.flash_attention``: the kernel on the card.  With ``cfg.remat`` and
grad enabled, each encoder layer, each decoder layer and each chunk of the
loss is checkpointed (``lm.remat_call``), as the reference's
``jax.checkpoint`` does.

Decode: the self-attention KV cache (``k``, ``v``, ``[L, B, Hk, max_len,
Dh]``) and the cross K/V (``ck``, ``cv``, ``[L, B, Hk, n_ctx, Dh]``),
computed once at prefill.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.core import resolve_device
from repro_torch.dist.act_sharding import is_dtensor, merge_last, shard_act
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _stack, _unstack, chunked_loss, remat_call


def _init_enc_layer(generator: torch.Generator, cfg) -> dict:
    dev = generator.device
    return {
        "norm1": layers.init_rms_norm(cfg.d_model, dev),
        "attn": attn.init_attention(generator, cfg),
        "norm2": layers.init_rms_norm(cfg.d_model, dev),
        "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff),
    }


def _init_dec_layer(generator: torch.Generator, cfg) -> dict:
    dev = generator.device
    return {
        "norm1": layers.init_rms_norm(cfg.d_model, dev),
        "self_attn": attn.init_attention(generator, cfg),
        "norm_x": layers.init_rms_norm(cfg.d_model, dev),
        "cross_attn": attn.init_attention(generator, cfg),
        "norm2": layers.init_rms_norm(cfg.d_model, dev),
        "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff),
    }


def init_encdec(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random f32 parameters on ``generator.device``, drawn from it in
    order (embedding, position tables, encoder layers, decoder layers)."""
    enc, dev = cfg.encoder, generator.device
    max_pos = cfg.max_position or 32_768
    return {
        "embed": layers.init_embed(generator, cfg.vocab, cfg.d_model),
        "enc_pos": layers.trunc_normal(generator, (enc.n_ctx, cfg.d_model),
                                       scale=0.01),
        "dec_pos": layers.trunc_normal(generator, (max_pos, cfg.d_model),
                                       scale=0.01),
        "enc_layers": _stack([_init_enc_layer(generator, cfg)
                              for _ in range(enc.n_layers)]),
        "dec_layers": _stack([_init_dec_layer(generator, cfg)
                              for _ in range(cfg.n_layers)]),
        "enc_final_norm": layers.init_rms_norm(cfg.d_model, dev),
        "final_norm": layers.init_rms_norm(cfg.d_model, dev),
    }


def encode(params: dict, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """frames ``[B, n_ctx, D]`` (stub embeddings) -> encoder states: each
    layer's attention is non-causal over all frames."""
    dt = cfg.compute_dtype
    pos, n = params["enc_pos"], frames.shape[1]
    rows = (layers.weight(pos, dt)[None, :n] if is_dtensor(pos)
            else pos[None, :n].to(dt))
    x = frames.to(dt) + rows
    for lp in _unstack(params["enc_layers"], cfg.encoder.n_layers):
        x = remat_call(cfg, _enc_layer, cfg, lp, x)
    return layers.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _enc_layer(cfg, lp: dict, x: Tensor) -> Tensor:
    x = shard_act(x, ("batch", "seq", None))
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = shard_act(x + attn.attention(lp["attn"], cfg, h, causal=False),
                  ("batch", "seq", None))
    h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    return shard_act(x + layers.mlp(lp["mlp"], h), ("batch", "seq", None))


def _embed_tokens(params, cfg, tokens: Tensor, positions: Tensor) -> Tensor:
    """Token embeddings plus the learned positions ``positions`` ``[S]``
    (prefill, shared by the batch) or ``[B, 1]`` (decode)."""
    dt = cfg.compute_dtype
    x = layers.embed(params["embed"], tokens, dt)
    return x + layers.embed(params["dec_pos"], positions, dt)


def _dec_trunk(params, cfg, tokens: Tensor, enc_out: Tensor) -> Tensor:
    """The decoder over the whole token sequence (teacher forcing)."""
    S = tokens.shape[1]
    x = _embed_tokens(params, cfg, tokens,
                      torch.arange(S, device=tokens.device))
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        x = remat_call(cfg, _dec_layer, cfg, lp, x, enc_out)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _dec_layer(cfg, lp: dict, x: Tensor, enc_out: Tensor) -> Tensor:
    x = shard_act(x, ("batch", "seq", None))
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = shard_act(x + attn.attention(lp["self_attn"], cfg, h, causal=True),
                  ("batch", "seq", None))
    h = layers.rms_norm(x, lp["norm_x"], cfg.norm_eps)
    x = shard_act(x + attn.attention(lp["cross_attn"], cfg, h, kv_x=enc_out),
                  ("batch", "seq", None))
    h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    return shard_act(x + layers.mlp(lp["mlp"], h), ("batch", "seq", None))


def encdec_loss(params, cfg, frames: Tensor, tokens: Tensor,
                labels: Tensor) -> Tensor:
    """Teacher-forced cross-entropy over the labels ``>= 0`` (-100 masked),
    the logits made ``LOSS_CHUNK`` positions at a time, as in the
    reference; the tied embedding is the head and there is no softcap."""
    hidden = _dec_trunk(params, cfg, tokens, encode(params, cfg, frames))
    return chunked_loss(cfg, hidden, params["embed"], labels)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_encdec_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device=None) -> dict:
    """Zero caches on ``device`` (``None``: the GPU) in the compute dtype:
    ``k``, ``v`` ``[L, batch, Hk, max_len, Dh]``, ``ck``, ``cv`` ``[L,
    batch, Hk, n_ctx, Dh]``."""
    device = resolve_device(device)
    L, dt = cfg.n_layers, cfg.compute_dtype
    kv = (L, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    cross = (L, batch, cfg.n_kv_heads, cfg.encoder.n_ctx, cfg.d_head)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, shape in (("k", kv), ("v", kv), ("ck", cross),
                                ("cv", cross))}


def _cross(lp, cfg, q: Tensor, ckT: Tensor, cvT: Tensor) -> Tensor:
    """Cross-attention of the queries q ``[B, S, Hq, Dh]`` over the
    encoder's keys and values ``[B, Hk, n_ctx, Dh]``, through its output
    projection."""
    o = attn.sdpa(q.transpose(1, 2), ckT, cvT, causal=False, window=None,
                  softcap=0.0, scale=cfg.d_head ** -0.5)
    o = merge_last(o.transpose(1, 2))
    return o @ layers.weight(lp["cross_attn"]["wo"], q.dtype)


def encdec_prefill(params, cfg, frames: Tensor, tokens: Tensor,
                   max_len: int) -> tuple[Tensor, dict]:
    """Encode the frames, prefill the decoder prompt ``[B, S]``: the last
    position's logits ``[B, V]`` and every cache, k/v zero-padded to
    ``max_len``."""
    enc_out = encode(params, cfg, frames)
    S = tokens.shape[1]
    x = _embed_tokens(params, cfg, tokens,
                      torch.arange(S, device=tokens.device))
    per_layer = []
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        h, (kT, vT) = attn.attention_prefill(lp["self_attn"], cfg, h, None)
        x = x + h
        h = layers.rms_norm(x, lp["norm_x"], cfg.norm_eps)
        q, ck, cv = attn.project_qkv(lp["cross_attn"], cfg, h, enc_out)
        ckT, cvT = (t.transpose(1, 2).contiguous() for t in (ck, cv))
        x = x + _cross(lp, cfg, q, ckT, cvT)
        h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + layers.mlp(lp["mlp"], h)
        pad = (0, 0, 0, max_len - S)
        per_layer.append({"k": F.pad(kT, pad), "v": F.pad(vT, pad),
                          "ck": ckT, "cv": cvT})
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(x[:, -1], params["embed"]), _stack(per_layer)


def encdec_decode_step(params, cfg, caches: dict, token: Tensor,
                       pos: Tensor) -> tuple[Tensor, dict]:
    """One decoder token ``[B, 1]`` at positions ``pos`` ``[B]``: logits
    ``[B, V]``, and the caches with k/v written at ``pos`` (in place: the
    returned dict is ``caches``)."""
    x = _embed_tokens(params, cfg, token, pos[:, None])
    for lp, cache in zip(_unstack(params["dec_layers"], cfg.n_layers),
                         _unstack(caches, cfg.n_layers)):
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        h, _ = attn.attention_decode(lp["self_attn"], cfg, h, cache["k"],
                                     cache["v"], pos)
        x = x + h
        h = layers.rms_norm(x, lp["norm_x"], cfg.norm_eps)
        q = attn.project_q(lp["cross_attn"], cfg, h)
        x = x + _cross(lp, cfg, q, cache["ck"], cache["cv"])
        h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + layers.mlp(lp["mlp"], h)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(x[:, 0], params["embed"]), caches

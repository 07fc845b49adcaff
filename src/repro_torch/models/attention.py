"""GQA attention with a KV cache: the port of ``repro.models.attention``.

Prefill and the full-sequence trunk go through ``kernels.ops.flash_attention``,
which launches the hand-written CUDA kernel for CUDA tensors and runs the
plain version (``ref.attention_ref``) for CPU tensors; the reference's
``attn_impl`` knob has no counterpart.  Single-token decode stays plain
tensor code, as in the reference: an einsum over the cache, no kernel.

Supports GQA, causal masking, sliding windows, the attention-logit softcap,
qk-norm and RoPE.  Not ported: M-RoPE (vlm), learned positions and
cross-attention as encdec uses them, the reference's XLA ``flash_xla`` (the
port has no impl knob) and ``_decode_flash_lsharded`` (it needs a device
mesh).
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG
from repro_torch.models import layers


def init_attention(generator: torch.Generator, cfg) -> dict:
    D = cfg.d_model
    q_dim = cfg.n_heads * cfg.d_head
    kv_dim = cfg.n_kv_heads * cfg.d_head
    p = {
        "wq": layers.trunc_normal(generator, (D, q_dim)),
        "wk": layers.trunc_normal(generator, (D, kv_dim)),
        "wv": layers.trunc_normal(generator, (D, kv_dim)),
        "wo": layers.trunc_normal(generator, (q_dim, D)),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rms_norm(cfg.d_head, generator.device)
        p["k_norm"] = layers.init_rms_norm(cfg.d_head, generator.device)
    return p


def _sdpa(q, k, v, *, causal, window, softcap, scale):
    # the kernel takes contiguous [B, H, S, D]; the plain version any layout
    return ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, softcap=softcap, scale=scale)


def _project_qkv(params, cfg, x):
    """Project and head-split: q ``[B, S, Hq, Dh]``, k/v ``[B, S, Hk, Dh]``."""
    dt = x.dtype
    B, S, _ = x.shape
    q = (x @ params["wq"].to(dt)).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (x @ params["wk"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (x @ params["wv"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope(cfg, q, k, positions):
    if cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"{cfg.name}: pos_embed={cfg.pos_embed!r} (encdec) is not ported")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE (vlm) is not ported")
    if positions.dim() == 3:
        positions = positions[0]
    return (layers.apply_rope(q, positions, cfg.rope_theta),
            layers.apply_rope(k, positions, cfg.rope_theta))


def _default_positions(x: Tensor) -> Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device)[None].expand(B, S)


def attention(params: dict, cfg, x: Tensor, positions: Tensor | None = None,
              *, causal: bool = True, window: int | None = None) -> Tensor:
    """Self-attention over the whole sequence (the trunk of ``lm_logits``)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x)
    if positions is None:
        positions = _default_positions(x)
    q, k = _rope(cfg, q, k, positions)
    out = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window, softcap=cfg.attn_softcap,
                scale=cfg.d_head ** -0.5)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return out @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

def attention_prefill(params, cfg, x, positions, *, window=None):
    """Prefill: attention over the prompt, and this layer's ``(k, v)``
    ``[B, Hk, S, Dh]`` for the cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x)
    if positions is None:
        positions = _default_positions(x)
    q, k = _rope(cfg, q, k, positions)
    kT, vT = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    out = _sdpa(q.transpose(1, 2), kT, vT, causal=True, window=window,
                softcap=cfg.attn_softcap, scale=cfg.d_head ** -0.5)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return out @ params["wo"].to(x.dtype), (kT, vT)


def attention_decode(params: dict, cfg, x: Tensor, k_cache: Tensor,
                     v_cache: Tensor, pos: Tensor, *,
                     window: int | None = None):
    """One-token decode: write k/v at ``pos`` into the caches ``[B, Hk, L,
    Dh]`` in place, then attend over the valid prefix.

    The reference blends the new row in with a one-hot mask
    (``cache * (1 - oh) + oh * new``); the port writes it with an indexed
    store, which gives the same values for finite inputs.  A slot whose
    ``pos`` has run past the cache (an idle slot of the serving engine)
    writes nothing, as the reference's all-zero one-hot does.
    """
    B = x.shape[0]
    L = k_cache.shape[2]
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _rope(cfg, q, k, pos[:, None])
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)              # [B,Hk,1,Dh]

    rows = torch.arange(B, device=x.device)
    fits = (pos < L)[:, None, None]
    at = pos.clamp(max=L - 1)
    for cache, new in ((k_cache, kT), (v_cache, vT)):
        old = cache[rows, :, at]                               # [B,Hk,Dh]
        cache[rows, :, at] = torch.where(fits, new[:, :, 0].to(cache.dtype),
                                         old)

    Hk = cfg.n_kv_heads
    g = cfg.n_heads // Hk
    qg = q.transpose(1, 2).reshape(B, Hk, g, 1, cfg.d_head).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.float())
    s = s * (cfg.d_head ** -0.5)
    if cfg.attn_softcap > 0.0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    col = torch.arange(L, device=x.device)[None, :]
    posb = pos[:, None]
    valid = col <= posb                                        # [B,L]
    if window is not None:
        valid &= col > posb - window
    s = s.masked_fill(~valid[:, None, None, None], NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.float())
    out = out.reshape(B, Hk * g, 1, cfg.d_head).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.d_head)
    return out @ params["wo"].to(x.dtype), (k_cache, v_cache)

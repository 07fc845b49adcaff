"""GQA attention with a KV cache: the port of ``repro.models.attention``.

Prefill and the full-sequence trunk go through ``kernels.ops.flash_attention``,
which launches the hand-written CUDA kernel for CUDA tensors and runs the
plain version (``ref.attention_ref``) for CPU tensors; the reference's
``attn_impl`` knob has no counterpart.  Single-token decode stays plain
tensor code, as in the reference: an einsum over the cache, no kernel.

Supports GQA, causal masking, sliding windows, the attention-logit softcap,
qk-norm, RoPE and M-RoPE (vlm: ``[3, B, S]`` positions), learned absolute
positions (encdec: no rotation here; the positions are added to the
embeddings) and cross-attention (``kv_x``: keys and values from the encoder
states, no causal mask).  Inside an ``activation_shardings`` context whose
tensor-parallel axis does not divide the kv heads but divides the cache
length, a decode step runs ``_decode_flash_lsharded`` over the mesh (one
process per rank).  Not ported: the reference's XLA ``flash_xla`` (the port
has no impl knob).
"""
from __future__ import annotations

import functools

import torch
from torch import Tensor

from repro_torch.dist import act_sharding, spmd
from repro_torch.dist.act_sharding import merge_last, shard_act, split_last
from repro_torch.dist.sharding import P
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


def sdpa(q, k, v, *, causal, window, softcap, scale):
    """q ``[B, Hq, Sq, Dh]``, k/v ``[B, Hk, Sk, Dh]`` through
    ``ops.flash_attention`` (the kernel takes them contiguous; the plain
    version any layout)."""
    return ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, softcap=softcap, scale=scale)


def project_q(params, cfg, x):
    """The query projection alone, head-split ``[B, S, Hq, Dh]`` (a decode
    step's cross-attention reads its keys and values from the cache)."""
    q = split_last(x @ layers.weight(params["wq"], x.dtype), cfg.n_heads,
                   cfg.d_head)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
    return q


def project_qkv(params, cfg, x, kv_x=None):
    """Project and head-split: q ``[B, S, Hq, Dh]`` from x, k/v ``[B, Skv,
    Hk, Dh]`` from ``kv_x`` (the cross-attention source; default x)."""
    dt = x.dtype
    src = x if kv_x is None else kv_x
    k, v = (split_last(src @ layers.weight(params[w], dt), cfg.n_kv_heads,
                       cfg.d_head) for w in ("wk", "wv"))
    if cfg.qk_norm:
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    heads = ("batch", None, "model", None)
    return (shard_act(project_q(params, cfg, x), heads), shard_act(k, heads),
            shard_act(v, heads))


def _rope(cfg, q, k, positions):
    """RoPE on q and k ``[B, S, H, Dh]``, by the reference's branches: none
    for learned positions; M-RoPE for ``[3, B, S]`` positions with
    ``mrope_sections`` set; plain RoPE otherwise (stream 0 of 3-D
    positions); ``None`` means ``0 .. S-1``."""
    if cfg.pos_embed != "rope":
        return q, k
    if positions is None:
        B, S = q.shape[:2]
        positions = torch.arange(S, device=q.device)[None].expand(B, S)
    if cfg.mrope_sections is not None and positions.dim() == 3:
        return tuple(layers.apply_mrope(t, positions, cfg.rope_theta,
                                        cfg.mrope_sections) for t in (q, k))
    if positions.dim() == 3:
        positions = positions[0]
    return (layers.apply_rope(q, positions, cfg.rope_theta),
            layers.apply_rope(k, positions, cfg.rope_theta))


def attention(params: dict, cfg, x: Tensor, positions: Tensor | None = None,
              *, causal: bool = True, window: int | None = None,
              kv_x: Tensor | None = None) -> Tensor:
    """Attention over the whole sequence (the trunk of ``lm_logits`` and of
    the encoder-decoder): self-attention, or cross-attention over ``kv_x``,
    which takes no rotation and no causal mask."""
    q, k, v = project_qkv(params, cfg, x, kv_x)
    if kv_x is None:
        q, k = _rope(cfg, q, k, positions)
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=causal and kv_x is None, window=window,
               softcap=cfg.attn_softcap, scale=cfg.d_head ** -0.5)
    out = merge_last(out.transpose(1, 2))
    return out @ layers.weight(params["wo"], x.dtype)


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

def attention_prefill(params, cfg, x, positions, *, window=None):
    """Prefill: attention over the prompt, and this layer's ``(k, v)``
    ``[B, Hk, S, Dh]`` for the cache."""
    q, k, v = project_qkv(params, cfg, x)
    q, k = _rope(cfg, q, k, positions)
    kT, vT = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    out = sdpa(q.transpose(1, 2), kT, vT, causal=True, window=window,
               softcap=cfg.attn_softcap, scale=cfg.d_head ** -0.5)
    out = merge_last(out.transpose(1, 2))
    return out @ layers.weight(params["wo"], x.dtype), (kT, vT)


def _write_rows(cache: Tensor, new: Tensor, at: Tensor, fits: Tensor) -> None:
    """``cache[b, :, at[b]] = new[b, :, 0]`` where ``fits[b]``, in place;
    a ``DTensor`` cache (split over its batch and heads) on each rank's
    block."""
    if act_sharding.is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        rows = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                     for pl in cache.placements)

        def block(c, n, a, f):
            _write_rows(c, n, a, f)
            return c

        local_map(block, out_placements=list(cache.placements),
                  in_placements=(cache.placements, cache.placements, rows,
                                 rows),
                  device_mesh=cache.device_mesh,
                  redistribute_inputs=True)(cache, new, at, fits)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    old = cache[rows, :, at]                                   # [B,Hk,Dh]
    cache[rows, :, at] = torch.where(fits[:, None, None],
                                     new[:, :, 0].to(cache.dtype), old)


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
    q, k, v = project_qkv(params, cfg, x)
    positions = pos[:, None]
    if cfg.mrope_sections is not None:       # the same position, 3 streams
        positions = positions[None].expand(3, B, 1)
    q, k = _rope(cfg, q, k, positions)
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)              # [B,Hk,1,Dh]

    state = act_sharding.current_state()
    if state is not None and state[1].tp is not None:
        mesh, rules, _ = state
        ntp = spmd.axis_size(mesh, rules.tp)
        if cfg.n_kv_heads % ntp != 0 and L % ntp == 0:
            out = _decode_flash_lsharded(cfg, mesh, rules, q.transpose(1, 2),
                                         kT, vT, k_cache, v_cache, pos,
                                         window)
            return (out @ layers.weight(params["wo"], x.dtype),
                    (k_cache, v_cache))

    at, fits = pos.clamp(max=L - 1), pos < L
    _write_rows(k_cache, kT, at, fits)
    _write_rows(v_cache, vT, at, fits)

    qT = q.transpose(1, 2)                                     # [B,Hq,1,Dh]
    attend = functools.partial(_decode_attend, cfg, window=window)
    if act_sharding.is_dtensor(qT):
        out = ops.heads_local_map("attention_decode", attend, qT, k_cache,
                                  v_cache, pos)
    else:
        out = attend(qT, k_cache, v_cache, pos)
    out = merge_last(out.transpose(1, 2))
    return out @ layers.weight(params["wo"], x.dtype), (k_cache, v_cache)


def _decode_attend(cfg, q, k_cache, v_cache, pos, *, window=None):
    """q ``[B, Hq, 1, Dh]`` over the caches' valid prefix (keys up to
    ``pos[b]``) -> ``[B, Hq, 1, Dh]`` in q's dtype, in f32 inside.  On a
    mesh it runs on each rank's block of whole batch rows and heads."""
    B, L = q.shape[0], k_cache.shape[2]
    Hk = k_cache.shape[1]
    g = q.shape[1] // Hk
    qg = q.reshape(B, Hk, g, 1, cfg.d_head).float()
    # the reference's constraint; a rank's block already is that layout
    s = shard_act(torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.float()),
                  ("batch", "model", None, None, None))
    s = s * (cfg.d_head ** -0.5)
    if cfg.attn_softcap > 0.0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    col = torch.arange(L, device=q.device)[None, :]
    posb = pos[:, None]
    valid = col <= posb                                        # [B,L]
    if window is not None:
        valid &= col > posb - window
    s = s.masked_fill(~valid[:, None, None, None], NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.float())
    return out.reshape(B, Hk * g, 1, cfg.d_head).to(q.dtype)


# ---------------------------------------------------------------------------
# flash decoding over a length-sharded KV cache
# ---------------------------------------------------------------------------

def _decode_flash_lsharded(cfg, mesh, rules, q, kT, vT, k_cache, v_cache,
                           pos, window):
    """Decode attention with the cache split on its length over ``tp``
    (the reference's ``_decode_flash_lsharded``).  Each rank writes the new
    row where ``pos`` falls in its shard and computes an unnormalised
    softmax over its shard; the ranks' (max, sum, weighted values) are
    gathered and merged by a log-sum-exp, so the bytes a layer moves are
    O(Hq x Dh x ranks), not the cache's.  f32, as in the reference.

    q ``[B, Hq, 1, Dh]``; kT / vT ``[B, Hk, 1, Dh]``; the caches ``[B, Hk,
    L, Dh]`` are updated in place.  Returns ``[B, 1, Hq * Dh]``."""
    tp = rules.tp
    B = q.shape[0]
    Hk = k_cache.shape[1]
    g = cfg.n_heads // Hk
    scale = cfg.d_head ** -0.5
    softcap = cfg.attn_softcap
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    baxes, prod = [], 1                   # the batch axes that divide B
    for a in rules.batch:
        if a in sizes and B % (prod * sizes[a]) == 0:
            baxes.append(a)
            prod *= sizes[a]
    bspec = tuple(baxes) if len(baxes) > 1 else (baxes[0] if baxes else None)

    def local(q, kT, vT, kc, vc, pos):
        b_loc, l_loc = q.shape[0], kc.shape[2]
        col0 = spmd.axis_index(mesh, tp) * l_loc
        idx = pos - col0
        mine = (idx >= 0) & (idx < l_loc)
        at = idx.clamp(0, l_loc - 1)
        _write_rows(kc, kT, at, mine)
        _write_rows(vc, vT, at, mine)

        qg = q.reshape(b_loc, Hk, g, 1, cfg.d_head).float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc.float()) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        col = col0 + torch.arange(l_loc, device=q.device)[None, :]
        valid = col <= pos[:, None]
        if window is not None:
            valid &= col > pos[:, None] - window
        s = torch.where(valid[:, None, None, None], s, NEG)
        m_loc = s.amax(-1, keepdim=True)                       # [B,Hk,g,1,1]
        p = torch.where(s > NEG / 2, torch.exp(s - m_loc), 0.0)
        l_sum = p.sum(-1, keepdim=True)
        acc = torch.einsum("bhgqk,bhkd->bhgqd", p, vc.float())

        # merge the shards: a small exchange of statistics
        m_all, l_all, a_all = (spmd.all_gather(t[None], mesh, tp, 0)
                               for t in (m_loc, l_sum, acc))
        m_g = m_all.amax(0)
        w = torch.exp(m_all - m_g[None])
        out = (a_all * w).sum(0) / (l_all * w).sum(0).clamp_min(1e-30)
        return (out.reshape(b_loc, Hk * g, 1, cfg.d_head).to(kT.dtype),
                kc, vc)

    out, kc, vc = spmd.shard_map(
        local, mesh,
        in_specs=(P(bspec, None, None, None), P(bspec, None, None, None),
                  P(bspec, None, None, None), P(bspec, None, tp, None),
                  P(bspec, None, tp, None), P(bspec)),
        out_specs=(P(bspec, None, None, None), P(bspec, None, tp, None),
                   P(bspec, None, tp, None)),
    )(q, kT, vT, k_cache, v_cache, pos)
    k_cache.copy_(kc)
    v_cache.copy_(vc)
    return merge_last(out.transpose(1, 2))

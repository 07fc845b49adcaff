"""Shared model primitives: norms, rotary embeddings (incl. M-RoPE), SwiGLU,
embeddings.

The port of ``repro.models.layers``, to the same math.  Parameters are plain
nested dicts of tensors, kept in f32 and cast to the compute dtype at each
use, as in the reference.  Initialisation draws from an explicit
``torch.Generator`` on the device the parameters are made on; its numbers
differ from ``jax.random``'s, so parity tests carry the reference's
parameters across (``convert.params_from_arrays``).  The reference's
``shard_act`` constraints are not placed yet: ``dist.shard_act`` exists,
and its call sites come with the sharded train step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor


def trunc_normal(generator: torch.Generator, shape, scale: float | None = None,
                 dtype=torch.float32) -> Tensor:
    """``std`` times a standard normal truncated to [-2, 2]; ``std`` is
    ``scale`` or fan-in ``**-0.5`` (product of all but the last dim)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    if len(shape) >= 2:
        fan_in = 1
        for d in shape[:-1]:
            fan_in *= d
    std = scale if scale is not None else fan_in ** -0.5
    x = torch.empty(shape, dtype=dtype, device=generator.device)
    if not isinstance(x, FakeTensor):    # Model.param_specs draws nothing
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return x.mul_(std)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in f32; ``scale`` is stored as ``scale - 1`` (gemma-style)
    and multiplies as ``1 + scale``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def init_rms_norm(d: int, device=None) -> Tensor:
    return torch.zeros(d, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def _rotate(x: Tensor, ang: Tensor) -> Tensor:
    """Rotates the split halves ``(x1, x2)`` of x's head dim (not
    interleaved pairs) by the angles ``ang`` ``[B, S, Dh/2]``, in f32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: ``[B, S, H, Dh]``; positions: ``[B, S]`` int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                # [Dh/2]
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: Tensor, positions3: Tensor, theta: float,
                sections: tuple[int, ...]) -> Tensor:
    """Multimodal RoPE (qwen2-vl): the rotary half-dims split into (t, h, w)
    sections, each rotated by its own position stream.

    x: ``[B, S, H, Dh]``; positions3: ``[3, B, S]`` (temporal, height,
    width); sections: half-dims per stream, summing to ``Dh // 2``.  The
    reference gathers a position per half-dim; the port multiplies each
    stream by its slice of the frequencies, the same f32 products.
    """
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"apply_mrope: sections {tuple(sections)} do not sum "
                         f"to Dh/2 = {dh // 2}")
    freqs = rope_freqs(dh, theta, x.device).split(list(sections))
    pos = positions3.float()
    ang = torch.cat([pos[i][..., None] * f for i, f in enumerate(freqs)], -1)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": trunc_normal(generator, (d_model, d_ff)),
        "w_up": trunc_normal(generator, (d_model, d_ff)),
        "w_down": trunc_normal(generator, (d_ff, d_model)),
    }


def mlp(params: dict, x: Tensor) -> Tensor:
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (F.silu(g) * u) @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator: torch.Generator, vocab: int, d_model: int) -> Tensor:
    return trunc_normal(generator, (vocab, d_model), scale=1.0)


def embed(table: Tensor, tokens: Tensor, dtype) -> Tensor:
    # rows first, then the cast: the same values as the reference's
    # cast-then-gather, without casting the whole table
    return table[tokens].to(dtype)


def unembed(x: Tensor, table_or_head: Tensor, softcap: float = 0.0) -> Tensor:
    """x ``[..., D]`` @ head ``[D, V]`` (or a tied embedding ``[V, D]``,
    transposed) -> f32 logits, then the final softcap."""
    w = table_or_head
    if w.shape[0] != x.shape[-1]:
        w = w.T                                                      # tied [V,D]
    logits = (x @ w.to(x.dtype)).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# remat tags (the reference's checkpoint_name(x, "remat_ckpt"))
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::remat_ckpt", mutates_args=())
def _remat_ckpt(x: Tensor) -> Tensor:
    """A copy of ``x``: the one operation a ``save_named`` checkpoint keeps
    (selective checkpointing refuses an output that aliases its input).
    Each run adds one to ``remat_ckpt.copies``; a replay that takes the
    saved copy adds nothing."""
    remat_ckpt.copies += 1
    return x.clone()


@_remat_ckpt.register_fake
def _(x: Tensor) -> Tensor:
    return torch.empty_like(x)


_remat_ckpt.register_autograd(lambda ctx, g: g)


class _Tagging:
    depth = 0


def tagging(fn):
    """``fn`` with ``remat_ckpt`` active while it runs: the forward of a
    ``save_named`` checkpoint and its replay in the backward."""
    def run(*args):
        _Tagging.depth += 1
        try:
            return fn(*args)
        finally:
            _Tagging.depth -= 1
    return run


def remat_ckpt(x: Tensor) -> Tensor:
    """Tag ``x`` as a value a ``save_named`` checkpoint keeps; ``x`` itself
    outside one."""
    return torch.ops.repro_torch.remat_ckpt(x) if _Tagging.depth else x


remat_ckpt.copies = 0

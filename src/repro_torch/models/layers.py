"""Shared model primitives: norms, rotary embeddings (incl. M-RoPE), SwiGLU,
embeddings.

The port of ``repro.models.layers``, to the same math.  Parameters are plain
nested dicts of tensors, kept in f32 and cast to the compute dtype at each
use, as in the reference.  Initialisation draws from an explicit
``torch.Generator`` on the device the parameters are made on; its numbers
differ from ``jax.random``'s, so parity tests carry the reference's
parameters across (``convert.params_from_arrays``).  The reference's
``shard_act`` constraints stand at their counterparts, and every weight is
cast at its use through ``weight``, which also gathers an FSDP-sharded
``DTensor`` over its data axes; outside a mesh both add no operation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.dist import act_sharding
from repro_torch.dist.act_sharding import shard_act


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


def weight(p: Tensor, dt) -> Tensor:
    """Parameter ``p`` in the compute dtype ``dt`` for one use: the cast,
    then (a ``DTensor`` sharded over the FSDP axes) the gather over them."""
    return act_sharding.gather_fsdp(p.to(dt))


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
    g = shard_act(x @ weight(params["w_gate"], dt), ("batch", None, "model"))
    u = shard_act(x @ weight(params["w_up"], dt), ("batch", None, "model"))
    return (F.silu(g) * u) @ weight(params["w_down"], dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator: torch.Generator, vocab: int, d_model: int) -> Tensor:
    return trunc_normal(generator, (vocab, d_model), scale=1.0)


def embed(table: Tensor, tokens: Tensor, dtype) -> Tensor:
    # rows first, then the cast: the same values as the reference's
    # cast-then-gather, without casting the whole table
    if act_sharding.is_dtensor(table):
        return _embed_sharded(table, tokens, dtype)
    return table[tokens].to(dtype)


def _embed_sharded(table, tokens, dtype):
    """The lookup on a ``DTensor`` table, vocabulary-parallel (Megatron's):
    the table keeps its rows split over the mesh dims that split the
    vocabulary and is gathered over the others.  Where that gather moves
    data it moves the table cast to the compute dtype, as the reference's
    cast-then-gather does (and the gradient of a repeated token then adds
    up in that dtype, as in the reference); where it moves nothing (a mesh
    dim of one rank) the rows are cast after the lookup, as on one device.
    Under ``local_map`` each rank takes the rows of its tokens that fall in
    its slice, zeros for the others, and the rows are summed over the
    vocabulary's ranks (one term is non-zero, so the sum is exact).  The
    table's gradient stays on each rank's slice, partial over the mesh
    dims that split the tokens.

    DTensor's own vocabulary-parallel lookup (``F.embedding`` on a table
    split on dim 0, a ``MaskPartial`` output) cannot stand in: with the
    tokens split over ``"data"`` beside the vocabulary over ``"model"``
    its reduction fails in torch 2.13 (the mask of one rank's tokens,
    ``[1, 32]``, against partial rows ``[2, 32, 32]``;
    tests/test_torch_train_sharded.py, gloo, (2, 2))."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist import spmd

    mesh = table.device_mesh
    if not act_sharding.is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    vocab = [i for i, pl in enumerate(table.placements)
             if pl.is_shard(0) and mesh.size(i) > 1]
    wp = tuple(Shard(0) if i in vocab else Replicate()
               for i in range(mesh.ndim))
    tp = tuple(Replicate() if i in vocab else pl
               for i, pl in enumerate(tokens.placements))
    wg = tuple(Shard(0) if i in vocab else
               (Partial() if pl.is_shard() else Replicate())
               for i, pl in enumerate(tp))
    if any(pl.is_shard() and i not in vocab and mesh.size(i) > 1
           for i, pl in enumerate(table.placements)):
        table = table.to(dtype)
    table = table.redistribute(mesh, wp)
    tokens = tokens.redistribute(mesh, tp)
    names = tuple(mesh.mesh_dim_names[i] for i in vocab)
    group = spmd.axis_group(mesh, names) if vocab else None
    rows = table.shape[0] // spmd.axis_size(mesh, names)
    first = spmd.axis_index(mesh, names) * rows if vocab else 0

    def block(w, t):
        if group is None:
            return w[t].to(dtype)
        at = t.long() - first
        mine = (at >= 0) & (at < rows)
        x = w[at.clamp(0, rows - 1)].to(dtype)
        return spmd.sum_over(torch.where(mine[..., None], x, 0.0), group)

    return local_map(block, out_placements=list(tp),
                     in_placements=(wp, tp), in_grad_placements=(wg, tp),
                     device_mesh=mesh, redistribute_inputs=False)(table,
                                                                  tokens)


def unembed(x: Tensor, table_or_head: Tensor, softcap: float = 0.0) -> Tensor:
    """x ``[..., D]`` @ head ``[D, V]`` (or a tied embedding ``[V, D]``,
    transposed) -> f32 logits, then the final softcap."""
    w = table_or_head
    if w.shape[0] != x.shape[-1]:
        w = w.T                                                      # tied [V,D]
    logits = (x @ weight(w, x.dtype)).float()
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

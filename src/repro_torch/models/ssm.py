"""Mamba2 block (state-space duality): the port of ``repro.models.ssm``.

Train, full-sequence forward and prefill: the chunk-parallel SSD through
``kernels.ops.ssd_scan``, which launches the hand-written CUDA kernel (with
a gradient, ``SSDScan``; at prefill with its final-state output) for CUDA
tensors and runs the plain version for CPU tensors.  Decode is the O(1)
recurrent update carrying (conv window, SSM state) per layer.

Layout per block (following Mamba2): separate projections D -> z (d_inner),
x (d_inner), B (G*N), C (G*N), dt (H); a causal depthwise conv (width w)
over the x/B/C channels; SSD over H heads of head_dim P = d_inner / H; a
gated RMSNorm (z branch); out_proj d_inner -> D.  The reference keeps the
projections separate for its tensor-parallel shardings; the port keeps them
so that the parameter trees match.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.dist.act_sharding import (
    is_dtensor, merge_last, shard_act, split_last)
from repro_torch.kernels import ops
from repro_torch.models import layers


def _dims(cfg):
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.n_ssm_heads(cfg.d_model)


def init_ssm(generator: torch.Generator, cfg) -> dict:
    """Random parameters on ``generator.device``, drawn in the reference's
    order (w_z, w_x, w_B, w_C, w_dt, conv_w, out_proj)."""
    s, di, H = _dims(cfg)
    gn = s.n_groups * s.d_state
    dev = generator.device
    w_z, w_x, w_B, w_C, w_dt = (
        layers.trunc_normal(generator, (cfg.d_model, w))
        for w in (di, di, gn, gn, H))
    conv_w = layers.trunc_normal(generator, (s.conv_width, di + 2 * gn),
                                 scale=0.5)
    out_proj = layers.trunc_normal(generator, (di, cfg.d_model))
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_z": w_z, "w_x": w_x, "w_B": w_B, "w_C": w_C, "w_dt": w_dt,
        "conv_w": conv_w,
        "conv_b": torch.zeros(di + 2 * gn, **f32),
        "A_log": torch.linspace(1.0, 16.0, H, **f32).log(),
        "D": torch.ones(H, **f32),
        "dt_bias": torch.full((H,), 0.01, **f32).expm1().log(),
        "norm": layers.init_rms_norm(di, dev),
        "out_proj": out_proj,
    }


def _project(params: dict, x: Tensor):
    """Separate projections -> (z, x, B, C, dt_raw); all but dt_raw laid
    out with their channels over ``"model"``."""
    dt_ = x.dtype
    z, xs, bs, cs, dt_raw = (x @ layers.weight(params[k], dt_)
                             for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))
    return (*(shard_act(t, ("batch", None, "model")) for t in (z, xs, bs, cs)),
            dt_raw)


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over time, then SiLU.  xbc ``[B, S, C]``; w
    ``[W, C]``; the taps are added in the reference's order."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(W):
        out = out + pad[:, i:i + S] * w[i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype))


def _causal_conv_parts(cfg, params, xs, bs, cs):
    """The conv applied to x, B and C apiece (weights stored concatenated
    ``[W, di + 2gn]``)."""
    s, di, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    w, b = params["conv_w"], params["conv_b"]
    return (_causal_conv(xs, w[:, :di], b[:di]),
            _causal_conv(bs, w[:, di:di + gn], b[di:di + gn]),
            _causal_conv(cs, w[:, di + gn:], b[di + gn:]))


def _ssd_inputs(params, cfg, x):
    """Shared by ``ssm_apply`` and ``ssm_prefill``: z, the raw conv inputs,
    and the SSD's inputs padded with ``dt = 0`` to a multiple of the chunk:
    (z, raw (x, B, C), (xh, dt, A, Bh, Ch))."""
    s, di, H = _dims(cfg)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    S = x.shape[1]
    z, xs_raw, bs_raw, cs_raw, dt_raw = _project(params, x)
    xs, bs, cs = _causal_conv_parts(cfg, params, xs_raw, bs_raw, cs_raw)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])  # [B,S,H]
    A = -torch.exp(params["A_log"].float())                          # [H] < 0
    pad = (-S) % s.chunk
    if pad:                                   # dt = 0: identity steps
        xs, bs, cs, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs, bs, cs, dt))
    inputs = (split_last(xs, H, P), dt, A, split_last(bs, G, N),
              split_last(cs, G, N))
    return z, (xs_raw, bs_raw, cs_raw), inputs


def _gate_out(params, cfg, y, z, dt_):
    y = layers.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ layers.weight(params["out_proj"], dt_)


def ssm_apply(params: dict, cfg, x: Tensor) -> Tensor:
    """Train / full-sequence path.  x ``[B, S, D]`` -> ``[B, S, D]``.

    S is padded to a multiple of the chunk with ``dt = 0`` on both devices,
    as the reference's Pallas path does; its XLA path takes
    ``chunk = min(chunk, S)`` instead and refuses a ragged S.  The results
    agree: padded steps are identities.
    """
    S = x.shape[1]
    z, _, inputs = _ssd_inputs(params, cfg, x)
    y = ops.ssd_scan(*inputs, params["D"].float(), chunk=cfg.ssm.chunk)
    return _gate_out(params, cfg, merge_last(y[:, :S]), z, x.dtype)


def ssm_prefill(params: dict, cfg, x: Tensor):
    """Prefill: outputs, the conv tail window and the final SSM state to seed
    decode.  The reference runs its plain chunked version here; the port
    routes through ``ops.ssd_scan`` with the state, so a CUDA tensor
    launches the kernel.  The inputs are padded to whole chunks with
    ``dt = 0``, which leaves the state at S."""
    s = cfg.ssm
    S = x.shape[1]
    z, raw, inputs = _ssd_inputs(params, cfg, x)
    y, h_final = ops.ssd_scan(*inputs, params["D"].float(), chunk=s.chunk,
                              return_state=True)
    out = _gate_out(params, cfg, merge_last(y[:, :S]), z, x.dtype)
    # conv tail: the last W-1 *pre-activation* conv inputs (x|B|C)
    W = s.conv_width
    xbc_raw = torch.cat(raw, dim=-1)
    tail = F.pad(xbc_raw, (0, 0, W - 1, 0))[:, -(W - 1):]
    return out, tail.to(x.dtype), h_final


# ---------------------------------------------------------------------------
# decode (recurrent) path
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, n_ssm_layers: int, dtype, device=None):
    """Zero (conv window, SSM state) for ``n_ssm_layers`` layers."""
    s, di, H = _dims(cfg)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((n_ssm_layers, batch, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((n_ssm_layers, batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def ssm_decode(params: dict, cfg, x: Tensor, conv_state: Tensor,
               ssm_state: Tensor):
    """One-token recurrent step.  x ``[B, 1, D]``; conv_state
    ``[B, W-1, conv_dim]``; ssm_state ``[B, H, P, N]``.  Returns (out
    ``[B, 1, D]``, new conv_state, new ssm_state)."""
    s, di, H = _dims(cfg)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    gn = G * N
    B = x.shape[0]
    dt_ = x.dtype

    z, xs, bs, cs, dt_raw = (t[:, 0] for t in _project(params, x))
    xbc = torch.cat([xs, bs, cs], dim=-1)                     # [B, conv_dim]
    win = torch.cat([conv_state, xbc[:, None, :]], dim=1)     # [B, W, C]
    w = params["conv_w"].to(dt_)
    conv_out = torch.einsum("bwc,wc->bc", win, w) + params["conv_b"].to(dt_)
    conv_out = F.silu(conv_out)
    new_conv_state = win[:, 1:]

    xs, bs, cs = conv_out[:, :di], conv_out[:, di:di + gn], conv_out[:, di + gn:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None])  # [B, H]
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B, H, P).float()
    bh = bs.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    ch = cs.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()

    args = (xh, bh, ch, dt, A, ssm_state)
    if is_dtensor(ssm_state):
        y, new_ssm = _recur_local_map(*args)
    else:
        y, new_ssm = _recur(*args)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, 1, di).to(dt_)
    return _gate_out(params, cfg, y, z[:, None], dt_), new_conv_state, new_ssm


def _recur(xh, bh, ch, dt, A, state):
    """The recurrence of one token: the state ``[B, H, P, N]`` decayed and
    updated, and what ``y [B, H, P]`` reads of it."""
    decay = torch.exp(dt * A)[..., None, None]                # [B,H,1,1]
    upd = (dt[..., None, None] * xh[..., None]) * bh[:, :, None, :]
    new_ssm = decay * state + upd                             # [B,H,P,N]
    return torch.einsum("bhpn,bhn->bhp", new_ssm, ch), new_ssm


def _recur_local_map(xh, bh, ch, dt, A, state):
    """``_recur`` on each rank's block of a ``DTensor`` state, laid out as
    its cache placement (any of its four dims split); the other inputs are
    redistributed to that layout (they are one token's rows).  Where the
    state splits N, each rank's read is a partial sum over those ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    sp = tuple(state.placements)
    if any(pl.is_partial() for pl in sp):
        raise ValueError(f"ssm_decode: the state is a partial sum {sp}")

    def like(dims: tuple) -> tuple:
        """The state's layout on a tensor whose dims are ``dims`` of it."""
        return tuple(Shard(dims.index(pl.dim)) if pl.is_shard()
                     and pl.dim in dims else Replicate() for pl in sp)

    xp, bp, rows, heads = like((0, 1, 2)), like((0, 1, 3)), like((0, 1)), \
        like((1,))
    yp = tuple(Partial() if pl.is_shard(3) else p for pl, p in zip(sp, xp))
    return local_map(
        _recur, out_placements=(yp, sp),
        in_placements=(xp, bp, bp, rows, heads, sp),
        device_mesh=state.device_mesh, redistribute_inputs=True)(
            xh, bh, ch, dt, A, state)


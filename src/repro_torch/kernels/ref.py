"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each is the semantic ground truth its kernel is held against on the card,
and the CPU path: a wrapper given a CPU tensor computes this.
"""
from __future__ import annotations

import torch
from torch import Tensor

INF = 3.0e38


def advance_sweep_ref(rem: Tensor, rate: Tensor, active: Tensor,
                      bound_dt: Tensor) -> tuple[Tensor, Tensor]:
    """dt to the next completion (capped by ``bound_dt``) + work depletion.

    Rank-polymorphic like ``repro.kernels.ref.advance_sweep_ref``: ``[C]``
    with a scalar bound gives a scalar ``dt``; ``[B, C]`` with a ``[B]``
    bound gives ``dt [B]``, the same per-row arithmetic.  ``rem - rate * dt``
    is two rounded operations (PyTorch never fuses them into an FMA), which
    the CUDA kernel reproduces bit for bit.
    """
    dt_fin = torch.where(active & (rate > 0), rem / rate.clamp_min(1e-30), INF)
    # min with initial=INF: pad the row so an empty row reduces to INF
    row_min = torch.nn.functional.pad(dt_fin, (0, 1), value=INF).amin(-1)
    dt = torch.minimum(row_min, bound_dt)
    new_rem = torch.where(
        active, (rem - rate * dt[..., None]).clamp_min(0.0), rem)
    return dt, new_rem


NEG = -1.0e30


def attention_mask(sq: int, sk: int, causal: bool, window: int | None,
                   device=None) -> Tensor:
    """``[sq, sk]`` bool.  Rows are aligned to the end of the key axis:
    query i sees keys ``<= i + (sk - sq)`` under causal masking, and keys
    ``> row - window`` under a sliding window."""
    row = torch.arange(sq, device=device)[:, None] + (sk - sq)
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    return mask


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: int | None = None, softcap: float = 0.0,
                  scale: float | None = None) -> Tensor:
    """Softmax attention with GQA, sliding window and logit softcap, in f32,
    with the conventions of the flash kernel
    (``repro/kernels/flash_attention.py::_flash_kernel``):

    * q ``[B, Hq, Sq, D]``, k/v ``[B, Hk, Sk, D]``; query head h reads kv
      head ``h // (Hq // Hk)``.
    * ``scale`` multiplies the product ``q . k``; the softcap
      ``c * tanh(s / c)`` comes before the mask; masked logits are -1e30.
    * A row whose keys are all masked gives 0 (``p = 0`` where
      ``s <= -5e29``, ``l`` floored at 1e-30), like the Pallas kernel.  The
      JAX package's ``ref.attention_ref`` gives such a row the uniform
      average instead; serving never makes one (``Sq == Sk``).

    The result has q's dtype.
    """
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hk, g, sq, d).float()
    # in place where it saves a [.., Sq, Sk] buffer (the card holds long ones)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()).mul_(scale)
    if softcap > 0.0:
        s = s.div_(softcap).tanh_().mul_(softcap)
    s = s.masked_fill_(~attention_mask(sq, sk, causal, window, q.device), NEG)
    keep = s > NEG / 2
    p = s.sub_(s.amax(-1, keepdim=True)).exp_().masked_fill_(~keep, 0.0)
    l_sum = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l_sum
    return out.reshape(b, hq, sq, d).to(q.dtype)

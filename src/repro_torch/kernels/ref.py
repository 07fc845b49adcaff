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

"""Kernel routing by device.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel, which launches or raises.  There is no
fallback from the kernel to the plain version, and no option that picks
one: the reference's ``sweep_impl`` ("jnp" | "pallas") becomes the device
the engine runs on.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from repro_torch.kernels import ref
from repro_torch.kernels.vm_update import advance_sweep_cuda


def resolve_advance(device) -> Callable:
    """The advance sweep for tensors on ``device``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return advance_sweep_cuda
    if kind == "cpu":
        return ref.advance_sweep_ref
    raise ValueError(f"no advance sweep for device type {kind!r}")


def advance_sweep(rem: Tensor, rate: Tensor, active: Tensor,
                  bound_dt: Tensor) -> tuple[Tensor, Tensor]:
    """Engine advance sweep, routed by the device ``rem`` lies on."""
    return resolve_advance(rem.device)(rem, rate, active, bound_dt)


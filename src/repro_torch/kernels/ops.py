"""Kernel routing by device.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel, which launches or raises.  There is no
fallback from the kernel to the plain version, and no option that picks
one: the reference's ``sweep_impl`` ("jnp" | "pallas") and ``attn_impl``
("xla" | "pallas") become the device the tensors lie on.
``flash_attention`` is differentiable on both devices through
``FlashAttention`` (the forward and backward kernels on the card, the plain
forward and ``ref.attention_bwd_ref`` on the CPU) when a gradient is
wanted; otherwise it calls the kernel or the plain version directly, so
serving launches the forward alone and saves nothing.  ``ssd_scan`` is
differentiable on both devices: on the card through ``SSDScan`` (kernel
forward, plain-version backward), on the CPU through the plain version;
with ``return_state`` (a prefill, which needs no gradient) it returns the
final state too, from the kernel itself on the card.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_cuda)
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_cuda
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


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None, softcap: float = 0.0,
                    scale: float | None = None) -> Tensor:
    """Attention routed by the device ``q`` lies on: the CUDA kernel for a
    CUDA tensor, ``ref.attention_ref`` for a CPU tensor; through
    ``FlashAttention`` when grad is enabled and q, k or v requires one."""
    kind = q.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device type {kind!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    fn = flash_attention_cuda if kind == "cuda" else ref.attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              scale=scale)


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
             D: Tensor, *, chunk: int = 128, return_state: bool = False):
    """The Mamba2 SSD scan routed by the device ``x`` lies on: the CUDA
    kernel (through ``SSDScan``) for a CUDA tensor, ``ref.ssd_scan_ref`` for
    a CPU tensor.  S need not be a multiple of ``chunk``.  With
    ``return_state``, ``(y, final state [B, H, P, N] f32)``: on the card the
    kernel's own state output, outside autograd (``ssd_scan_cuda`` refuses
    inputs that require a gradient)."""
    kind = x.device.type
    if kind == "cuda":
        if return_state:
            return ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk,
                                 return_state=True)
        return SSDScan.apply(x, dt, A, Bm, Cm, D, chunk)
    if kind == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                return_state=return_state)
    raise ValueError(f"no SSD scan for device type {kind!r}")

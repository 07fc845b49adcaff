"""The advance sweep as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/vm_update.py::advance_sweep_pallas``.  The kernel
source is ``csrc/vm_update.cu`` (its header says what bounds it and how the
design answers that); this module plans the launch, and ``kernels/build.py``
builds the source with ``nvcc`` at first use into ``build/repro_torch/`` at
the repository root and binds it through ``ctypes``.  Nothing is built or
loaded at import.

The wrapper takes CUDA tensors only.  On a CPU tensor the caller routes to
``ref.advance_sweep_ref`` (``ops.advance_sweep``); this function raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import build as kbuild

SRC = kbuild.CSRC / "vm_update.cu"
# -fmad=false: rem - rate*dt stays two roundings, as in PyTorch (see the .cu)
NVCC_FLAGS = (*kbuild.BASE_FLAGS, "-fmad=false")

# Launch plan limits, from the H100 (see csrc/vm_update.cu):
N_SM = 132
FUSED_THREADS = 512         # at most 128 registers a thread at this size
ITEMS_MAX = 16              # row elements a thread keeps in registers
FUSED_CAP = FUSED_THREADS * ITEMS_MAX
SPLIT_THREADS = 256
SPLIT_ITEMS = 4
SPLIT_TILE = SPLIT_THREADS * SPLIT_ITEMS
MAX_GRID_Y = 65535          # the split grid's y; a block takes every 65,535th row


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def kernel_plan(b: int, c: int) -> dict:
    """Launch geometry for a ``[b, c]`` sweep: the single source of truth
    for ``advance_sweep_cuda``.

    Fused (one block per row, the row in registers) while the row fits the
    cap; split into ``SPLIT_TILE`` tiles when it does not, or when fewer rows
    than SMs would leave the card mostly idle on a long row.  The split
    grid's y holds at most ``MAX_GRID_Y`` rows; past that a block takes rows
    y, y + MAX_GRID_Y, ...
    """
    if c > FUSED_CAP or (b < N_SM and c > 4 * SPLIT_TILE):
        nb = -(-c // SPLIT_TILE)
        return {"variant": "split", "threads": SPLIT_THREADS,
                "items": SPLIT_ITEMS, "nb": nb, "grid": (nb, min(b, MAX_GRID_Y))}
    threads = min(FUSED_THREADS, max(32, _next_pow2(-(-c // 4))))
    items = _next_pow2(-(-c // threads))
    return {"variant": "fused", "threads": threads, "items": items,
            "nb": 1, "grid": (b,)}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SRC, NVCC_FLAGS)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.advance_sweep_fused.argtypes = [p, p, p, p, p, p, i, ll, i, i, p]
    lib.advance_sweep_fused.restype = i
    lib.advance_sweep_split.argtypes = [p, p, p, p, p, p, p, i, ll, i, i, i, p]
    lib.advance_sweep_split.restype = i
    return lib


def _check(rem: Tensor, rate: Tensor, active: Tensor, bound_dt: Tensor):
    for name, x in (("rem", rem), ("rate", rate), ("active", active),
                    ("bound_dt", bound_dt)):
        if not x.is_cuda:
            raise ValueError(f"advance_sweep_cuda: {name} is on {x.device}, "
                             "not a CUDA device")
        if x.device != rem.device:
            raise ValueError(f"advance_sweep_cuda: {name} is on {x.device}, "
                             f"rem on {rem.device}")
        if not x.is_contiguous():
            raise ValueError(f"advance_sweep_cuda: {name} is not contiguous")
    for name, x in (("rem", rem), ("rate", rate), ("bound_dt", bound_dt)):
        if x.dtype != torch.float32:
            raise ValueError(f"advance_sweep_cuda: {name} is {x.dtype}, "
                             "expected torch.float32")
    if active.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"advance_sweep_cuda: active is {active.dtype}, "
                         "expected torch.bool or torch.uint8")
    if rem.dim() != 2 or rate.shape != rem.shape or active.shape != rem.shape:
        raise ValueError(
            "advance_sweep_cuda: rem, rate and active must share one [B, C] "
            f"shape, got {tuple(rem.shape)}, {tuple(rate.shape)}, "
            f"{tuple(active.shape)}")
    if bound_dt.shape != rem.shape[:1]:
        raise ValueError(f"advance_sweep_cuda: bound_dt has shape "
                         f"{tuple(bound_dt.shape)}, expected ({rem.shape[0]},)")


def advance_sweep_cuda(rem: Tensor, rate: Tensor, active: Tensor,
                       bound_dt: Tensor) -> tuple[Tensor, Tensor]:
    """The advance sweep on the card: ``[B, C]`` (or ``[C]`` with a scalar
    bound) -> ``(dt, rem')``, same contract as ``ref.advance_sweep_ref``.

    Launches on the current stream and does not synchronise.  Each call that
    launches adds one to ``advance_sweep_cuda.launches``.
    """
    squeeze = rem.dim() == 1
    if squeeze:
        rem, rate, active = rem[None], rate[None], active[None]
        bound_dt = bound_dt.reshape(1)
    _check(rem, rate, active, bound_dt)
    b, c = rem.shape
    dt = torch.empty(b, dtype=torch.float32, device=rem.device)
    out = torch.empty_like(rem)
    if b > 0:
        plan = kernel_plan(b, c)
        lib = _library()
        with torch.cuda.device(rem.device):
            stream = torch.cuda.current_stream().cuda_stream
            if plan["variant"] == "fused":
                err = lib.advance_sweep_fused(
                    rem.data_ptr(), rate.data_ptr(), active.data_ptr(),
                    bound_dt.data_ptr(), dt.data_ptr(), out.data_ptr(), b, c,
                    plan["threads"], plan["items"], stream)
            else:
                scratch = torch.empty((b, plan["nb"]), dtype=torch.float32,
                                      device=rem.device)
                err = lib.advance_sweep_split(
                    rem.data_ptr(), rate.data_ptr(), active.data_ptr(),
                    bound_dt.data_ptr(), scratch.data_ptr(), dt.data_ptr(),
                    out.data_ptr(), b, c, plan["threads"], plan["items"],
                    plan["nb"], stream)
        if err != 0:
            raise RuntimeError(
                f"advance_sweep_cuda: launch failed with CUDA error {err} "
                f"(plan {plan})")
        advance_sweep_cuda.launches += 1
    if squeeze:
        return dt[0], out[0]
    return dt, out


advance_sweep_cuda.launches = 0

"""Flash attention as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernel source is ``csrc/flash_attention.cu`` (its header says what bounds it
and how the design answers that); ``kernels/build.py`` builds it with
``nvcc`` at first use and binds it through ``ctypes``.  Nothing is built or
loaded at import.

The wrapper takes CUDA tensors only.  On a CPU tensor the caller routes to
``ref.attention_ref`` (``ops.flash_attention``); this function raises.  The
kernel has no backward yet: under autograd, with q, k or v requiring a
gradient, the wrapper raises rather than return a result cut off from the
graph (serving runs without gradients; training a dense model on the card
waits for a backward kernel).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import build as kbuild

SRC = kbuild.CSRC / "flash_attention.cu"
NVCC_FLAGS = kbuild.BASE_FLAGS
HEAD_DIMS = (64, 96, 128)       # the instantiations of the kernel template
MAX_GRID_YZ = 65535             # heads (grid y) and batch (grid z)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SRC, NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        i, f, f, p]
    lib.flash_attention_fwd.restype = i
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor, window) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {x.device}, "
                             "not a CUDA device")
        if x.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention_cuda: {name} is {x.dtype}, "
                             f"q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} has shape "
                             f"{tuple(x.shape)}, expected [B, H, S, D]")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} is not 16-byte "
                             "aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype}, expected "
                         "torch.float32 or torch.bfloat16")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit [B, Hq, Sq, D] / [B, Hk, Sk, D]")
    hk = k.shape[1]
    if hk == 0 or hq % hk:
        raise ValueError(f"flash_attention_cuda: {hq} query heads are not a "
                         f"multiple of {hk} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"flash_attention_cuda: {hq} heads or batch {b} "
                         f"exceed the grid's {MAX_GRID_YZ}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention_cuda: window {window} < 0")


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float = 0.0,
                         scale: float | None = None) -> Tensor:
    """Attention on the card: q ``[B, Hq, Sq, D]``, k/v ``[B, Hk, Sk, D]``
    -> ``[B, Hq, Sq, D]`` in q's dtype, same contract as
    ``ref.attention_ref``.

    Launches on the current stream and does not synchronise.  Each call that
    launches adds one to ``flash_attention_cuda.launches``.
    """
    kbuild.refuse_autograd("flash_attention_cuda", q=q, k=k, v=v)
    _check(q, k, v, window)
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hk, sq, sk, d, _DTYPES[q.dtype], int(causal),
            -1 if window is None else int(window), float(softcap),
            float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0

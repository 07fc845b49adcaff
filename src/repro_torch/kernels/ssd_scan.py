"""The Mamba2 SSD chunked scan as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas``.  The kernel source
is ``csrc/ssd_scan.cu`` (its header says what bounds it and how the design
answers that); ``kernels/build.py`` builds it with ``nvcc`` at first use and
binds it through ``ctypes``.  Nothing is built or loaded at import.

``ssd_scan_cuda`` takes CUDA tensors only and returns a result outside the
autograd graph; it refuses to run where autograd would need a gradient.
``SSDScan`` is the differentiable form: its forward launches the kernel, its
backward recomputes the plain version (``ref.ssd_scan_ref``) from the saved
inputs under autograd and differentiates that.  The JAX package has no
backward kernel either: it trains through ``ref.ssd_chunked_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SRC = kbuild.CSRC / "ssd_scan.cu"
NVCC_FLAGS = kbuild.BASE_FLAGS
HEAD_DIMS = (16, 32, 64, 128)   # P and N the kernel takes
MAX_CHUNK = 128                 # chunk: a multiple of 32 up to this
MAX_GRID_Y = 65535              # batch (grid y)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SRC, NVCC_FLAGS)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssd_scan_fwd.argtypes = [p] * 7 + [i] * 8 + [q] * 12 + [p]
    lib.ssd_scan_fwd.restype = i
    return lib


def _check(x, dt, A, Bm, Cm, D, chunk) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}, not a "
                             "CUDA device")
        if t.device != x.device:
            raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan_cuda: x is {x.dtype}, expected "
                         "torch.float32 or torch.bfloat16")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan_cuda: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_cuda: {name} is {t.dtype}, expected "
                             "torch.float32")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan_cuda: x has shape {tuple(x.shape)}, "
                         "expected [B, S, H, P]")
    b, s, h, p = x.shape
    if dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,):
        raise ValueError(
            f"ssd_scan_cuda: dt {tuple(dt.shape)}, A {tuple(A.shape)}, D "
            f"{tuple(D.shape)} do not fit x {tuple(x.shape)}")
    if Bm.dim() != 4 or Bm.shape != Cm.shape or Bm.shape[:2] != (b, s):
        raise ValueError(
            f"ssd_scan_cuda: Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do "
            f"not fit [B, S, G, N] with x {tuple(x.shape)}")
    g, n = Bm.shape[2], Bm.shape[3]
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan_cuda: {h} heads are not a multiple of "
                         f"{g} groups")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan_cuda: head dim P={p} is not one of "
                         f"{HEAD_DIMS}")
    if n not in HEAD_DIMS:
        raise ValueError(f"ssd_scan_cuda: state dim N={n} is not one of "
                         f"{HEAD_DIMS}")
    if chunk % 32 or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan_cuda: chunk {chunk} is not a multiple "
                         f"of 32 up to {MAX_CHUNK}")
    if b > MAX_GRID_Y:
        raise ValueError(f"ssd_scan_cuda: batch {b} exceeds the grid's "
                         f"{MAX_GRID_Y}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan_cuda: the last axis of {name} is not "
                             "contiguous")


def ssd_scan_cuda(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                  D: Tensor, *, chunk: int = 128) -> Tensor:
    """The SSD scan on the card: x ``[B, S, H, P]``, dt ``[B, S, H]``, A and
    D ``[H]``, Bm/Cm ``[B, S, G, N]`` -> y ``[B, S, H, P]`` in x's dtype, the
    contract of ``ref.ssd_scan_ref`` (S need not be a multiple of
    ``chunk``).  x, Bm, Cm are read through their strides.

    Launches on the current stream and does not synchronise.  Each call that
    launches adds one to ``ssd_scan_cuda.launches``.
    """
    kbuild.refuse_autograd("ssd_scan_cuda", x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D)
    _check(x, dt, A, Bm, Cm, D, chunk)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    A, D = A.contiguous(), D.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), b, s, h, g, p, n,
            chunk, _DTYPES[x.dtype], *x.stride()[:3], *dt.stride(),
            *Bm.stride()[:3], *Cm.stride()[:3],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_cuda: launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, Bm {tuple(Bm.shape)}, "
                           f"{x.dtype}, chunk {chunk})")
    ssd_scan_cuda.launches += 1
    return y


ssd_scan_cuda.launches = 0


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient: the kernel forward, the plain version's
    gradient backward (recomputed from the saved inputs)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        return ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)

    @staticmethod
    def backward(ctx, gy):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            y = ref.ssd_scan_ref(*leaves, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                y, [t for t in leaves if t.requires_grad], gy))
        return (*(next(grads) if need else None for need in needs), None)

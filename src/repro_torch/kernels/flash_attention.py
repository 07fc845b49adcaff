"""Flash attention as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernel source is ``csrc/flash_attention.cu`` (its header says what bounds it
and how the design answers that); ``kernels/build.py`` builds it with
``nvcc`` at first use and binds it through ``ctypes``.  Nothing is built or
loaded at import.

Two variants, chosen by dtype in ``kernel_plan``: bf16 runs on the tensor
cores (``"wgmma"``: TMA loads into a two-stage shared-memory ring, ``wgmma``
for both products, the online softmax in registers); f32 runs on the CUDA
cores (``"cuda_cores"``: f32 FMAs, which its 2e-5 tolerance needs).  There
is no option that picks another: a bf16 CUDA tensor launches the
tensor-core kernel or raises.

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
HEAD_DIMS = (64, 96, 128)       # the instantiations of the kernel templates
N_SM = 132                      # H100 SXM streaming multiprocessors
MAX_SMEM = 232_448              # dynamic shared memory a block may have
MAX_GRID_YZ = 65535             # heads (grid y) and batch (grid z)
WGMMA_BLOCK_K = 128             # keys per tile of the tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry point's codes besides cudaError_t
_NO_ENCODER, _ENCODE_FAILED = 999, 1000


def geometry(dtype: torch.dtype, d: int, block_q: int) -> tuple[int, int, int]:
    """Key tile, threads and shared-memory bytes of the kernel instantiated
    for (dtype, d, block_q), as ``csrc/flash_attention.cu`` lays it out
    (``wgmma_smem_bytes``, ``f32_smem_bytes``).  The C entry point takes
    only (dtype, d, block_q) and launches with its own numbers; these are
    what the plan reports without the library, and ``chip_smoke.py`` holds
    them against ``kernel_geometry``."""
    if dtype == torch.bfloat16:
        cols = 64 if d <= 64 else 128
        # 1 KB to align the swizzled tiles, Q, two K and two V stages of
        # bf16, the mbarriers
        smem = 1024 + (block_q + 4 * WGMMA_BLOCK_K) * cols * 2 + 64
        return WGMMA_BLOCK_K, 2 * block_q, smem
    # Q and one K/V tile with rows padded by 4 floats, and P
    return 64, 256, (2 * 64 * (d + 4) + 64 * (64 + 4)) * 4


def kernel_plan(b: int, hq: int, hk: int, sq: int, sk: int, d: int,
                dtype: torch.dtype, n_sm: int = N_SM) -> dict:
    """Launch plan of ``flash_attention_cuda`` for q ``[b, hq, sq, d]`` and
    k/v ``[b, hk, sk, d]`` on a card of ``n_sm`` SMs (the wrapper passes
    the card's own count; 132 is the H100 SXM's).

    bf16 plans ``"wgmma"``: one warpgroup (128 threads) per 64 query rows,
    key tiles of 128, a shared-memory row of 64 or 128 columns (D = 96 pads
    to 128).  A block takes 128 rows (two warpgroups) unless that leaves
    fewer blocks than SMs (``b * hq * ceil(sq / 128) < n_sm``); then 64.
    f32 plans ``"cuda_cores"``: 64 x 64 tiles, 256 threads.  Raises
    ValueError on what no instantiation takes.
    """
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16:
        block_q = 64 if b * hq * -(-sq // 128) < n_sm else 128
        variant = "wgmma"
    elif dtype == torch.float32:
        block_q, variant = 64, "cuda_cores"
    else:
        raise ValueError(f"flash_attention_cuda: dtype {dtype}, expected "
                         "torch.float32 or torch.bfloat16")
    block_k, threads, smem = geometry(dtype, d, block_q)
    grid = (-(-sq // block_q), hq, b)
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"flash_attention_cuda: {hq} heads or batch {b} "
                         f"exceed the grid's {MAX_GRID_YZ}")
    if smem > MAX_SMEM:
        raise ValueError(f"flash_attention_cuda: {smem} bytes of shared "
                         f"memory exceed a block's {MAX_SMEM}")
    return {"variant": variant, "block_q": block_q, "block_k": block_k,
            "threads": threads, "smem": smem, "grid": grid}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SRC, NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        i, f, f, i, p]
    lib.flash_attention_fwd.restype = i
    ip = ctypes.POINTER(i)
    lib.flash_attention_geometry.argtypes = [i, i, i, ip, ip, ip]
    lib.flash_attention_geometry.restype = i
    return lib


def kernel_geometry(dtype: torch.dtype, d: int,
                    block_q: int) -> tuple[int, int, int] | None:
    """Key tile, threads and shared-memory bytes of the built library's
    instantiation for (dtype, d, block_q), or None if it has none (builds
    the library)."""
    out = [ctypes.c_int() for _ in range(3)]
    if _library().flash_attention_geometry(_DTYPES[dtype], d, block_q, *out):
        return None
    return tuple(x.value for x in out)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q: Tensor, k: Tensor, v: Tensor, window) -> dict:
    """Shapes and dtypes, then the plan, then devices and layout: what the
    plan refuses is refused before any device is looked at."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention_cuda: {name} is {x.dtype}, "
                             f"q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} has shape "
                             f"{tuple(x.shape)}, expected [B, H, S, D]")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit [B, Hq, Sq, D] / [B, Hk, Sk, D]")
    hk, sk = k.shape[1], k.shape[2]
    if hk == 0 or hq % hk:
        raise ValueError(f"flash_attention_cuda: {hq} query heads are not a "
                         f"multiple of {hk} kv heads")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention_cuda: window {window} < 0")
    n_sm = _sm_count(q.device) if q.is_cuda else N_SM
    plan = kernel_plan(b, hq, hk, sq, sk, d, q.dtype, n_sm)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {x.device}, "
                             "not a CUDA device")
        if x.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on {x.device}, "
                             f"q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} is not 16-byte "
                             "aligned")
    return plan


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float = 0.0,
                         scale: float | None = None) -> Tensor:
    """Attention on the card: q ``[B, Hq, Sq, D]``, k/v ``[B, Hk, Sk, D]``
    -> ``[B, Hq, Sq, D]`` in q's dtype, same contract as
    ``ref.attention_ref``.

    Launches on the current stream and does not synchronise.  Each call that
    launches adds one to ``flash_attention_cuda.launches`` and leaves its
    plan in ``flash_attention_cuda.last_plan``.
    """
    kbuild.refuse_autograd("flash_attention_cuda", q=q, k=k, v=v)
    plan = _check(q, k, v, window)
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
            float(scale), plan["block_q"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        if err == _NO_ENCODER:
            what = "the driver has no cuTensorMapEncodeTiled"
        elif err >= _ENCODE_FAILED:
            what = (f"cuTensorMapEncodeTiled failed with CUresult "
                    f"{err - _ENCODE_FAILED}")
        else:
            what = f"CUDA error {err}"
        raise RuntimeError(f"flash_attention_cuda: launch failed: {what} (q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}, "
                           f"plan {plan})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.last_plan = plan
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.last_plan = None

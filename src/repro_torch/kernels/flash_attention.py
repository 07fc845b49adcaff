"""Flash attention as hand-written CUDA kernels for Hopper, forward and
backward.

The forward replaces ``repro/kernels/flash_attention.py::
flash_attention_pallas``; its source is ``csrc/flash_attention.cu``.  The
backward has no Pallas counterpart (the JAX package differentiates
``repro/models/attention.py::flash_xla`` with ``jax.grad``); its source is
``csrc/flash_attention_bwd.cu``.  Each header says what bounds the kernel
and how the design answers that; ``kernels/build.py`` builds both with
``nvcc`` at first use and binds them through ``ctypes``.  Nothing is built
or loaded at import.

Two variants, chosen by dtype in ``kernel_plan``: bf16 runs on the tensor
cores (``"wgmma"``: TMA loads into a two-stage shared-memory ring, ``wgmma``
for both products, the online softmax in registers); f32 runs on the CUDA
cores (``"cuda_cores"``: f32 FMAs, which its 2e-5 tolerance needs; 64 x 64
tiles, K and V brought by ``cp.async`` two stages deep, register-blocked
products from ``csrc/cuda_cores.cuh``, and, when the query tiles would
leave SMs idle, each tile's keys split over ``key_split`` blocks whose
partial rows a second launch puts together in a fixed order).  There
is no option that picks another: a bf16 CUDA tensor launches the
tensor-core kernel or raises.  Both variants, forward and backward, take
every head width ``D >= 1``, every batch and every head count, as the
Pallas kernel does:

* a multiple of 8 up to 128 (``HEAD_DIMS``, the Pallas kernel's tests' 16
  and 32 among them): 64, 96 and 128 have instantiations of their own, any
  other width the one of ``kernel_width(d)``;
* past 128: the whole-width kernels (``native``): bf16 up to 256 on the
  tensor cores (``"wgmma_256"``), f32 at every width on the CUDA cores
  (``"cuda_cores_256"``: a block's accumulators hold ``F32_COLS`` columns,
  so past 256 the outputs go in ``slices`` slices of them), each forming S
  (and dP) once a tile; bf16 past 256 the wide kernels
  (``csrc/flash_wide.cuh``), in which a block owns one slice of ``SLICE``
  output columns and forms S (and dP) over the whole width, a piece at a
  time: S is formed ``slices`` times (the plans' recompute factor);
* off the multiple of 8: the op pads the head axis of its inputs with zeros
  to ``padded_width(d)`` (TMA and ``cp.async`` need 16-byte row strides) and
  slices its outputs back, which is exact (zero columns add zeros to q.k
  and give zero columns of o, dq, dk and dv); the scale stays the real
  width's;
* the (batch, head) pairs go on the grid's y and z as (H, B) while both fit
  65,535, else folded (``head_grid``); past ``MAX_PAIRS`` the op launches
  once for each of ``pair_chunks``'s ranges of pairs (the kernels' pair
  index and TMA's coordinates are 32-bit).

The backward (``flash_attention_bwd_cuda``, plan ``kernel_plan_bwd``) is
three launches: delta = rowsum(dO o), dK/dV over key blocks (a block loops
over the query heads of its GQA group, so nothing is added atomically and
two runs are bitwise equal), dQ over query blocks.  bf16 runs its products
on the tensor cores (``"wgmma"``: TMA into a two-stage shared-memory ring,
``wgmma`` for every product, P and dS from registers), f32 on the CUDA
cores (``"cuda_cores"``: 64-row blocks, the other side's tiles two stages
deep, dK and dV in registers over a key block; dQ blocks that would leave
SMs idle split their keys, and a fourth launch adds the splits up in a
fixed order; past 128 columns ``"cuda_cores_256"``, dV and dK in two
launches of their own so that each fits a block's registers at the whole
width).

Each kernel is a ``torch.library`` op
(``repro_torch::flash_attention_fwd``, ``repro_torch::flash_attention_bwd``)
whose body plans, checks devices and layout, and launches it; its fake
implementation plans (refusing what the card would) and gives the outputs'
shapes alone, so a meta tensor traces the card's program without data
(``launch/dryrun.py``).  A FLOP formula registered for each
(``flash_work``, ``flash_bwd_work``: the count chip_smoke.py's bounds use)
lets a counting mode read the kernel's work.

The wrappers check shapes, then call the op; they take CUDA (or meta)
tensors only and raise under autograd (their outputs would have no
``grad_fn``).  ``FlashAttention`` is the differentiable form: the forward
kernel with its row log-sum-exp, then the backward kernels, on any tensor
but a CPU one; ``ref.attention_ref`` and ``ref.attention_bwd_ref`` on CPU
tensors.  ``ops.flash_attention`` routes to it when a gradient is wanted.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref
from repro_torch.kernels.build import MAX_GRID_YZ, head_grid  # noqa: F401

SRC = kbuild.CSRC / "flash_attention.cu"
SRC_BWD = kbuild.CSRC / "flash_attention_bwd.cu"
NVCC_FLAGS = kbuild.BASE_FLAGS
# the head widths the narrow instantiations take: every multiple of 8 up to
# 128, the Pallas kernel's 16 and 32 among them (every other width pads to a
# multiple of 8; past 128 the whole-width and wide kernels run)
HEAD_DIMS = tuple(range(8, 129, 8))
NATIVE_DIMS = (64, 96, 128)     # widths with instantiations of their own
N_SM = 132                      # H100 SXM streaming multiprocessors
MAX_SMEM = 232_448              # dynamic shared memory a block may have
MAX_PAIRS = 2**31 - 1           # (batch, head) pairs of one launch
WGMMA_BLOCK_K = 128             # keys per tile of the tensor-core kernel
CC_ROWS = 64                    # rows (queries, keys) of an f32 tile
CC_THREADS = 256
# bf16 past 256 columns (csrc/flash_wide.cuh): a block's output columns and
# the columns of a piece of S; ring stages of two 64 x 128 tiles
SLICE, WIDE_STAGES = 128, 3
# f32 past 128 columns (csrc/flash_wide.cuh): columns of a piece, of a
# block's accumulators (its widest slice), the ring's stages
PIECE, F32_COLS, F32_STAGES = 64, 256, 4
# bf16 widths past 128 up to this run the native kernels (whole width, no
# slices), two warpgroups a block: forward 128 query rows, backward dK/dV
# 64 keys, dQ 128 queries
NATIVE_WIDTH = 256
NATIVE_THREADS = 256
# f32 key splits: a block's keys split when the grid leaves SMs idle, each
# split at least SPLIT_MIN_TILES key tiles, at most MAX_SPLIT splits
# (csrc/cuda_cores.cuh kMaxSplit)
SPLIT_MIN_TILES, MAX_SPLIT = 2, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plan variants of the whole-width kernels (``native``)
NATIVE = ("wgmma_256", "cuda_cores_256")
# the C entry point's codes besides cudaError_t
_NO_ENCODER, _ENCODE_FAILED = 999, 1000


@functools.cache
def attention_pairs(sq: int, sk: int, causal: bool,
                    window: int | None) -> int:
    """The (query, key) pairs ``ref.attention_mask(sq, sk, causal,
    window)`` lets through, counted from the shapes: row i sees keys up to
    ``i + sk - sq`` (causal) and above ``i + sk - sq - window``."""
    total = 0
    for i in range(sq):
        row = i + sk - sq
        hi = min(sk - 1, row) if causal else sk - 1
        lo = max(0, row - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def flash_work(q_shape, k_shape, dtype_bytes: int, causal: bool = True,
               window: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one forward: 4 * D operations per valid
    (query, key) pair and head (q.k and p.v), q, k, v read once and o
    written once."""
    b, hq, sq, d = q_shape
    hk, sk = k_shape[1], k_shape[2]
    ops = 4 * d * attention_pairs(sq, sk, causal, window) * b * hq
    return ops, (2 * b * hq * sq + 2 * b * hk * sk) * d * dtype_bytes


def flash_bwd_work(q_shape, k_shape, dtype_bytes: int, causal: bool = True,
                   window: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one backward: five products of 2 * D
    operations per valid pair (S, dP, dV, dQ, dK); q, k, v, o, dO and lse
    read once, dq, dk, dv written once."""
    b, hq, sq, d = q_shape
    hk, sk = k_shape[1], k_shape[2]
    ops = 10 * d * attention_pairs(sq, sk, causal, window) * b * hq
    return ops, ((4 * b * hq * sq + 4 * b * hk * sk) * d * dtype_bytes
                 + 4 * b * hq * sq)


def padded_width(d: int) -> int:
    """The head width the kernels run for a head width ``d``: ``d`` rounded
    up to a multiple of 8 (the op pads with zero columns)."""
    return -(-d // 8) * 8


def native(d: int, dtype: torch.dtype) -> bool:
    """Whether head width ``d`` in ``dtype`` runs the whole-width kernels:
    bf16 at padded widths 136-256, f32 at every padded width past 128."""
    w = padded_width(d)
    return w > 128 and (dtype == torch.float32 or w <= NATIVE_WIDTH)


def slices(d: int, dtype: torch.dtype) -> int:
    """The column slices of a head width ``d`` in ``dtype``, each a block of
    its own that forms S (and dP) over the whole width (the recompute
    factor): 1 up to 128 columns (after padding) and for the native bf16
    kernels; f32 past 128 ``ceil(padded / F32_COLS)`` (1 up to 256); bf16
    past 256 ``ceil(padded / SLICE)``."""
    w = padded_width(d)
    if w <= 128 or (native(d, dtype) and dtype == torch.bfloat16):
        return 1
    return -(-w // (F32_COLS if dtype == torch.float32 else SLICE))


def _f32_smem(w: int) -> tuple[int, int]:
    """Shared-memory bytes of the f32 whole-width kernels at padded width
    ``w`` (``csrc/flash_wide.cuh``): the forward's, and the backward's (dK/dV
    and dQ alike).  Each has its ring of ``F32_STAGES`` stages of 64-row
    pieces (``PIECE`` columns at a row stride of ``PIECE + 4`` floats),
    beside a piece of the block's own rows where those are not held at the
    whole width (past ``F32_COLS``), the block's own rows where they are
    (pieces side by side, 4 floats of pad: Q in the forward; K and V, or Q
    and dO), and a 64 x 68 score tile (P; P^T or dS^T; dS)."""
    resident = w <= F32_COLS
    ld, tile = PIECE * -(-w // PIECE) + 4, CC_ROWS * (PIECE + 4)
    stages = F32_STAGES * tile * (1 if resident else 2)
    scores = CC_ROWS * (CC_ROWS + 4)
    own = CC_ROWS * ld if resident else 0
    return (stages + own + scores) * 4, (stages + 2 * own + scores) * 4


def head_split(b: int, hk: int, sk: int, group: int, n_sm: int = N_SM) -> int:
    """Shares of a GQA group's query heads in the native dK/dV kernel (each
    share a block of its own over the same 64 keys, its f32 part added to
    the others' in share order): 1 where the ``b * hk * ceil(sk / 64)``
    key blocks fill two waves of ``n_sm`` SMs, else as many as bring the
    grid to two waves, at most one a head of the group.  Under a causal
    mask key block 0 sees every query tile of its group: shares cut that
    longest block."""
    blocks = b * hk * -(-sk // 64)
    if blocks >= 2 * n_sm:
        return 1
    return max(1, min(group, -(-2 * n_sm // blocks)))


def pair_chunks(b: int, hq: int, hk: int, limit: int | None = None
                ) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """The launches that cover ``b`` x ``hq`` (batch, head) pairs, at most
    ``limit`` pairs each (``MAX_PAIRS`` unless given): none while one
    launch takes them all, else the row and head ranges ``((r0, r1), (h0,
    h1))`` of each over the ``[b * hk, hq // hk]`` view of the query heads
    (k and v ``[b * hk, 1]``): a launch is a problem of its own of ``r1 -
    r0`` batch rows of ``h1 - h0`` query heads over one kv head.  A group
    of more than ``limit`` heads is cut into runs of heads, whose dK and dV
    parts the backward adds up."""
    limit = MAX_PAIRS if limit is None else limit
    if b * hq <= limit:
        return []
    rows, group = b * hk, hq // hk
    if group <= limit:
        per = limit // group
        return [((r, min(r + per, rows)), (0, group))
                for r in range(0, rows, per)]
    return [((r, r + 1), (h, min(h + limit, group)))
            for r in range(rows) for h in range(0, group, limit)]


def _by_pairs(chunks: list, group: int, qside: list, kside: list):
    """The q-side (q, o, lse, ...) and kv-side (k, v, ...) views of each
    launch of ``chunks`` (``pair_chunks``), or the tensors themselves once
    where there are none, each with whether its run of query heads is its
    kv heads' first."""
    if not chunks:
        yield qside, kside, True
        return
    for (r0, r1), (h0, h1) in chunks:
        yield ([x.view(-1, group, *x.shape[2:])[r0:r1, h0:h1] for x in qside],
               [x.view(-1, 1, *x.shape[2:])[r0:r1] for x in kside], h0 == 0)


def kernel_width(d: int) -> int:
    """The width of the instantiation that runs head width ``d``
    (``padded_width(d)`` first): 64, 96 and 128 themselves; 64 below 64 and
    128 up to 128, whose ``kAny`` instantiations read the width at run time
    and leave the columns past it zero (``csrc/flash_attention.cu``'s and
    ``csrc/flash_attention_bwd.cu``'s ``find``); past 128 the whole-width
    and wide kernels take every padded width themselves."""
    d = padded_width(d)
    if d in NATIVE_DIMS:
        return d
    return 64 if d <= 64 else 128


def geometry(dtype: torch.dtype, d: int, block_q: int) -> tuple[int, int, int]:
    """Key tile, threads and shared-memory bytes of the kernel that runs
    (dtype, d, block_q), as ``csrc/flash_attention.cu`` lays it out
    (``wgmma_smem_bytes``, ``f32_smem_bytes`` of ``kernel_width(d)``; past
    128 columns ``f32_256_smem_bytes`` (``_f32_smem``) and, bf16 past 256,
    ``wide_smem_bytes``).  The C entry
    point takes only (dtype, d, block_q) and launches with its own numbers;
    these are what the plan reports without the library, and
    ``chip_smoke.py`` holds them against ``kernel_geometry``.  The native
    kernel (bf16 136-256, a warpgroup a 64 of block_q's rows): 1 KB of
    alignment, Q of block_q rows, two stages of K and of V of 64 keys, all
    ``NATIVE_WIDTH`` columns of bf16, 128 bytes of mbarriers
    (``native_smem_bytes``)."""
    if native(d, dtype) and dtype == torch.float32:
        return CC_ROWS, CC_THREADS, _f32_smem(padded_width(d))[0]
    if native(d, dtype):
        return 64, 2 * block_q, \
            1024 + (block_q + 4 * 64) * NATIVE_WIDTH * 2 + 128
    if slices(d, dtype) > 1:
        # 1 KB of alignment, the ring, its mbarriers
        return 64, 128, 1024 + WIDE_STAGES * 2 * 64 * 128 * 2 + 64
    d = kernel_width(d)
    if dtype == torch.bfloat16:
        cols = 64 if d <= 64 else 128
        # 1 KB to align the swizzled tiles, Q, two K and two V stages of
        # bf16, the mbarriers
        smem = 1024 + (block_q + 4 * WGMMA_BLOCK_K) * cols * 2 + 64
        return WGMMA_BLOCK_K, 2 * block_q, smem
    # Q, two K and two V stages of 64 rows padded by 4 floats, and P at 72
    # floats a row
    smem = (5 * CC_ROWS * (d + 4) + CC_ROWS * (CC_ROWS + 8)) * 4
    return CC_ROWS, CC_THREADS, smem


def key_split(blocks: int, sk: int, n_sm: int = N_SM) -> int:
    """How many blocks share the keys of one f32 block's rows (the forward's
    query tile, the backward's dQ block) when the grid has ``blocks`` such
    blocks on a card of ``n_sm`` SMs: 1 when the grid fills the card, else
    as many as keep it within one wave (``blocks * split <= n_sm``), each
    split at least ``SPLIT_MIN_TILES`` 64-key tiles of the ``sk`` keys, at
    most ``MAX_SPLIT``.  A second launch adds the splits up in a fixed
    order."""
    if blocks >= n_sm:
        return 1
    return max(1, min(n_sm // blocks, -(-sk // CC_ROWS) // SPLIT_MIN_TILES,
                      MAX_SPLIT))


def wave_split(blocks: int, tiles: int, n_sm: int = N_SM) -> int:
    """How many blocks share the walk of one block of the f32 whole-width
    kernels (a query tile's key tiles in the forward and dQ, a key block's
    query tiles in dK/dV) when the grid has ``blocks`` such blocks on a card
    of ``n_sm`` SMs and a block walks at most ``tiles`` tiles: 1 when the
    grid fills the card, else as many as bring it to two waves, at most one
    a tile and ``MAX_SPLIT``.  Each walk of these kernels is a long chain of
    items, so a short grid's time is its longest walk: under a causal mask
    the splits of the short walks end at once, and the heaviest-first order
    puts the long ones in the first wave.  A later launch adds the splits
    up in a fixed order."""
    if blocks >= n_sm:
        return 1
    return max(1, min(MAX_SPLIT, tiles, 2 * n_sm // blocks))


def kernel_plan(b: int, hq: int, hk: int, sq: int, sk: int, d: int,
                dtype: torch.dtype, n_sm: int = N_SM) -> dict:
    """Launch plan of ``flash_attention_cuda`` for q ``[b, hq, sq, d]`` and
    k/v ``[b, hk, sk, d]`` on a card of ``n_sm`` SMs (the wrapper passes
    the card's own count; 132 is the H100 SXM's).

    bf16 plans ``"wgmma"``: one warpgroup (128 threads) per 64 query rows,
    key tiles of 128, a shared-memory row of 64 or 128 columns (D below 64
    pads to 64, D above it to 128).  A block takes 128 rows (two
    warpgroups) unless that leaves fewer blocks than SMs
    (``b * hq * ceil(sq / 128) < n_sm``); then 64.  f32 plans
    ``"cuda_cores"``: 64 x 64 tiles, 256 threads, K and V two stages deep;
    when the query tiles leave SMs idle, ``split`` blocks share a tile's
    keys (``key_split``) and write their partial rows into ``scratch``
    bytes of f32 (``split * b * hq * sq * (width + 2)`` floats: O, m and l
    of each split), which a second launch puts together in a fixed order.
    bf16 never splits.

    bf16 at padded widths 136-256 plans ``"wgmma_256"``, the native kernel
    (``native``): a warpgroup a 64 query rows, 128-row blocks or 64 by the
    rule above, key tiles of 64, the whole width in one block (no slices).
    f32 past 128 columns plans ``"cuda_cores_256"``: 64 query rows and 64
    keys a tile, 256 threads, S once a tile over the whole width, O of up
    to ``F32_COLS`` columns in registers, the keys split by ``wave_split``.

    ``width`` is the head width the kernels run (``padded_width(d)``: the
    op pads q, k and v to it), ``slices`` the column slices (1 up to 128
    columns and for the native bf16 kernel): f32 past 256 slices of up to
    ``F32_COLS`` columns, bf16 past 256 the wide kernel's 64-row blocks
    (key tiles of 64) each owning ``SLICE`` output columns; the grid's x
    counts query tiles x slices x key splits, and S is formed ``slices``
    times.  The grid's y and z are
    ``head_grid(hq, b)``.  Past ``MAX_PAIRS`` pairs the plan is that of the
    first of ``pair_chunks``'s launches, and ``pair_chunks`` their count (1
    below).  Raises ValueError on what no kernel takes (a head width below
    1, another dtype).
    """
    _check_width("flash_attention_cuda", d)
    chunks = pair_chunks(b, hq, hk)
    if chunks:
        (r0, r1), (h0, h1) = chunks[0]
        return {**kernel_plan(r1 - r0, h1 - h0, 1, sq, sk, d, dtype, n_sm),
                "pair_chunks": len(chunks)}
    width, n_slices = padded_width(d), slices(d, dtype)
    if native(d, dtype) and dtype == torch.bfloat16:
        block_q = 64 if b * hq * -(-sq // 128) < n_sm else 128
        variant = "wgmma_256"
    elif dtype == torch.bfloat16:
        block_q = (64 if n_slices > 1 or b * hq * -(-sq // 128) < n_sm
                   else 128)
        variant = "wgmma"
    elif dtype == torch.float32:
        block_q = CC_ROWS
        variant = "cuda_cores_256" if native(d, dtype) else "cuda_cores"
    else:
        raise ValueError(f"flash_attention_cuda: dtype {dtype}, expected "
                         "torch.float32 or torch.bfloat16")
    block_k, threads, smem = geometry(dtype, width, block_q)
    tiles = -(-sq // block_q) * n_slices
    if variant == "cuda_cores_256":
        split = wave_split(b * hq * tiles, -(-sk // CC_ROWS), n_sm)
    else:
        split = (key_split(b * hq * tiles, sk, n_sm)
                 if dtype == torch.float32 else 1)
    grid = (tiles * split, *head_grid(hq, b))
    if smem > MAX_SMEM:
        raise ValueError(f"flash_attention_cuda: {smem} bytes of shared "
                         f"memory exceed a block's {MAX_SMEM}")
    scratch = split * b * hq * sq * (width + 2) * 4 if split > 1 else 0
    return {"variant": variant, "block_q": block_q, "block_k": block_k,
            "threads": threads, "smem": smem, "grid": grid, "split": split,
            "scratch": scratch, "width": width, "slices": n_slices,
            "pair_chunks": 1}


def _check_width(fn: str, d: int) -> None:
    if d < 1:
        raise ValueError(f"{fn}: head dim {d} is below 1")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SRC, NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, i, f, f, i, i, p]
    lib.flash_attention_fwd.restype = i
    ip = ctypes.POINTER(i)
    lib.flash_attention_geometry.argtypes = [i, i, i, ip, ip, ip]
    lib.flash_attention_geometry.restype = i
    return lib


def kernel_geometry(dtype: torch.dtype, d: int,
                    block_q: int) -> tuple[int, int, int] | None:
    """Key tile, threads and shared-memory bytes of the built library's
    instantiation for (dtype, d, block_q) (d padded as the op pads it), or
    None if it has none (builds the library)."""
    out = [ctypes.c_int() for _ in range(3)]
    if _library().flash_attention_geometry(_DTYPES[dtype], padded_width(d),
                                           block_q, *out):
        return None
    return tuple(x.value for x in out)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q: Tensor, k: Tensor, v: Tensor, window) -> None:
    """Shapes and dtypes: the wrappers' own checks, on any tensor.  The plan
    (``kernel_plan``) and the devices and layout are the ops' (their fake
    implementations plan too, so a trace refuses what the card would)."""
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
    _check_width("flash_attention_cuda", d)
    hk = k.shape[1]
    if hk == 0 or hq % hk:
        raise ValueError(f"flash_attention_cuda: {hq} query heads are not a "
                         f"multiple of {hk} kv heads")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention_cuda: window {window} < 0")


def _check_placed(fn: str, lead: Tensor, *named: tuple[str, Tensor]) -> None:
    """Devices and layout, in an op's body after its plan (so what the plan
    refuses is refused before any device is looked at): every tensor on
    ``lead``'s CUDA device, contiguous and 16-byte aligned."""
    for name, x in named:
        if not x.is_cuda:
            raise ValueError(f"{fn}: {name} is on {x.device}, not a CUDA "
                             "device")
        if x.device != lead.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, "
                             f"{named[0][0]} on {lead.device}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def _launch_error(err: int) -> str:
    """What a non-zero return of the C entry points means."""
    if err == _NO_ENCODER:
        return "the driver has no cuTensorMapEncodeTiled"
    if err >= _ENCODE_FAILED:
        return (f"cuTensorMapEncodeTiled failed with CUresult "
                f"{err - _ENCODE_FAILED}")
    return f"CUDA error {err}"


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float = 0.0, scale: float | None = None,
                         return_lse: bool = False):
    """Attention on the card: q ``[B, Hq, Sq, D]``, k/v ``[B, Hk, Sk, D]``
    -> ``[B, Hq, Sq, D]`` in q's dtype, same contract as
    ``ref.attention_ref``.  With ``return_lse``, ``(out, lse)``: the rows'
    log-sum-exp f32 ``[B, Hq, Sq]`` as ``ref.attention_lse_ref`` gives it,
    written by the kernel itself (the backward's input).

    Launches on the current stream and does not synchronise.  Each call that
    launches adds one to ``flash_attention_cuda.launches`` (and to
    ``.native_launches`` where a whole-width kernel runs, bf16 136-256 or
    f32 past 128, ``.wide_launches`` where the bf16 wide kernel runs,
    ``.padded_launches`` where the head axis was padded) and leaves its
    plan in ``flash_attention_cuda.last_plan``.
    """
    kbuild.refuse_autograd("flash_attention_cuda", q=q, k=k, v=v)
    _check(q, k, v, window)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out, lse = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, bool(causal), None if window is None else int(window),
        float(softcap), float(scale), bool(return_lse))
    return (out, lse) if return_lse else out


def _plan_fwd(q: Tensor, k: Tensor) -> dict:
    b, hq, sq, d = q.shape
    n_sm = _sm_count(q.device) if q.is_cuda else N_SM
    return kernel_plan(b, hq, k.shape[1], sq, k.shape[2], d, q.dtype, n_sm)


def _flash_fwd_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  window: int | None, softcap: float, scale: float,
                  return_lse: bool) -> tuple[Tensor, Tensor]:
    """The forward kernel's plan, checks and launch (``flash_attention_cuda``
    checks the shapes first); lse is ``[0]`` unless asked for."""
    plan = _plan_fwd(q, k)
    _check_placed("flash_attention_cuda", q, ("q", q), ("k", k), ("v", v))
    b, hq, sq, d = q.shape
    hk = k.shape[1]
    lse = torch.empty((b, hq, sq) if return_lse else (0,),
                      dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return torch.empty_like(q), lse
    width = plan["width"]
    q, k, v = _pad(width, q, k, v)
    out = torch.empty_like(q)
    chunks = pair_chunks(b, hq, hk)
    for (qc, oc, *lc), (kc, vc), _ in _by_pairs(
            chunks, hq // hk, [q, out] + ([lse] if return_lse else []),
            [k, v]):
        _launch_fwd(qc, kc, vc, oc, lc[0] if lc else None,
                    _plan_fwd(qc, kc) if chunks else plan, causal, window,
                    softcap, scale)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.native_launches += plan["variant"] in NATIVE
    flash_attention_cuda.wide_launches += plan["variant"] == "wgmma" \
        and plan["slices"] > 1
    flash_attention_cuda.padded_launches += width != d
    flash_attention_cuda.last_plan = plan
    return _unpad(d, out)[0], lse


def _launch_fwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                lse: Tensor | None, plan: dict, causal: bool,
                window: int | None, softcap: float, scale: float) -> None:
    """One launch of the forward library for q ``[b, hq, sq, width]`` (a
    tensor or one of ``pair_chunks``'s views) under its own plan."""
    b, hq, sq, width = q.shape
    hk, sk = k.shape[1], k.shape[2]
    part = (torch.empty(plan["scratch"] // 4, dtype=torch.float32,
                        device=q.device) if plan["split"] > 1 else None)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if part is None else part.data_ptr(),
            b, hq, hk, sq, sk, width, _DTYPES[q.dtype], int(causal),
            -1 if window is None else window, softcap, scale,
            plan["block_q"], plan["split"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed: "
                           f"{_launch_error(err)} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}, plan {plan})")


def _pad(width: int, *xs: Tensor) -> list[Tensor]:
    """The tensors with their head axis padded by zero columns to
    ``width`` (a layout copy; as they are where it is their own)."""
    if xs[0].shape[-1] == width:
        return list(xs)
    return [torch.nn.functional.pad(x, (0, width - x.shape[-1])) for x in xs]


def _unpad(d: int, *xs: Tensor) -> list[Tensor]:
    """The first ``d`` columns of each tensor's head axis, contiguous."""
    if xs[0].shape[-1] == d:
        return list(xs)
    return [x[..., :d].contiguous() for x in xs]


kbuild.define_op("flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
                 "bool causal, int? window, float softcap, float scale, "
                 "bool return_lse) -> (Tensor, Tensor)", _flash_fwd_op)


@torch.library.register_fake("repro_torch::flash_attention_fwd")
def _(q, k, v, causal, window, softcap, scale, return_lse):
    _plan_fwd(q, k)
    b, hq, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty(
        (b, hq, sq) if return_lse else (0,), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, causal, window, *args,
                     out_shape=None, **kwargs) -> int:
    return flash_work(q_shape, k_shape, 2, causal, window)[0]


flash_attention_cuda.launches = 0
flash_attention_cuda.native_launches = 0
flash_attention_cuda.wide_launches = 0
flash_attention_cuda.padded_launches = 0
flash_attention_cuda.last_plan = None


# ------------------------------------------------------------------ backward

def geometry_bwd(dtype: torch.dtype, d: int,
                 rows: int) -> tuple[int, int, int, int]:
    """The other side's rows a tile, threads and the shared-memory bytes of
    the dK/dV and of the dQ kernel whose blocks own ``rows`` rows (keys,
    queries), for (dtype, d), as ``csrc/flash_attention_bwd.cu`` lays them
    out (``dkdv_smem_bytes``, ``dq_smem_bytes``, ``cc_smem_bytes``);
    ``chip_smoke.py`` holds them against ``kernel_geometry_bwd``.  Other
    widths than 64, 96 and 128 run ``kernel_width(d)``'s instantiation,
    f32 past 128 the whole-width kernels (64-row blocks, tiles of 64 rows
    of the other side: ``cc_256_smem_bytes``, ``_f32_smem``),
    and bf16 past 256 the wide kernels (64 rows, one slice of ``SLICE``
    columns: ``wide_smem_bytes``).  The native
    kernels (bf16 136-256; dK/dV blocks of 64 keys, dQ of 128 queries,
    whatever ``rows`` asks): dK/dV 1 KB of alignment, K, V, two stages of Q
    and dO (64 rows of ``NATIVE_WIDTH`` bf16 columns each), two f32 P^T
    buffers of 64 x 64, each warpgroup's two stages of 64 lse or delta, 64
    bytes of mbarriers (``dkdv_256_smem_bytes``); dQ 1 KB, Q and dO of 128
    rows, two stages of K and one of V, 64 bytes, the rows' lse and delta
    (``dq_256_smem_bytes``)."""
    if native(d, dtype) and dtype == torch.float32:
        smem = _f32_smem(padded_width(d))[1]
        return CC_ROWS, CC_THREADS, smem, smem
    if native(d, dtype):
        tile = 64 * NATIVE_WIDTH * 2
        return (64, NATIVE_THREADS,
                1024 + 6 * tile + 2 * 64 * 64 * 4 + 4 * 64 * 4 + 64,
                1024 + 7 * tile + 64 + 2 * 128 * 4)
    if slices(d, dtype) > 1:
        # 1 KB of alignment, the ring, its mbarriers; dK/dV also two stages
        # of 64 lse and 64 delta
        smem = 1024 + WIDE_STAGES * 2 * 64 * 128 * 2 + 64
        return 64, 128, smem + 1024, smem
    d = kernel_width(d)
    if dtype == torch.bfloat16:
        cols = 64 if d <= 64 else 128
        # 1 KB to align the swizzled tiles, the block's two tiles and two
        # stages of the other side's two 64-row tiles of bf16, the
        # mbarriers; dK/dV also each warpgroup's two stages of 64 lse and
        # 64 delta
        tiles = 1024 + (2 * rows + 4 * 64) * cols * 2 + 64
        return 64, 2 * rows, tiles + rows // 64 * 1024, tiles
    # six f32 tiles of 64 rows padded by 4 floats (dK/dV: K, V, two stages
    # of Q and dO; dQ: Q, dO, two stages of K and V) and a 64 x 68 score tile
    smem = (6 * CC_ROWS * (d + 4) + CC_ROWS * (CC_ROWS + 4)) * 4
    return CC_ROWS, CC_THREADS, smem, smem


def kernel_plan_bwd(b: int, hq: int, hk: int, sq: int, sk: int, d: int,
                    dtype: torch.dtype, n_sm: int = N_SM) -> dict:
    """Launch plan of ``flash_attention_bwd_cuda`` for q ``[b, hq, sq, d]``
    and k/v ``[b, hk, sk, d]`` on a card of ``n_sm`` SMs: the variant (bf16
    ``"wgmma"``, f32 ``"cuda_cores"``), the rows, other side's tile,
    threads and shared memory (``geometry_bwd``) of the ``dkdv`` and ``dq``
    kernels, and the grid of each of the three launches (``delta``: 8 rows
    a block; ``dkdv``: key blocks x kv heads x batch; ``dq``: query blocks
    x query heads x batch, times the dQ key split).  A bf16 block owns 128
    rows (two warpgroups) unless that leaves fewer blocks than SMs, then
    64; an f32 block 64.  The C entry point applies the same rule to its
    card's SM count (``flash_attention_bwd_blocks`` reports it).  f32 dQ
    blocks that leave SMs idle split their keys ``dq["split"]`` ways
    (``key_split``) into ``scratch`` bytes of f32 (``split * b * hq * sq *
    width`` floats), added up in a fourth launch in a fixed order; bf16
    never splits.  ``width`` and ``slices`` as in ``kernel_plan``: the
    grids' x count slices.  f32 past 128 columns plans ``"cuda_cores_256"``,
    the whole-width kernels: 64-row blocks, dK/dV in two launches (dV, then
    dK, each forming S^T once a (key block, query tile), dK also dP^T), dQ
    forming S and dP once a (query block, key tile), all over the whole
    width; dQ's keys split and the dK/dV blocks' query tiles shared by
    ``wave_split`` (``dq["split"]``, ``dkdv["split"]``), each shared
    kernel's f32 parts in ``scratch`` (dQ's first, then dK's and dV's) added
    up in a later launch; bf16 past 256 the wide kernels' 64-row blocks,
    each a slice of ``SLICE`` columns.  bf16 at padded widths 136-256
    plans ``"wgmma_256"``, the native kernels: dK/dV blocks of 64 keys in
    ``dkdv["head_split"]`` shares of each GQA group (``head_split``; the
    grid's x counts key blocks x shares; with more than one share their f32
    parts, ``scratch`` bytes, go through ``dkdv_combine``, the grid
    ``"combine"``), dQ blocks of 128 queries.  The grids' y and z are
    ``head_grid``'s; past ``MAX_PAIRS`` pairs the plan is the first launch's
    and ``pair_chunks`` their count, as in ``kernel_plan``.  Raises
    ValueError on what no kernel takes."""
    _check_width("flash_attention_bwd_cuda", d)
    chunks = pair_chunks(b, hq, hk)
    if chunks:
        (r0, r1), (h0, h1) = chunks[0]
        return {**kernel_plan_bwd(r1 - r0, h1 - h0, 1, sq, sk, d, dtype, n_sm),
                "pair_chunks": len(chunks)}
    width, n_slices = padded_width(d), slices(d, dtype)
    if native(d, dtype) and dtype == torch.bfloat16:
        variant, block_rows = "wgmma_256", (64, 128)
    elif dtype == torch.bfloat16:
        variant = "wgmma"
        block_rows = (64 if n_slices > 1 or b * hk * -(-sk // 128) < n_sm
                      else 128,
                      64 if n_slices > 1 or b * hq * -(-sq // 128) < n_sm
                      else 128)
    elif dtype == torch.float32:
        variant = "cuda_cores_256" if native(d, dtype) else "cuda_cores"
        block_rows = (CC_ROWS, CC_ROWS)
    else:
        raise ValueError(f"flash_attention_bwd_cuda: dtype {dtype}, expected "
                         "torch.float32 or torch.bfloat16")
    plan = {"variant": variant}
    for i, (kernel, rows) in enumerate(zip(("dkdv", "dq"), block_rows)):
        other, threads, *smem = geometry_bwd(dtype, width, rows)
        if smem[i] > MAX_SMEM:
            raise ValueError(f"flash_attention_bwd_cuda: {smem[i]} bytes of "
                             f"shared memory exceed a block's {MAX_SMEM}")
        plan[kernel] = {"rows": rows, "other": other, "threads": threads,
                        "smem": smem[i]}
    q_blocks = -(-sq // plan["dq"]["rows"]) * n_slices
    k_blocks = -(-sk // plan["dkdv"]["rows"]) * n_slices
    if variant == "cuda_cores_256":
        split = wave_split(b * hq * q_blocks, -(-sk // CC_ROWS), n_sm)
        kv_split = wave_split(b * hk * k_blocks,
                              hq // hk * -(-sq // CC_ROWS), n_sm)
        plan["dkdv"]["split"] = kv_split
    else:
        split = (key_split(b * hq * q_blocks, sk, n_sm)
                 if dtype == torch.float32 else 1)
        kv_split = 1
    shares = (head_split(b, hk, sk, hq // hk, n_sm)
              if variant == "wgmma_256" else 1)
    k_blocks *= shares * kv_split
    plan["dq"]["split"] = split
    plan["dkdv"]["head_split"] = shares
    plan["scratch"] = (
        (split * b * hq * sq * width * 4 if split > 1 else 0)
        + (2 * shares * kv_split * b * hk * sk * width * 4
           if shares * kv_split > 1 else 0))
    plan["grids"] = {"delta": (-(-b * hq * sq // 8),),
                     "dkdv": (k_blocks, *head_grid(hk, b)),
                     "dq": (q_blocks * split, *head_grid(hq, b))}
    if shares > 1:
        plan["grids"]["combine"] = (-(-2 * b * hk * sk * width // 1024),)
    plan["width"], plan["slices"], plan["pair_chunks"] = width, n_slices, 1
    return plan


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = kbuild.load(SRC_BWD, NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd.argtypes = [p] * 11 + [i] * 9 + [f, f, i, i, p]
    lib.flash_attention_bwd.restype = i
    ip = ctypes.POINTER(i)
    lib.flash_attention_bwd_geometry.argtypes = [i, i, i, ip, ip, ip, ip]
    lib.flash_attention_bwd_geometry.restype = i
    lib.flash_attention_bwd_blocks.argtypes = [i] * 8 + [ip, ip]
    lib.flash_attention_bwd_blocks.restype = i
    return lib


def kernel_geometry_bwd(dtype: torch.dtype, d: int,
                        rows: int) -> tuple[int, int, int, int] | None:
    """The built backward library's other rows, threads and dK/dV and dQ
    shared memory for (dtype, d, rows) (d padded as the op pads it), or
    None if it has no instantiation (builds the library)."""
    out = [ctypes.c_int() for _ in range(4)]
    if _bwd_library().flash_attention_bwd_geometry(_DTYPES[dtype],
                                                   padded_width(d), rows,
                                                   *out):
        return None
    return tuple(x.value for x in out)


def kernel_block_rows_bwd(b: int, hq: int, hk: int, sq: int, sk: int, d: int,
                          dtype: torch.dtype, n_sm: int) -> tuple[int, int]:
    """The rows of the dK/dV and dQ blocks the built library launches for
    these shapes (head width ``d``, padded as the op pads it) on a card of
    ``n_sm`` SMs (builds the library)."""
    out = [ctypes.c_int() for _ in range(2)]
    if _bwd_library().flash_attention_bwd_blocks(b, hq, hk, sq, sk,
                                                 padded_width(d),
                                                 _DTYPES[dtype], n_sm, *out):
        raise ValueError(f"flash_attention_bwd_blocks refused {dtype}")
    return tuple(x.value for x in out)


def flash_attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                             lse: Tensor, do: Tensor, *, causal: bool = True,
                             window: int | None = None, softcap: float = 0.0,
                             scale: float | None = None
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """The gradient of ``flash_attention_cuda`` on the card: dq, dk, dv in
    the inputs' dtype from q, k, v, the forward's output ``o`` and its
    ``lse`` (``return_lse=True``) and the output's gradient ``do``; the
    contract of ``ref.attention_bwd_ref``.

    Three launches on the current stream (more where the dK/dV blocks'
    work or the f32 dQ keys are shared, each sum a launch of its own), no
    synchronisation.  Each call that
    launches adds one to ``flash_attention_bwd_cuda.launches`` (and to
    ``.native_launches``, ``.wide_launches`` and ``.padded_launches`` as
    the forward does) and leaves its plan in
    ``flash_attention_bwd_cuda.last_plan``.
    """
    kbuild.refuse_autograd("flash_attention_bwd_cuda", q=q, k=k, v=v, o=o,
                           do=do)
    _check(q, k, v, window)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, o, lse, do, bool(causal),
        None if window is None else int(window), float(softcap), float(scale))


def _plan_bwd(q: Tensor, k: Tensor, o: Tensor, lse: Tensor,
              do: Tensor) -> dict:
    """The backward's plan, then the shapes of the forward's outputs and
    the output's gradient beside q."""
    b, hq, sq, d = q.shape
    n_sm = _sm_count(q.device) if q.is_cuda else N_SM
    plan = kernel_plan_bwd(b, hq, k.shape[1], sq, k.shape[2], d, q.dtype, n_sm)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd_cuda: {name} is "
                             f"{tuple(x.shape)} {x.dtype}, q {tuple(q.shape)} "
                             f"{q.dtype}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_cuda: lse is "
                         f"{tuple(lse.shape)} {lse.dtype}, expected "
                         f"{(b, hq, sq)} torch.float32")
    return plan


def _flash_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                  do: Tensor, causal: bool, window: int | None,
                  softcap: float, scale: float
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """The backward's plan, checks and three launches
    (``flash_attention_bwd_cuda`` checks the shapes first)."""
    plan = _plan_bwd(q, k, o, lse, do)
    _check_placed("flash_attention_bwd_cuda", q, ("q", q), ("k", k),
                  ("v", v))
    for name, x in (("o", o), ("do", do), ("lse", lse)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd_cuda: {name} is not a "
                             f"contiguous, 16-byte aligned tensor on "
                             f"{q.device}")
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if q.numel() == 0 or k.numel() == 0:
        return tuple(torch.zeros_like(x) for x in (q, k, v))
    width = plan["width"]
    q, k, v, o, do = _pad(width, q, k, v, o, do)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    chunks = pair_chunks(b, hq, hk)
    for (qc, oc, doc, lc, dc, dqc), (kc, vc, dkc, dvc), first in _by_pairs(
            chunks, hq // hk, [q, o, do, lse, delta, dq], [k, v, dk, dv]):
        cplan = _plan_bwd(qc, kc, oc, lc, doc) if chunks else plan
        if first:
            _launch_bwd(qc, kc, vc, oc, doc, lc, dc, dqc, dkc, dvc, cplan,
                        causal, window, softcap, scale)
        else:  # a later run of a kv head's query heads adds its dK and dV
            parts = [torch.empty_like(x) for x in (dkc, dvc)]
            _launch_bwd(qc, kc, vc, oc, doc, lc, dc, dqc, *parts, cplan,
                        causal, window, softcap, scale)
            dkc.add_(parts[0])
            dvc.add_(parts[1])
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.native_launches += plan["variant"] in NATIVE
    flash_attention_bwd_cuda.wide_launches += plan["variant"] == "wgmma" \
        and plan["slices"] > 1
    flash_attention_bwd_cuda.padded_launches += width != d
    flash_attention_bwd_cuda.last_plan = plan
    return tuple(_unpad(d, dq, dk, dv))


def _launch_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
                lse: Tensor, delta: Tensor, dq: Tensor, dk: Tensor,
                dv: Tensor, plan: dict, causal: bool, window: int | None,
                softcap: float, scale: float) -> None:
    """The backward library's three (or four) launches for q ``[b, hq, sq,
    width]`` (a tensor or one of ``pair_chunks``'s views) under its own
    plan."""
    b, hq, sq, width = q.shape
    hk, sk = k.shape[1], k.shape[2]
    split = plan["dq"]["split"]
    part = (torch.empty(plan["scratch"] // 4, dtype=torch.float32,
                        device=q.device) if plan["scratch"] else None)
    with torch.cuda.device(q.device):
        err = _bwd_library().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), b, hq, hk, sq, sk,
            width, _DTYPES[q.dtype], int(causal),
            -1 if window is None else window, softcap, scale, split,
            plan["dkdv"]["head_split"] * plan["dkdv"].get("split", 1),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_cuda: launch failed: "
                           f"{_launch_error(err)} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}, plan {plan})")


kbuild.define_op("flash_attention_bwd(Tensor q, Tensor k, Tensor v, "
                 "Tensor o, Tensor lse, Tensor do, bool causal, int? window, "
                 "float softcap, float scale) -> (Tensor, Tensor, Tensor)",
                 _flash_bwd_op)


@torch.library.register_fake("repro_torch::flash_attention_bwd")
def _(q, k, v, o, lse, do, causal, window, softcap, scale):
    _plan_bwd(q, k, o, lse, do)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
                     causal, window, *args, out_shape=None, **kwargs) -> int:
    return flash_bwd_work(q_shape, k_shape, 2, causal, window)[0]


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.native_launches = 0
flash_attention_bwd_cuda.wide_launches = 0
flash_attention_bwd_cuda.padded_launches = 0
flash_attention_bwd_cuda.last_plan = None


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient.  On CUDA tensors the forward kernel (with
    its row log-sum-exp) and the backward kernels; on CPU tensors
    ``ref.attention_ref`` / ``attention_lse_ref`` and
    ``ref.attention_bwd_ref``.  Saves q, k, v, the output and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, softcap: float, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        if q.device.type != "cpu":
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        else:
            out = ref.attention_ref(q, k, v, **kw)
            lse = ref.attention_lse_ref(q, k, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (ref.attention_bwd_ref if q.device.type == "cpu"
               else flash_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None

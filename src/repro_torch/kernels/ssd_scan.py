"""The Mamba2 SSD chunked scan as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas``.  The kernel source
is ``csrc/ssd_scan.cu`` (its header says what bounds it and how the design
answers that); ``kernels/build.py`` builds it with ``nvcc`` at first use and
binds it through ``ctypes``.  Nothing is built or loaded at import.

Two variants, chosen by dtype in ``kernel_plan``, each three phases of
which all but the state pass are chunk-parallel, with f32 scratch between
them: bf16 on the tensor cores (``"wgmma"``: TMA loads, ``wgmma`` for every
product); f32 on the CUDA cores (``"cuda_cores"``: f32 FMAs, which its 2e-4
tolerance needs, ``cp.async`` tiles, blocks walking a run of a group's
heads with S = C B^T formed once a block).  There is no option that picks
another: a CUDA tensor launches its dtype's phases or raises.

Every input ``ssd_scan_pallas`` takes runs: P, N and chunk of at least 1,
every batch and head count (``kernel_plan``).  ``ssd_decomposed`` and
``ssd_bwd_decomposed`` bring an input to the instantiations' domain,
exactly in arithmetic: the chunk to ``run_chunk``'s, P and N padded with
zero columns to ``HEAD_DIMS`` or cut into slices of 128
(``width_slices``); the grids fold (batch, head) pairs past 65,535
(``build.head_grid``, ``csrc/grid_fold.cuh``).

``ssd_scan_cuda`` takes CUDA tensors only and returns a result outside the
autograd graph; it refuses to run where autograd would need a gradient.
With ``return_state`` it also returns the f32 ``[B, H, P, N]`` state after
the last step, which a prefill hands to the recurrent decode.
The kernel is a ``torch.library`` op (``repro_torch::ssd_scan_fwd``)
whose body plans, checks devices and layout, and launches the phases; its
fake implementation plans (refusing what the card would) and gives the
outputs' shapes alone, so a meta tensor traces the card's program without
data.  Its FLOP formula (``ssd_work``, the count chip_smoke.py's bound
uses) lets a counting mode read its work.
``SSDScan`` is the differentiable form: its forward launches the kernel, its
backward the backward kernel (``csrc/ssd_scan_bwd.cu``, ``ssd_scan_bwd_cuda``,
op ``repro_torch::ssd_scan_bwd``): six launches with scratch the wrapper
allocates; bf16 (``"wgmma"``) loads its tiles by TMA, runs every product
on ``wgmma`` and walks a run of a group's heads a block, so dS is summed
over the heads before its products with C and B and no per-head partial
reaches device memory; f32 (``"cuda_cores"``) has the same structure in
f32 FMAs on the CUDA cores (``kernel_plan_bwd``).  No atomics, so the
same inputs give bitwise the same gradients.  Its plain version is
``ref.ssd_scan_bwd_ref``; nothing on the card falls back to it.  The JAX
package has no backward kernel to port: it trains through ``jax.grad`` of
``ref.ssd_chunked_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.build import head_grid
from repro_torch.kernels.flash_attention import N_SM

SRC = kbuild.CSRC / "ssd_scan.cu"
SRC_BWD = kbuild.CSRC / "ssd_scan_bwd.cu"
NVCC_FLAGS = kbuild.BASE_FLAGS
HEAD_DIMS = (16, 32, 64, 128)   # P and N the instantiations take
MAX_CHUNK = 128                 # chunk: a multiple of 32 up to this
MAX_SMEM = 232_448              # dynamic shared memory a block may have
PASS_THREADS = 256              # forward state pass (4 elements a thread),
                                # backward reductions: threads a block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry point's codes besides cudaError_t
_NO_ENCODER, _ENCODE_FAILED = 999, 1000
PHASES = {                      # the forward's launches, by plan variant
    "wgmma": ("ssd_fwd_chunk_state", "ssd_fwd_state_pass",
              "ssd_fwd_chunk_scan"),
    "cuda_cores": ("ssd_fwd_chunk_state_cc", "ssd_fwd_state_pass",
                   "ssd_fwd_chunk_scan_cc"),
}
BWD_PHASES = {                  # the backward's launches, by plan variant
    "wgmma": ("ssd_bwd_states_wgmma", "ssd_bwd_chain", "ssd_bwd_dx_ds_wgmma",
              "ssd_bwd_db_dc_wgmma", "ssd_bwd_dcum", "ssd_bwd_reduce_runs"),
    "cuda_cores": ("ssd_bwd_states_cc", "ssd_bwd_chain", "ssd_bwd_dx_ds_cc",
                   "ssd_bwd_db_dc_cc", "ssd_bwd_dcum", "ssd_bwd_reduce_runs"),
}
CC_THREADS = 256        # f32: threads of a CUDA-core block (64-row tiles)
DCUM_THREADS = 128      # backward: threads of the dcum launch
CHAIN_THREADS = 256     # state chain: threads a block, 4 elements each


def ssd_work(x_shape, g: int, n: int, chunk: int,
             dtype_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one scan of x ``[b, s, h, p]`` with B/C of
    ``g`` groups of ``n``.  Per (b, h) and chunk of q rows (a ragged last
    chunk counts its own): q (q + 1) / 2 P multiply-adds for the causal
    triangle of W x and 2 q P N for C h_in and the state update; per (b, g)
    and chunk, since B and C belong to the group: q (q + 1) / 2 N for that
    of S = C B^T.  x, dt, B, C read once and y written once."""
    b, s, h, p = x_shape
    rows = [min(chunk, s - t) for t in range(0, s, chunk)]
    tri = sum(q * (q + 1) // 2 for q in rows)
    macs = h * (tri * p + 2 * s * p * n) + g * tri * n
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * dtype_bytes \
        + b * s * h * 4 + 2 * h * 4
    return 2 * b * macs, nbytes


def ssd_bwd_work(x_shape, g: int, n: int, chunk: int,
                 dtype_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one backward of the scan. Per (b, h) and
    chunk of q rows: q (q + 1) / 2 2 P multiply-adds for the causal
    triangles of R = dy x^T and M^T dy, and 5 q P N for the chunk's state
    and state gradient, B G^T, x G and dy h. Per (b, g) and chunk, since
    B and C belong to the group: q (q + 1) / 2 3 N for the triangles of
    S = C B^T, dS B and dS^T C, with dS summed over the group's heads
    first. x, dy, dt, B, C read once, dx, ddt, dB, dC written once."""
    b, s, h, p = x_shape
    rows = [min(chunk, s - t) for t in range(0, s, chunk)]
    tri = sum(q * (q + 1) // 2 for q in rows)
    macs = h * (tri * 2 * p + 5 * s * p * n) + g * tri * 3 * n
    nbytes = (3 * b * s * h * p + 4 * b * s * g * n) * dtype_bytes \
        + 2 * b * s * h * 4 + 4 * h * 4
    return 2 * b * macs, nbytes


def _padded(w: int) -> int:
    """Columns a bf16 tile keeps in shared memory: whole 64-column boxes."""
    return 64 if w <= 64 else 128


def _states_cc(p: int, n: int, rows: int) -> int:
    """Floats of an f32 chunk-states block (``states_cc_floats``): the
    group's rows, two stages of a head's rows, dt, cum and the row scale;
    every f32 row 16 bytes longer than its width."""
    return rows * (n + 4) + 2 * rows * (p + 4) + 3 * rows


def geometry(dtype: torch.dtype, p: int, n: int,
             rows: int) -> list[tuple[int, int]]:
    """(threads, shared-memory bytes) of each phase of the kernel
    instantiated for (dtype, p, n, tile rows), as ``csrc/ssd_scan.cu`` lays
    it out (``chunk_state_smem``, ``chunk_scan_smem``; ``states_cc_floats``,
    ``scan_cc_floats``).  The C entry point takes only (dtype, p, n, rows)
    and launches with its own numbers; these are what the plan reports
    without the library, and ``chip_smoke.py`` holds them against
    ``kernel_geometry``."""
    if dtype == torch.bfloat16:
        pp, np_ = _padded(p) // 64, _padded(n) // 64    # 64-column boxes
        box = rows * 128                                # bytes of a box
        # 1 KB to align the swizzled boxes, the boxes (x, B; C, B, x and
        # h_in's of padded-P rows), the mbarrier, per-row floats
        state = 1024 + box * (pp + np_) + 8 + 3 * rows * 4
        scan = 1024 + box * (2 * np_ + pp) + 64 * pp * 128 * np_ + 8 \
            + 2 * rows * 4
        return [(128, state), (PASS_THREADS, 0), (2 * rows, scan)]
    # the scan: C's 64 query rows, h_in's rows of y's pt columns, x's first
    # stage, then B's key rows, or W's 64 rows and x's second stage, then
    # dt and cum
    pt = min(p, 64)
    late = max(rows * (n + 4), 64 * (rows + 4) + rows * (pt + 4))
    scan = 64 * (n + 4) + pt * (n + 4) + rows * (pt + 4) + late + 2 * rows
    return [(CC_THREADS, _states_cc(p, n, rows) * 4), (PASS_THREADS, 0),
            (CC_THREADS, scan * 4)]


def run_chunk(chunk: int) -> int:
    """The chunk the kernels run for an asked ``chunk`` >= 1: the smallest
    multiple of 32 at or above it, at most ``MAX_CHUNK``.  y, the final
    state and the gradients do not depend on the chunk but in rounding (the
    chunked form is the recurrence regrouped, and a padded ``dt = 0`` row
    is an identity step), so any chunk runs on an instantiated one: 8 runs
    at 32, 48 at 64, 100 and 256 at 128."""
    return min(MAX_CHUNK, -(-chunk // 32) * 32)


def width_slices(w: int) -> tuple[int, int]:
    """(slices, padded width) of a head dim P or state dim N of ``w``
    columns: up to 128 one slice padded with zero columns to the next of
    ``HEAD_DIMS``; past 128, ``ceil(w / 128)`` slices of 128 columns, the
    last padded to 128."""
    if w <= 128:
        return 1, next(d for d in HEAD_DIMS if d >= w)
    return -(-w // 128), 128


def _refuse(name: str, b: int, h: int, p: int, n: int, chunk: int) -> None:
    """What is outside the function: an empty head dim, state dim or chunk.
    Every other P, N, chunk, batch and head count runs (``kernel_plan``'s
    decomposition)."""
    for what, v in (("head dim P", p), ("state dim N", n), ("chunk", chunk)):
        if v < 1:
            raise ValueError(f"{name}: {what} {v} is below 1")


def _decomposition(b: int, s: int, h: int, p: int, g: int, n: int,
                   chunk: int) -> tuple[dict, tuple[int, ...]]:
    """The plans' decomposition keys and the in-domain shape each launch
    runs (b, s, h, padded P, g, padded N, run chunk)."""
    kp, pw = width_slices(p)
    kn, nw = width_slices(n)
    q = run_chunk(chunk)
    keys = {"chunk": q, "p_slices": kp, "p_width": pw, "n_slices": kn,
            "n_width": nw, "launches": kp * kn}
    return keys, (b, s, h, pw, g, nw, q)


def kernel_plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                dtype: torch.dtype) -> dict:
    """Launch plan of ``ssd_scan_cuda`` for x ``[b, s, h, p]`` and Bm/Cm
    ``[b, s, g, n]`` in chunks of ``chunk``: every P, N and chunk of at
    least 1, every batch and head count.

    The decomposition (``ssd_decomposed``): the scan runs at ``chunk`` =
    ``run_chunk`` of the asked one; P in ``p_slices`` slices of
    ``p_width`` columns and N in ``n_slices`` of ``n_width``
    (``width_slices``: zero columns pad each), so ``launches`` = p_slices
    x n_slices runs of the phases below, each at the padded widths.

    bf16 plans ``"wgmma"``: three phases, chunk state and chunk scan with
    one block per (chunk, head, batch), the state pass with one thread per
    4 elements of a head's ``[p, n]`` state; the chunk sits in a tile of
    ``rows`` = the chunk rounded up to 64, one warpgroup per 64 rows in the
    chunk scan; ``mma`` lists each phase's wgmma shapes (m, n, k), P and N
    below 64 padded to 64.  ``scratch`` holds the shapes and dtypes the
    wrapper allocates for one launch (cum, the chunks' own states, the
    states entering them) and ``scratch_bytes`` their sum.  f32 plans
    ``"cuda_cores"``: the same three phases on the CUDA cores, a group's
    heads split into ``runs`` runs of ``run_len`` (``head_runs``) that a
    block walks in order; the chunk state one block per (chunk, run,
    batch), the chunk scan one per (chunk, 64-row query half, 64 columns
    of y where P = 128, run, batch), S = C B^T formed once a block; the
    states entering the chunks go over the chunks' own states in place (no
    ``h_in``).  The grids' y and z are ``head_grid``'s of (heads or runs,
    batch): folded past 65,535.  Raises ValueError on another dtype and on
    an empty P, N or chunk.
    """
    _refuse("ssd_scan_cuda", b, h, p, n, chunk)
    keys, shape = _decomposition(b, s, h, p, g, n, chunk)
    return {**_kernel_plan(*shape, dtype), **keys}


def _kernel_plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                 dtype: torch.dtype) -> dict:
    """``kernel_plan``'s phases for one launch in the kernels' domain."""
    nc = -(-s // chunk)
    rows = 64 if chunk <= 64 else 128
    pass_grid = (b * h, -(-p * n // (4 * PASS_THREADS)), 1)
    extra = {}
    if dtype == torch.bfloat16:
        pp, np_ = _padded(p), _padded(n)
        grids = [(nc, *head_grid(h, b)), pass_grid, (nc, *head_grid(h, b))]
        mma = [[(64, np_, 16)], [], [(64, rows, 16), (64, pp, 16)]]
        scratch = {
            "cum": ((b, h, nc * chunk), torch.float32),
            "state": ((b, h, nc, p, n), torch.float32),
            "h_in": ((b, h, nc, p, n), torch.bfloat16),
        }
        variant = "wgmma"
    elif dtype == torch.float32:
        runs, run_len = head_runs(b, s, h, g, chunk)
        tiles = rows // 64 * (p // min(p, 64))   # query halves x y's columns
        yz = head_grid(g * runs, b)
        grids = [(nc, *yz), pass_grid, (nc * tiles, *yz)]
        mma = [[], [], []]
        scratch = {
            "cum": ((b, h, nc * chunk), torch.float32),
            "state": ((b, h, nc, p, n), torch.float32),
        }
        variant = "cuda_cores"
        extra = {"runs": runs, "run_len": run_len}
    else:
        raise ValueError(f"ssd_scan_cuda: x is {dtype}, expected "
                         "torch.float32 or torch.bfloat16")
    phases = [{"name": name, "grid": grid, "threads": threads, "smem": smem,
               "mma": shapes}
              for name, grid, (threads, smem), shapes
              in zip(PHASES[variant], grids, geometry(dtype, p, n, rows),
                     mma)]
    for ph in phases:
        if ph["smem"] > MAX_SMEM:
            raise ValueError(f"ssd_scan_cuda: {ph['smem']} bytes of shared "
                             f"memory exceed a block's {MAX_SMEM}")
    nbytes = sum(math.prod(shape) * dt.itemsize
                 for shape, dt in scratch.values())
    return {"variant": variant, "rows": rows, **extra, "phases": phases,
            "scratch": scratch, "scratch_bytes": nbytes}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SRC, NVCC_FLAGS)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssd_scan_fwd.argtypes = [p] * 11 + [i] * 10 + [q] * 12 + [p]
    lib.ssd_scan_fwd.restype = i
    ip = ctypes.POINTER(i)
    lib.ssd_scan_geometry.argtypes = [i, i, i, i, i, ip, ip]
    lib.ssd_scan_geometry.restype = i
    return lib


def kernel_geometry(dtype: torch.dtype, p: int, n: int,
                    rows: int) -> list[tuple[int, int]] | None:
    """(threads, shared-memory bytes) of each phase of the built library's
    instantiation for (dtype, p, n, rows), or None if it has none (builds
    the library)."""
    out = []
    for phase in range(3):
        threads, smem = ctypes.c_int(), ctypes.c_int()
        if _library().ssd_scan_geometry(_DTYPES[dtype], p, n, rows, phase,
                                        threads, smem):
            return None
        out.append((threads.value, smem.value))
    return out


def _dxds_smem(pp: int, np_: int, rows: int, wgs: int) -> int:
    """Shared memory of the bf16 dx / dS launch with ``wgs`` warpgroups
    (``dxds_smem``): 1 KB of alignment, B's key rows and C, two stages of
    x (key rows), dy and G, three mbarriers, then dt, cum and w, each warp's
    column sums, the block sum's 8 floats."""
    kr = 64 * wgs
    tiles = (np_ * kr + np_ * rows + 2 * (pp * kr + pp * rows + np_ * pp)) * 2
    return 1024 + tiles + 24 + (3 * rows + 4 * wgs * rows + 8) * 4


def dxds_warpgroups(p: int, n: int, rows: int) -> int:
    """Warpgroups of a bf16 dx / dS block: one per 64 key rows of the tile,
    or one (two blocks over the key rows) where that would not fit."""
    pp, np_ = _padded(p), _padded(n)
    return rows // 64 if _dxds_smem(pp, np_, rows, rows // 64) <= MAX_SMEM \
        else 1


def geometry_bwd(dtype: torch.dtype, p: int, n: int,
                 rows: int = 128) -> list[tuple[int, int]]:
    """(threads, dynamic shared-memory bytes) of each launch of the
    backward for (dtype, p, n), as ``csrc/ssd_scan_bwd.cu`` lays it out.

    bf16 (tile ``rows``, the chunk rounded up to 64; P and N padded to 64
    or 128 columns of bf16, 128 bytes a row of a 64-column box): chunk
    states, 256 threads, 1 KB of alignment, B and C, two stages of x and
    dy, three mbarriers, 4 floats a row (``states_wg_smem``); the chain's
    256; dx / dS (``dxds_smem``); dB / dC, a warpgroup per 64 rows, C and
    the room of two stages of x or dy and G or h (or of dS and B, if
    larger), four mbarriers, a float a row (``dbdc_smem``); dcum 128;
    the reduction 256.  f32 (tile ``rows`` as bf16's; ``states_cc_floats``,
    ``dxds_cc_floats``, ``dbdc_cc_floats``): 256 threads in the three
    CUDA-core launches, tiles of f32 rows 16 bytes longer than their width;
    the chain, dcum and the reduction as bf16's.  ``chip_smoke.py`` holds
    them against ``kernel_geometry_bwd``."""
    if dtype == torch.bfloat16:
        pp, np_ = _padded(p), _padded(n)
        wgs = dxds_warpgroups(p, n, rows)
        states = 1024 + (2 * np_ + 4 * pp) * rows * 2 + 24 + 4 * rows * 4
        stages = 2 * (pp * rows + np_ * pp) * 2
        room = max(stages, (rows * rows + np_ * rows) * 2)
        dbdc = 1024 + np_ * rows * 2 + room + 32 + rows * 4
        return [(256, states), (CHAIN_THREADS, 0),
                (128 * wgs, _dxds_smem(pp, np_, rows, wgs)), (2 * rows, dbdc),
                (DCUM_THREADS, 0), (PASS_THREADS, 0)]
    st3, g_in_m = dxds_cc_mode(p, n)
    return [(CC_THREADS, _states_cc(p, n, rows) * 4), (CHAIN_THREADS, 0),
            (CC_THREADS, _dxds_cc(p, n, rows, st3, g_in_m) * 4),
            (CC_THREADS, _dbdc_cc(p, n, rows, dbdc_cc_stages(p, n)) * 4),
            (DCUM_THREADS, 0), (PASS_THREADS, 0)]


def _dxds_cc(p: int, n: int, rows: int, stages: int, g_in_m: bool) -> int:
    """Floats of the f32 dx / dS block (``dxds_cc_floats``): B's 64 key
    rows; a stage of x's key rows and dy's query rows; the room that holds
    C's query rows until S^T is formed and then G, M^T (G in M^T's own room
    where ``g_in_m``) and a second stage; dt and cum of the tile's rows, w
    of the key rows, each warp's column sums, the block sum's 8 floats."""
    stage = (64 + rows) * (p + 4)
    rest = (max(64 * (rows + 4), p * (n + 4)) if g_in_m
            else 64 * (rows + 4) + p * (n + 4)) + (stages - 1) * stage
    return 64 * (n + 4) + stage + max(rows * (n + 4), rest) + 2 * rows \
        + 64 + 8 * rows + 8


def dxds_cc_mode(p: int, n: int) -> tuple[int, bool]:
    """(stages, G in M^T's room) of the f32 dx / dS block: two stages and G
    apart where they fit at 128-row tiles, else one stage, else G in M^T's
    room too (``dxds_cc_stages``, ``dxds_cc_g_in_m``)."""
    if _dxds_cc(p, n, 128, 2, False) * 4 <= MAX_SMEM:
        return 2, False
    return 1, _dxds_cc(p, n, 128, 1, False) * 4 > MAX_SMEM


def _dbdc_cc(p: int, n: int, rows: int, stages: int) -> int:
    """Floats of the f32 dB / dC block (``dbdc_cc_floats``): C's 64 rows;
    the room of the stages (64 rows of x or dy and G or h), which the
    closing product's tiles (the run's dS^T, the rows of C or B) take after
    the heads; the row scale."""
    room = max(stages * (64 * (p + 4) + p * (n + 4)),
               rows * 68 + rows * (n + 4))
    return 64 * (n + 4) + room + 64


def dbdc_cc_stages(p: int, n: int) -> int:
    """Stages of the f32 dB / dC block: two where they fit at 128-row
    tiles (``dbdc_cc_stages``)."""
    return 2 if _dbdc_cc(p, n, 128, 2) * 4 <= MAX_SMEM else 1


def head_runs(b: int, s: int, h: int, g: int, chunk: int) -> tuple[int, int]:
    """(runs, heads a run) of the bf16 backward: a block walks a run of a
    group's heads; the heads of a group are split into as many runs as
    keep b x chunks x groups x runs blocks within the card's N_SM (at least
    one run, at most one a head), the last run the shorter."""
    hpg = h // g
    per = b * -(-s // chunk) * g
    want = max(1, min(hpg, N_SM // per))
    run_len = -(-hpg // want)
    return -(-hpg // run_len), run_len


def kernel_plan_bwd(b: int, s: int, h: int, p: int, g: int, n: int,
                    chunk: int, dtype: torch.dtype) -> dict:
    """Launch plan of ``ssd_scan_bwd_cuda`` for x ``[b, s, h, p]`` and
    Bm/Cm ``[b, s, g, n]`` in chunks of ``chunk``: the forward's domain
    and its decomposition (``kernel_plan``; ``ssd_bwd_decomposed``).

    bf16 plans ``"wgmma"``: six launches (``BWD_PHASES["wgmma"]``).  The
    chunk states, dx / dS and dB / dC walk a run of a group's heads
    (``runs`` a group of ``run_len`` heads, ``head_runs``): grids
    (chunks, groups x runs, batch), dx / dS with ``key_blocks`` blocks over
    a tile's key rows and dB / dC with two blocks (dB, dC) a chunk; the
    chain one block per (b h, 1,024 state elements); dcum one per (chunk,
    head, batch); the reduction a warp a head (grid y 0) and, with more
    than one run, over ``[b, s, g, n]`` (grid y 1).  ``rows`` is the tile, the
    chunk rounded up to 64; ``mma`` lists each launch's wgmma shapes (P and
    N padded to 64 or 128).  f32 plans ``"cuda_cores"``: six launches
    (``BWD_PHASES["cuda_cores"]``) in the same structure on the CUDA cores:
    the chunk states two blocks (state, state gradient) a (chunk, run),
    dx / dS one a 64-row key block (``key_blocks``), dB / dC two (dB, dC)
    a 64-row block, the chain handing h and G on in f32, dS kept in f32.
    The grids' y and z (groups x runs or heads, batch) are ``head_grid``'s.
    ``scratch`` holds the tensors the wrapper allocates for one launch, in
    the C entry point's order (no ``[b, s, h, n]`` tensor in either
    variant), and ``scratch_bytes`` their sum.  Raises ValueError on
    another dtype and on an empty P, N or chunk.
    """
    _refuse("ssd_scan_bwd_cuda", b, h, p, n, chunk)
    keys, shape = _decomposition(b, s, h, p, g, n, chunk)
    return {**_kernel_plan_bwd(*shape, dtype), **keys}


def _kernel_plan_bwd(b: int, s: int, h: int, p: int, g: int, n: int,
                     chunk: int, dtype: torch.dtype) -> dict:
    """``kernel_plan_bwd``'s launches for one run in the kernels' domain."""
    name = "ssd_scan_bwd_cuda"
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x is {dtype}, expected torch.float32 or "
                         "torch.bfloat16")
    f32, nc = torch.float32, -(-s // chunk)
    rows_ = (b, h, nc * chunk)
    rows = 64 if chunk <= 64 else 128
    runs, run_len = head_runs(b, s, h, g, chunk)
    yz = head_grid(g * runs, b)
    tiles = -(-p * n // (4 * CHAIN_THREADS))
    reduce_x = max(-(-h // (PASS_THREADS // 32)),
                   -(-b * s * g * n // (4 * PASS_THREADS)) if runs > 1 else 0)
    if dtype == torch.bfloat16:
        variant = "wgmma"
        pp, np_ = _padded(p), _padded(n)
        jbs = rows // (64 * dxds_warpgroups(p, n, rows))
        grids = [(nc, *yz), (b * h, tiles, 1), (nc * jbs, *yz),
                 (2 * nc, *yz), (nc, *head_grid(h, b)),
                 (reduce_x, 2 if runs > 1 else 1, 1)]
        products = [[(64, np_, 16)], [], [(64, pp, 16), (64, 64, 16)],
                    [(64, np_, 16)], [], []]
        ds = torch.bfloat16
    else:
        variant, jbs = "cuda_cores", rows // 64
        grids = [(2 * nc, *yz), (b * h, tiles, 1),
                 (nc * jbs, *yz), (2 * jbs * nc, *yz),
                 (nc, *head_grid(h, b)), (reduce_x, 2 if runs > 1 else 1, 1)]
        products = [[]] * 6
        ds = f32
    scratch = {
        "cum": (rows_, f32),
        "state": ((b, h, nc, p, n), f32),
        "state_grad": ((b, h, nc, p, n), f32),
        "dots": ((b, h, nc, tiles), f32),
        "colsum": (rows_, f32),
        "dw": (rows_, f32),
        "dcum_rows": ((jbs,) + rows_, f32),
        "state_rows": (rows_, f32),
        "dS": ((runs, b, nc, g, rows, rows), ds),
        "dA_part": ((b, h, nc), f32),
        "dD_part": ((b, h, nc, jbs), f32),
    }
    if runs > 1:
        scratch["dBC_runs"] = ((2, runs, b, s, g, n), f32)
    extra = {"rows": rows, "runs": runs, "run_len": run_len,
             "key_blocks": jbs}
    phases = [{"name": ph, "grid": grid, "threads": threads, "smem": smem,
               "mma": shapes}
              for ph, grid, (threads, smem), shapes
              in zip(BWD_PHASES[variant], grids,
                     geometry_bwd(dtype, p, n, rows), products)]
    for ph in phases:
        if ph["smem"] > MAX_SMEM:
            raise ValueError(f"{name}: {ph['smem']} bytes of shared memory "
                             f"exceed a block's {MAX_SMEM}")
    nbytes = sum(math.prod(shape) * dt.itemsize
                 for shape, dt in scratch.values())
    return {"variant": variant, **extra, "phases": phases,
            "scratch": scratch, "scratch_bytes": nbytes}


def _check(x, dt, A, Bm, Cm, D) -> None:
    """Shapes and dtypes: the wrapper's own checks, on any tensor.  The plan
    (``kernel_plan``) and the devices and layout are the op's (its fake
    implementation plans too, so a trace refuses what the card would)."""
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


def _on_card(fn: str, named) -> None:
    """Every tensor of ``named`` on the CUDA device the first lies on."""
    first = named[0][1].device
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}, not a CUDA "
                             "device")
        if t.device != first:
            raise ValueError(f"{fn}: {name} is on {t.device}, "
                             f"{named[0][0]} on {first}")


def _check_placed(plan, x, dt, A, Bm, Cm, D) -> None:
    """Devices and layout, in the op's body after its plan (so what the
    plan refuses is refused before any device is looked at)."""
    _on_card("ssd_scan_cuda", (("x", x), ("dt", dt), ("A", A), ("Bm", Bm),
                               ("Cm", Cm), ("D", D)))
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan_cuda: the last axis of {name} is not "
                             "contiguous")
        if plan["variant"] != "wgmma":
            continue    # f32: a row that cp.async cannot read is copied
        # TMA reads bf16 rows from 16-byte aligned addresses and strides
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan_cuda: {name} is not 16-byte aligned")
        for axis, stride in zip("bsh" if name == "x" else "bsg", t.stride()):
            if stride * t.element_size() % 16:
                raise ValueError(
                    f"ssd_scan_cuda: {name}'s stride {stride} along axis "
                    f"{axis} is not a multiple of 16 bytes, which TMA needs")


def _launch_failed(fn: str, err: int, x: Tensor, Bm: Tensor, chunk: int,
                   plan: dict) -> None:
    """Raise for a C entry point's non-zero return: a cudaError_t, or the
    tensor-map codes of ``csrc/hopper.cuh``."""
    if err == _NO_ENCODER:
        what = "the driver has no cuTensorMapEncodeTiled"
    elif err >= _ENCODE_FAILED:
        what = (f"cuTensorMapEncodeTiled failed with CUresult "
                f"{err - _ENCODE_FAILED}")
    else:
        what = f"CUDA error {err}"
    raise RuntimeError(f"{fn}: launch failed: {what} (x {tuple(x.shape)}, "
                       f"Bm {tuple(Bm.shape)}, {x.dtype}, chunk {chunk}, "
                       f"plan {plan})")


def ssd_scan_cuda(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                  D: Tensor, *, chunk: int = 128, return_state: bool = False):
    """The SSD scan on the card: x ``[B, S, H, P]``, dt ``[B, S, H]``, A and
    D ``[H]``, Bm/Cm ``[B, S, G, N]`` -> y ``[B, S, H, P]`` in x's dtype, the
    contract of ``ref.ssd_scan_ref`` (S need not be a multiple of
    ``chunk``); with ``return_state``, ``(y, state)`` with the f32 state
    ``[B, H, P, N]`` after step S.  x, Bm, Cm and dt are read through their
    strides (for bf16 x, Bm and Cm each a multiple of 16 bytes; f32 copies
    one whose rows are not 16-byte aligned).

    Launches on the current stream and does not synchronise: the three
    phases of ``kernel_plan`` with the scratch it lists, once for each pair
    of its P and N slices (``ssd_decomposed``).  Each call that launches
    adds one to ``ssd_scan_cuda.launches`` and leaves its plan in
    ``ssd_scan_cuda.last_plan``.
    """
    kbuild.refuse_autograd("ssd_scan_cuda", x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D)
    _check(x, dt, A, Bm, Cm, D)
    y, state = torch.ops.repro_torch.ssd_scan_fwd(
        x, dt, A, Bm, Cm, D, int(chunk), bool(return_state))
    return (y, state) if return_state else y


def _plan(x: Tensor, Bm: Tensor, chunk: int) -> dict:
    b, s, h, p = x.shape
    return kernel_plan(b, s, h, p, Bm.shape[2], Bm.shape[3], chunk, x.dtype)


def _ssd_fwd_op(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                D: Tensor, chunk: int,
                return_state: bool) -> tuple[Tensor, Tensor]:
    """The scan's plan, checks and launches (``ssd_scan_cuda`` checks the
    shapes first), through ``ssd_decomposed``; the state is ``[0]`` unless
    asked for."""
    plan = _plan(x, Bm, chunk)
    _on_card("ssd_scan_cuda", (("x", x), ("dt", dt), ("A", A), ("Bm", Bm),
                               ("Cm", Cm), ("D", D)))
    b, s, h, p = x.shape
    n = Bm.shape[3]
    state = torch.zeros((b, h, p, n) if return_state else (0,),
                        dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format), \
            state
    out = ssd_decomposed(functools.partial(_launch_fwd, plan), x, dt, A, Bm,
                         Cm, D, chunk=chunk, return_state=return_state)
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.last_plan = plan
    return out if return_state else (out, state)


def _launch_fwd(plan: dict, x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                Cm: Tensor, D: Tensor, *, chunk: int, return_state: bool):
    """One launch of the three phases for tensors in the kernels' domain
    (``plan``'s padded widths and run chunk): y, or (y, state)."""
    _check_placed(plan, x, dt, A, Bm, Cm, D)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n) if return_state else (0,),
                        dtype=torch.float32, device=x.device)
    A, D = A.contiguous(), D.contiguous()
    if plan["variant"] == "cuda_cores":
        # cp.async reads 16-byte pieces of x, Bm and Cm rows
        x, Bm, Cm = (t if t.data_ptr() % 16 == 0
                     and all(st % 4 == 0 for st in t.stride()[:3])
                     else _dense(t) for t in (x, Bm, Cm))
    scratch = [torch.empty(shape, dtype=dtype, device=x.device)
               for shape, dtype in plan["scratch"].values()]
    scratch += [None] * (3 - len(scratch))    # f32 has no h_in of its own
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in scratch),
            state.data_ptr() if return_state else None,
            b, s, h, g, p, n, chunk, _DTYPES[x.dtype], plan["rows"],
            plan.get("runs", 1), *x.stride()[:3], *dt.stride(),
            *Bm.stride()[:3],
            *Cm.stride()[:3], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _launch_failed("ssd_scan_cuda", err, x, Bm, chunk, plan)
    return (y, state) if return_state else y


def _cols(t: Tensor, k: int, w: int) -> list[Tensor]:
    """The ``k`` slices of ``t``'s last axis that ``width_slices`` cuts
    (128 columns each past 128), each padded with zero columns to ``w``;
    ``[t]`` where ``t`` is one slice of width ``w`` already."""
    if k == 1 and t.shape[-1] == w:
        return [t]
    pieces = [t[..., 128 * i:128 * i + w] for i in range(k)]
    return [torch.nn.functional.pad(c, (0, w - c.shape[-1])) for c in pieces]


def _cut(parts: list[Tensor], width: int, dtype: torch.dtype,
         dim: int = -1) -> Tensor:
    """The slices put back together along ``dim``, cut to ``width``, in
    ``dtype``, contiguous."""
    t = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return t.narrow(dim, 0, width).to(dtype).contiguous()


def _add(total: Tensor | None, part: Tensor) -> Tensor:
    """A running sum over slices, in f32 past the first part."""
    return part if total is None else total.float() + part.float()


def ssd_decomposed(scan, x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                   Cm: Tensor, D: Tensor, *, chunk: int,
                   return_state: bool = False):
    """The SSD scan at any P, N and chunk of at least 1 through ``scan``, a
    scan of the kernels' domain with ``ssd_scan_cuda``'s signature (the
    kernel's launch on the card, ``ref.ssd_scan_ref`` in the CPU tests):
    y, or (y, the f32 final state) with ``return_state``.

    Exact in arithmetic (only the order of sums changes): the scan runs at
    ``run_chunk(chunk)``; P and N are cut by ``width_slices``.  Zero
    columns of x give zero columns of y and zero rows of the state; zero
    columns of B and C add nothing.  Slices of P are scans of their own
    (D goes to each; y and the state's rows are concatenated).  The scan is
    linear in the pair (B, C) over slices of N, since C.B and C.h are sums
    over N whose state columns are independent: y = sum_s scan(x, dt, A,
    B_s, C_s, D_s) with D on the first slice and zero on the others (summed
    in f32), and the state's columns are concatenated.
    """
    p, n = x.shape[3], Bm.shape[3]
    kp, pw = width_slices(p)
    kn, nw = width_slices(n)
    q = run_chunk(chunk)
    if kp == kn == 1 and (pw, nw) == (p, n):
        return scan(x, dt, A, Bm, Cm, D, chunk=q, return_state=return_state)
    bs, cs = _cols(Bm, kn, nw), _cols(Cm, kn, nw)
    ds = [D] + [torch.zeros_like(D)] * (kn - 1)
    ys, states = [], []
    for xs in _cols(x, kp, pw):
        y, row = None, []
        for b_, c_, d_ in zip(bs, cs, ds):
            out = scan(xs, dt, A, b_, c_, d_, chunk=q,
                       return_state=return_state)
            y = _add(y, out[0] if return_state else out)
            row.append(out[1] if return_state else None)
        ys.append(y)
        if return_state:
            states.append(torch.cat(row, 3) if kn > 1 else row[0])
    y = _cut(ys, p, x.dtype)
    if not return_state:
        return y
    state = _cut(states, p, torch.float32, 2)
    return y, state[..., :n].contiguous()


def ssd_bwd_decomposed(bwd, x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                       Cm: Tensor, D: Tensor, dy: Tensor, *,
                       chunk: int) -> tuple[Tensor, ...]:
    """The gradient of ``ssd_decomposed`` through ``bwd``, a backward of
    the kernels' domain with ``ssd_scan_bwd_cuda``'s signature (the
    kernel's launches on the card, ``ref.ssd_scan_bwd_ref`` in the CPU
    tests): ``(dx, ddt, dA, dBm, dCm, dD)``.  Each run takes its slice of x
    and dy (zero-padded) and its slice of B and C with D (zero past the
    first N slice): dx is concatenated over P slices and summed over N
    slices; dB and dC concatenated over N slices and summed over P slices;
    ddt and dA summed over every run; dD (which does not depend on D) from
    the first N slice, summed over P slices.  Sums in f32."""
    p, n = x.shape[3], Bm.shape[3]
    kp, pw = width_slices(p)
    kn, nw = width_slices(n)
    q = run_chunk(chunk)
    if kp == kn == 1 and (pw, nw) == (p, n):
        return bwd(x, dt, A, Bm, Cm, D, dy, chunk=q)
    bs, cs = _cols(Bm, kn, nw), _cols(Cm, kn, nw)
    ds = [D] + [torch.zeros_like(D)] * (kn - 1)
    dxs, dbs, dcs = [], [None] * kn, [None] * kn
    ddt = dA = dD = None
    for xs, dys in zip(_cols(x, kp, pw), _cols(dy, kp, pw)):
        dx = None
        for i, (b_, c_, d_) in enumerate(zip(bs, cs, ds)):
            gx, gdt, gA, gB, gC, gD = bwd(xs, dt, A, b_, c_, d_, dys,
                                          chunk=q)
            dx, ddt, dA = _add(dx, gx), _add(ddt, gdt), _add(dA, gA)
            dbs[i], dcs[i] = _add(dbs[i], gB), _add(dcs[i], gC)
            if i == 0:
                dD = _add(dD, gD)
        dxs.append(dx)
    f32 = torch.float32
    return (_cut(dxs, p, x.dtype), ddt.to(f32), dA.to(f32),
            _cut(dbs, n, Bm.dtype), _cut(dcs, n, Cm.dtype), dD.to(f32))


kbuild.define_op("ssd_scan_fwd(Tensor x, Tensor dt, Tensor A, Tensor Bm, "
                 "Tensor Cm, Tensor D, int chunk, bool return_state) -> "
                 "(Tensor, Tensor)", _ssd_fwd_op)


@torch.library.register_fake("repro_torch::ssd_scan_fwd")
def _(x, dt, A, Bm, Cm, D, chunk, return_state):
    _plan(x, Bm, chunk)
    b, _, h, p = x.shape
    n = Bm.shape[3]
    return torch.empty_like(x, memory_format=torch.contiguous_format), \
        x.new_empty((b, h, p, n) if return_state else (0,),
                    dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _ssd_fwd_flops(x_shape, dt_shape, A_shape, Bm_shape, Cm_shape, D_shape,
                   chunk, *args, out_shape=None, **kwargs) -> int:
    return ssd_work(x_shape, Bm_shape[2], Bm_shape[3], chunk, 2)[0]


ssd_scan_cuda.launches = 0
ssd_scan_cuda.last_plan = None


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = kbuild.load(SRC_BWD, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [p] * 13 + [ctypes.POINTER(p)] + [i] * 10 \
        + [p]
    lib.ssd_scan_bwd.restype = i
    ip = ctypes.POINTER(i)
    lib.ssd_scan_bwd_geometry.argtypes = [i, i, i, i, i, ip, ip]
    lib.ssd_scan_bwd_geometry.restype = i
    return lib


def kernel_geometry_bwd(dtype: torch.dtype, p: int, n: int,
                        rows: int = 128) -> list[tuple[int, int]] | None:
    """(threads, dynamic shared-memory bytes) of each launch of the built
    backward library's instantiation for (dtype, p, n, tile rows), or None
    if it has none (builds the library)."""
    out = []
    variant = "wgmma" if dtype == torch.bfloat16 else "cuda_cores"
    for phase in range(len(BWD_PHASES[variant])):
        threads, smem = ctypes.c_int(), ctypes.c_int()
        if _bwd_library().ssd_scan_bwd_geometry(_DTYPES[dtype], p, n, rows,
                                                phase, threads, smem):
            return None
        out.append((threads.value, smem.value))
    return out


def ssd_scan_bwd_cuda(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                      Cm: Tensor, D: Tensor, dy: Tensor, *,
                      chunk: int = 128) -> tuple[Tensor, ...]:
    """The gradient of ``ssd_scan_cuda`` on the card for the output's
    gradient ``dy`` (x's shape and dtype): ``(dx, ddt, dA, dBm, dCm, dD)``,
    dx, dBm and dCm in x's dtype and contiguous, ddt, dA and dD in f32; the
    contract of ``ref.ssd_scan_bwd_ref``.

    Six launches on the current stream (``kernel_plan_bwd``) for each pair
    of its P and N slices (``ssd_bwd_decomposed``), no synchronisation; the
    inputs are read contiguous and 16-byte aligned (a copy is made of one
    that is not: bf16 reads them by TMA, f32 by cp.async).  Each call that launches adds one to
    ``ssd_scan_bwd_cuda.launches`` and leaves its plan in
    ``ssd_scan_bwd_cuda.last_plan``.
    """
    kbuild.refuse_autograd("ssd_scan_bwd_cuda", x=x, dt=dt, A=A, Bm=Bm,
                           Cm=Cm, D=D, dy=dy)
    _check(x, dt, A, Bm, Cm, D)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd_cuda: dy is {tuple(dy.shape)} "
                         f"{dy.dtype}, x {tuple(x.shape)} {x.dtype}")
    return torch.ops.repro_torch.ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy,
                                              int(chunk))


def _dense(t: Tensor) -> Tensor:
    """``t`` contiguous and 16-byte aligned, copied only if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ssd_bwd_op(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                D: Tensor, dy: Tensor, chunk: int) -> tuple[Tensor, ...]:
    """The backward's plan, checks and launches (``ssd_scan_bwd_cuda``
    checks the shapes first), through ``ssd_bwd_decomposed``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    plan = kernel_plan_bwd(b, s, h, p, g, n, chunk, x.dtype)
    _on_card("ssd_scan_bwd_cuda", (("x", x), ("dt", dt), ("A", A),
                                   ("Bm", Bm), ("Cm", Cm), ("D", D),
                                   ("dy", dy)))
    if x.numel() == 0:
        dense = torch.contiguous_format
        return (torch.zeros_like(x, memory_format=dense),
                dt.new_zeros((b, s, h)), A.new_zeros((h,)),
                torch.zeros_like(Bm, memory_format=dense),
                torch.zeros_like(Cm, memory_format=dense), A.new_zeros((h,)))
    out = ssd_bwd_decomposed(functools.partial(_launch_bwd, plan), x, dt, A,
                             Bm, Cm, D, dy, chunk=chunk)
    ssd_scan_bwd_cuda.launches += 1
    ssd_scan_bwd_cuda.last_plan = plan
    return out


def _launch_bwd(plan: dict, x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                Cm: Tensor, D: Tensor, dy: Tensor, *,
                chunk: int) -> tuple[Tensor, ...]:
    """The six launches for tensors in the kernels' domain (``plan``'s
    padded widths and run chunk)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    x, dt, A, Bm, Cm, D, dy = (_dense(t) for t in (x, dt, A, Bm, Cm, D, dy))
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    dA, dD = (torch.empty(h, dtype=torch.float32, device=x.device)
              for _ in range(2))
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    out = (dx, ddt, dA, dBm, dCm, dD)
    scratch = [torch.empty(shape, dtype=dtype, device=x.device)
               for shape, dtype in plan["scratch"].values()]
    ptrs = (ctypes.c_void_p * len(scratch))(*(t.data_ptr() for t in scratch))
    lib = _bwd_library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd(
            *(t.data_ptr() for t in (x, dt, A, Bm, Cm, D, dy) + out),
            ptrs, len(scratch), b, s, h, g, p, n, chunk, _DTYPES[x.dtype],
            plan.get("runs", 1), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _launch_failed("ssd_scan_bwd_cuda", err, x, Bm, chunk, plan)
    return out


kbuild.define_op("ssd_scan_bwd(Tensor x, Tensor dt, Tensor A, Tensor Bm, "
                 "Tensor Cm, Tensor D, Tensor dy, int chunk) -> (Tensor, "
                 "Tensor, Tensor, Tensor, Tensor, Tensor)", _ssd_bwd_op)


@torch.library.register_fake("repro_torch::ssd_scan_bwd")
def _(x, dt, A, Bm, Cm, D, dy, chunk):
    b, s, h, p = x.shape
    kernel_plan_bwd(b, s, h, p, Bm.shape[2], Bm.shape[3], chunk, x.dtype)
    dense = torch.contiguous_format
    return (torch.empty_like(x, memory_format=dense),
            x.new_empty((b, s, h), dtype=torch.float32),
            x.new_empty((h,), dtype=torch.float32),
            torch.empty_like(Bm, memory_format=dense),
            torch.empty_like(Cm, memory_format=dense),
            x.new_empty((h,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _ssd_bwd_flops(x_shape, dt_shape, A_shape, Bm_shape, Cm_shape, D_shape,
                   dy_shape, chunk, *args, out_shape=None, **kwargs) -> int:
    return ssd_bwd_work(x_shape, Bm_shape[2], Bm_shape[3], chunk, 2)[0]


ssd_scan_bwd_cuda.launches = 0
ssd_scan_bwd_cuda.last_plan = None


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient on the card: the kernel forward, the
    backward kernel (``ssd_scan_bwd_cuda``) from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        return ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)

    @staticmethod
    def backward(ctx, gy):
        grads = ssd_scan_bwd_cuda(*ctx.saved_tensors, gy, chunk=ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad[:6])), None)

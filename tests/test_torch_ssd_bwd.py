"""The SSD scan's backward, its plain version and its launch plan, on the CPU.

``ref.ssd_scan_bwd_ref`` (the chunked formulas the backward kernel computes,
written out in f32) is held against ``jax.grad`` of the JAX package's
sequential scan ``ssd_ref``, against ``jax.grad`` of its chunked scan
``ssd_chunked_ref`` on the leaves where that gradient is finite (the
reference exponentiates the whole ``[Q, Q]`` decay square, which overflows
above the diagonal once ``sum dt |A|`` over a chunk passes ~88), and against
autograd of the port's ``ssd_scan_ref``, on the same numpy inputs and output
gradient.  Tolerance: 1e-4 of each leaf's largest value (at least 1), as
``tests/test_torch_ssd.py`` holds gradients.  The CUDA kernel runs only on
a card: its tests are in ``test_torch_ssd_bwd_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

NAMES = ("x", "dt", "A", "Bm", "Cm", "D")
TOL = 1e-4

CASES = {
    # b, s, h, p, g, n, chunk, dt high, A
    "smoke": (2, 64, 8, 16, 1, 32, 32, 0.1, None),        # mamba2's smoke SSM
    "two groups": (1, 128, 4, 16, 2, 32, 64, 0.1, None),  # G 2 over H 4
    "ragged": (1, 96, 4, 16, 1, 32, 64, 0.1, None),       # S 96 at chunk 64
    "batch": (3, 128, 2, 32, 1, 16, 32, 0.1, None),       # B > 1
    "overflow": (1, 256, 2, 16, 1, 16, 128, None, [-16.0, -1.0]),
}


def _inputs(seed, b, s, h, p, g, n, dt_hi, A):
    """x, dt, A, Bm, Cm, D and the output's gradient as numpy f32, drawn as
    the reference's tests draw them; ``dt_hi`` None: dt = 0.1 everywhere."""
    rng = np.random.default_rng(seed)
    A = -rng.uniform(0.5, 2, h) if A is None else np.asarray(A)
    dt = (np.full((b, s, h), 0.1) if dt_hi is None
          else rng.uniform(0.001, dt_hi, (b, s, h)))
    arrays = (rng.standard_normal((b, s, h, p)) * 0.5, dt, A,
              rng.standard_normal((b, s, g, n)) * 0.3,
              rng.standard_normal((b, s, g, n)) * 0.3,
              rng.uniform(0, 1, h))
    dy = rng.standard_normal((b, s, h, p))
    return [a.astype(np.float32) for a in arrays], dy.astype(np.float32)


def _grads_close(got, want, names=NAMES):
    for name, a, w in zip(names, got, want):
        a, w = np.asarray(a), np.asarray(w)
        assert a.shape == w.shape, name
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(w).max()), 1.0)
        err = float(np.abs(a - w).max())
        assert err <= TOL * scale, (name, err, scale)


def _jax_grads(fn, arrays, dy):
    def f(*a):
        return jnp.sum(fn(*a) * dy)
    return jax.grad(f, tuple(range(6)))(*(jnp.asarray(a) for a in arrays))


def _padded(arrays, dy, chunk):
    """The inputs padded to a multiple of ``chunk`` with zero rows and
    ``dt = 0``, as the kernel pads them."""
    pad = (-dy.shape[1]) % chunk
    widen = [(0, 0), (0, pad)]
    return ([np.pad(a, widen + [(0, 0)] * (a.ndim - 2)) if a.ndim > 1 else a
             for a in arrays], np.pad(dy, widen + [(0, 0), (0, 0)]))


def _plain(arrays, dy, chunk):
    out = ref.ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in arrays),
                               torch.from_numpy(dy), chunk=chunk)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_sequential_scan(case):
    b, s, h, p, g, n, chunk, dt_hi, A = CASES[case]
    arrays, dy = _inputs(s + 7 * p + n, b, s, h, p, g, n, dt_hi, A)
    got = _plain(arrays, dy, chunk)
    _grads_close(got, _jax_grads(jref.ssd_ref, arrays, dy))


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_chunked_scan_where_finite(case):
    """The reference's training path (its gradient over the inputs padded
    as the kernel pads them, cut back to S), on every leaf whose gradient
    it gives finite; in the overflow case at least x, Bm, Cm and D."""
    b, s, h, p, g, n, chunk, dt_hi, A = CASES[case]
    arrays, dy = _inputs(s + 3 * p + n, b, s, h, p, g, n, dt_hi, A)
    got = _plain(arrays, dy, chunk)
    padded, dy_p = _padded(arrays, dy, chunk)
    want = _jax_grads(lambda *a: jref.ssd_chunked_ref(*a, chunk=chunk),
                      padded, dy_p)
    want = [np.asarray(w)[:, :s] if w.ndim > 1 else np.asarray(w)
            for w in want]
    finite = [i for i, w in enumerate(want) if np.isfinite(w).all()]
    assert {0, 3, 4, 5} <= set(finite)
    if case != "overflow":
        assert finite == list(range(6))
    _grads_close([got[i] for i in finite], [want[i] for i in finite],
                 [NAMES[i] for i in finite])


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_of_the_port(case):
    """Against autograd through ``ssd_scan_ref`` (the forward kernel's plain
    version), the route the card took before the backward kernel."""
    b, s, h, p, g, n, chunk, dt_hi, A = CASES[case]
    arrays, dy = _inputs(s + p + 5 * n, b, s, h, p, g, n, dt_hi, A)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = ref.ssd_scan_ref(*leaves, chunk=chunk)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    _grads_close(_plain(arrays, dy, chunk), [w.numpy() for w in want])


def test_plain_backward_keeps_the_input_dtypes():
    """bf16 x, Bm, Cm give bf16 dx, dBm, dCm; ddt, dA, dD stay f32; the
    values are the f32 gradient of the bf16 inputs, rounded once."""
    arrays, dy = _inputs(4, 1, 64, 2, 16, 1, 16, 0.1, None)
    t = [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(dy)]
    for i in (0, 3, 4, 6):
        t[i] = t[i].bfloat16()
    got = ref.ssd_scan_bwd_ref(*t, chunk=32)
    assert [x.dtype for x in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    f32 = ref.ssd_scan_bwd_ref(*(x.float() for x in t), chunk=32)
    for a, w in zip(got, f32):
        assert torch.equal(a, w.to(a.dtype))


def test_kernel_wrapper_refuses_cpu_tensors_and_autograd():
    """No fallback: the backward's wrapper raises rather than compute on
    the CPU, and rather than return gradients cut off from a graph."""
    arrays, dy = _inputs(11, 1, 64, 2, 16, 1, 16, 0.1, None)
    args = [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(dy)]
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssd.ssd_scan_bwd_cuda(*args, chunk=32)
    with pytest.raises(ValueError, match="dy is"):
        ssd.ssd_scan_bwd_cuda(*args[:6], args[6][:, :32], chunk=32)
    args[6].requires_grad_(True)
    with pytest.raises(RuntimeError, match="gradient of dy would be lost"):
        ssd.ssd_scan_bwd_cuda(*args, chunk=32)


def test_meta_tensors_trace_the_backward_op():
    """A meta tensor reaches the op's fake implementation: the gradients'
    shapes and dtypes, nothing launched or counted."""
    b, s, h, p, g, n = 2, 100, 4, 16, 2, 32
    meta = dict(device="meta")
    x = torch.empty(b, s, h, p, dtype=torch.bfloat16, **meta)
    bm = torch.empty(b, s, g, n, dtype=torch.bfloat16, **meta)
    f32 = [torch.empty(b, s, h, **meta), torch.empty(h, **meta)]
    launches = ssd.ssd_scan_bwd_cuda.launches
    out = ssd.ssd_scan_bwd_cuda(x, f32[0], f32[1], bm, bm, f32[1], x,
                                chunk=64)
    assert [(tuple(t.shape), t.dtype) for t in out] == [
        ((b, s, h, p), torch.bfloat16), ((b, s, h), torch.float32),
        ((h,), torch.float32), ((b, s, g, n), torch.bfloat16),
        ((b, s, g, n), torch.bfloat16), ((h,), torch.float32)]
    assert ssd.ssd_scan_bwd_cuda.launches == launches


def _bwd_phases(grids, smem, mma):
    names = ssd.BWD_PHASES
    threads = (128, 256, 128, 128, 128, 256)
    return [{"name": name, "grid": grid, "threads": t, "smem": m,
             "mma": mma if i in (0, 2, 3) else []}
            for i, (name, grid, t, m)
            in enumerate(zip(names, grids, threads, smem))]


def _rows(b, h, s):
    return ((b, h, s), torch.float32)


# Launch plans worked out by hand from csrc/ssd_scan_bwd.cu's layout: tiles
# of T whose rows are 16 bytes longer than their width (bf16: +8 columns,
# f32: +4); chunk states: a 32-row panel of x and one of B, then 4 floats a
# row of the longest chunk (512); dx/dB: the key panel's B and x, a query
# panel's C and dy, G [P][N + pad], M and dS [32][32 + pad]; dC the same
# with one [32][32 + pad]; both then 2 x 128 + 2 x 32 + 512 floats (3,328
# bytes).
PLANS_BWD = [
    # mamba2-130m's training shape: 16 chunks of 4 panels, 24 heads, batch
    # 8; a state pass of 8 blocks of 1,024 elements for each of 192 heads;
    # 524,288 quads of dB/dC in blocks of 256
    ((8, 2048, 24, 64, 1, 128, 128, torch.bfloat16), {
        "variant": "mma_sync",
        "phases": _bwd_phases(
            [(16, 24, 8), (192, 8, 1), (64, 24, 8), (64, 24, 8),
             (16, 24, 8), (2048, 2, 1)],
            [32 * (72 + 136) * 2 + 512 * 4,                        # 15,360
             0,
             (2 * 32 * (72 + 136) + 64 * 136 + 2 * 32 * 40) * 2
             + 3_328,                                              # 52,480
             (2 * 32 * (72 + 136) + 64 * 136 + 32 * 40) * 2
             + 3_328,                                              # 49,920
             0, 0],
            [(16, 8, 16)]),
        "scratch": {"cum": _rows(8, 24, 2048),
                    "state": ((8, 24, 16, 64, 128), torch.float32),
                    "state_grad": ((8, 24, 16, 64, 128), torch.float32),
                    "dB_heads": ((8, 2048, 24, 128), torch.float32),
                    "dC_heads": ((8, 2048, 24, 128), torch.float32),
                    "dcum_rows": _rows(8, 24, 2048),
                    "colsum": _rows(8, 24, 2048),
                    "dw": _rows(8, 24, 2048),
                    "dots": ((8, 24, 16, 64), torch.float32),
                    "dA_part": ((8, 24, 16), torch.float32),
                    "dD_part": ((8, 24, 64), torch.float32)},
        "scratch_bytes": 4 * (4 * 393_216 + 2 * 25_165_824
                              + 2 * 50_331_648 + 196_608 + 3_072
                              + 12_288)}),                 # 611,119,104
    # f32, ragged, two groups, chunk 96: 3 panels a chunk, 4 chunks
    ((2, 300, 8, 32, 2, 64, 96, torch.float32), {
        "variant": "cuda_cores",
        "phases": _bwd_phases(
            [(4, 8, 2), (16, 2, 1), (12, 8, 2), (12, 8, 2), (4, 8, 2),
             (75, 2, 1)],
            [32 * (36 + 68) * 4 + 512 * 4,                         # 15,360
             0,
             (2 * 32 * (36 + 68) + 32 * 68 + 2 * 32 * 36) * 4
             + 3_328,                                              # 47,872
             (2 * 32 * (36 + 68) + 32 * 68 + 32 * 36) * 4
             + 3_328,                                              # 43,264
             0, 0],
            []),
        "scratch": {"cum": _rows(2, 8, 384),
                    "state": ((2, 8, 4, 32, 64), torch.float32),
                    "state_grad": ((2, 8, 4, 32, 64), torch.float32),
                    "dB_heads": ((2, 300, 8, 64), torch.float32),
                    "dC_heads": ((2, 300, 8, 64), torch.float32),
                    "dcum_rows": _rows(2, 8, 384),
                    "colsum": _rows(2, 8, 384),
                    "dw": _rows(2, 8, 384),
                    "dots": ((2, 8, 4, 16), torch.float32),
                    "dA_part": ((2, 8, 4), torch.float32),
                    "dD_part": ((2, 8, 12), torch.float32)},
        "scratch_bytes": 4 * (4 * 6_144 + 2 * 131_072 + 2 * 307_200
                              + 1_024 + 64 + 192)}),       # 3,609,600
]


@pytest.mark.parametrize("shape,plan", PLANS_BWD, ids=("mamba2", "f32"))
def test_kernel_plan_bwd_literal(shape, plan):
    """Grids, threads, shared memory and scratch of the backward at the
    training shape and at a ragged f32 shape with two groups."""
    assert ssd.kernel_plan_bwd(*shape) == plan


@pytest.mark.parametrize("n", ssd.HEAD_DIMS)
@pytest.mark.parametrize("p", ssd.HEAD_DIMS)
def test_kernel_plan_bwd_variant_and_fit(p, n):
    """bf16 on the tensor cores (mma.sync m16n8k16), f32 on the CUDA cores;
    for every P, N and chunk, every launch within a block's shared memory
    and the panels tiling the chunk."""
    for chunk in (32, 64, 96, 128):
        for dtype, variant in ((torch.bfloat16, "mma_sync"),
                               (torch.float32, "cuda_cores")):
            plan = ssd.kernel_plan_bwd(1, 1000, 6, p, 3, n, chunk, dtype)
            assert plan["variant"] == variant
            nc = -(-1000 // chunk)
            assert plan["phases"][2]["grid"] == (nc * chunk // 32, 6, 1)
            for i, ph in enumerate(plan["phases"]):
                assert ph["smem"] <= 232_448 and ph["threads"] <= 1024
                tensor_cores = dtype == torch.bfloat16 and i in (0, 2, 3)
                assert ph["mma"] == ([(16, 8, 16)] if tensor_cores else [])


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 64, 2, 8, 1, 16, 32), torch.bfloat16, "head dim P=8"),
    ((1, 64, 2, 16, 1, 24, 32), torch.float32, "state dim N=24"),
    ((1, 64, 2, 16, 1, 16, 48), torch.bfloat16, "chunk 48"),
    ((1, 64, 2, 16, 1, 16, 160), torch.float32, "chunk 160"),
    ((1, 64, 2, 16, 1, 16, 32), torch.float16, "float16"),
    ((65536, 64, 2, 16, 1, 16, 32), torch.bfloat16, "exceed the grid"),
])
def test_kernel_plan_bwd_refuses_outside_the_domain(shape, dtype, match):
    """The forward's domain: the plan refuses the rest, and so does the
    wrapper on meta tensors (the shape is in the message)."""
    b, s, h, p, g, n, chunk = shape
    with pytest.raises(ValueError, match=match):
        ssd.kernel_plan_bwd(b, s, h, p, g, n, chunk, dtype)
    meta = dict(device="meta")
    x = torch.empty(b, s, h, p, dtype=dtype, **meta)
    bm = torch.empty(b, s, g, n, dtype=dtype, **meta)
    with pytest.raises(ValueError, match=match):
        ssd.ssd_scan_bwd_cuda(x, torch.empty(b, s, h, **meta),
                              torch.empty(h, **meta), bm, bm,
                              torch.empty(h, **meta), x, chunk=chunk)

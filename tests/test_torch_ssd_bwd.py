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


def _one(p, n, chunk):
    """The decomposition keys of a shape in the kernels' own domain: one
    launch at the asked chunk and widths."""
    return {"chunk": chunk, "p_slices": 1, "p_width": p, "n_slices": 1,
            "n_width": n, "launches": 1}


def _bwd_phases(variant, grids, threads, smem, mma):
    return [{"name": name, "grid": grid, "threads": t, "smem": m, "mma": k}
            for name, grid, t, m, k
            in zip(ssd.BWD_PHASES[variant], grids, threads, smem, mma)]


def _rows(b, h, s):
    return ((b, h, s), torch.float32)


F32_THREADS = (256, 256, 256, 256, 128, 256)

# Launch plans worked out by hand from csrc/ssd_scan_bwd.cu's layout.
# bf16 (tiles of 64-column boxes of bf16, 128 bytes a row; P and N padded
# to 64 or 128): chunk states, 1 KB of alignment + B and C (2 x Np x rows)
# + two stages of x and dy (4 x Pp x rows), all x 2 bytes, 3 mbarriers
# (24 bytes), 4 floats a row; dx / dS with a warpgroup per 64 key rows
# (kr of them), 1 KB + (B's kr rows + C's rows) x Np + two stages of x (kr
# rows), dy (rows) and G (Pp x Np), all x 2 bytes, 24, then (3 rows + 4
# warps a warpgroup x rows + 8) floats; dB / dC, 1 KB + C (Np x rows x 2)
# + the larger of two stages (Pp x rows + Np x Pp) x 2 x 2 and dS + B
# (rows x rows + Np x rows) x 2, 32 bytes of mbarriers, a float a row.
# f32: tiles of f32 whose rows are 16 bytes longer than their width (+4
# columns), "rows" the chunk rounded up to 64; chunk states: B's (or C's)
# rows and two stages of x's (or dy's), 3 floats a row; dx / dS: B's 64
# key rows, a stage of x's 64 key rows and dy's query rows (up to 128),
# then the larger of C's rows and G [P, N + 4] with M^T [64, rows + 4] and
# the second stage, then 2 floats a row, 64, 8 a row and 8; dB / dC: C's 64
# rows, the larger of the stages (64 rows of x or dy and G or h) and the
# closing tiles (the run's dS^T [rows, 68] and B's rows [rows, N + 4]), 64.
PLANS_BWD = [
    # mamba2-130m's training shape: 16 chunks of 128 rows, 24 heads of one
    # group, batch 8: 128 (chunk, group, b) blocks fill the 132 SMs, so
    # one run of 24 heads; two warpgroups over the key rows fit (one key
    # block); the chain: 8 blocks of 1,024 elements for each of 192 heads
    ((8, 2048, 24, 64, 1, 128, 128, torch.bfloat16), {
        **_one(64, 128, 128),
        "variant": "wgmma", "rows": 128, "runs": 1, "run_len": 24,
        "key_blocks": 1,
        "phases": _bwd_phases(
            "wgmma",
            [(16, 1, 8), (192, 8, 1), (16, 1, 8), (32, 1, 8), (16, 24, 8),
             (3, 1, 1)],
            (256, 256, 256, 256, 128, 256),
            [1024 + (2 * 128 + 4 * 64) * 128 * 2 + 24 + 4 * 128 * 4,
             0,                                                   # 134,168
             1024 + (128 * 128 + 128 * 128
                     + 2 * (64 * 128 + 64 * 128 + 128 * 64)) * 2
             + 24 + (3 * 128 + 4 * 2 * 128 + 8) * 4,              # 170,552
             1024 + 128 * 128 * 2 + 2 * (64 * 128 + 128 * 64) * 2
             + 32 + 128 * 4,                                      # 99,872
             0, 0],
            [[(64, 128, 16)], [], [(64, 64, 16), (64, 64, 16)],
             [(64, 128, 16)], [], []]),
        "scratch": {"cum": _rows(8, 24, 2048),
                    "state": ((8, 24, 16, 64, 128), torch.float32),
                    "state_grad": ((8, 24, 16, 64, 128), torch.float32),
                    "dots": ((8, 24, 16, 8), torch.float32),
                    "colsum": _rows(8, 24, 2048),
                    "dw": _rows(8, 24, 2048),
                    "dcum_rows": ((1, 8, 24, 2048), torch.float32),
                    "state_rows": _rows(8, 24, 2048),
                    "dS": ((1, 8, 16, 1, 128, 128), torch.bfloat16),
                    "dA_part": ((8, 24, 16), torch.float32),
                    "dD_part": ((8, 24, 16, 1), torch.float32)},
        "scratch_bytes": 4 * (5 * 393_216 + 2 * 25_165_824 + 24_576
                              + 2 * 3_072)
        + 2 * 2_097_152}),                                  # 213,508,096
    # jamba's state size and heads, one layer: 32 chunks of one group fill
    # 32 blocks, so its 128 heads go in 4 runs of 32 (128 blocks) whose dB
    # and dC parts the reduction adds up (grid y 1, 65,536 / 1,024 blocks)
    ((1, 4096, 128, 64, 1, 16, 128, torch.bfloat16), {
        **_one(64, 16, 128),
        "variant": "wgmma", "rows": 128, "runs": 4, "run_len": 32,
        "key_blocks": 1,
        "phases": _bwd_phases(
            "wgmma",
            [(32, 4, 1), (128, 1, 1), (32, 4, 1), (64, 4, 1), (32, 128, 1),
             (64, 2, 1)],
            (256, 256, 256, 256, 128, 256),
            [1024 + (2 * 64 + 4 * 64) * 128 * 2 + 24 + 4 * 128 * 4,
             0,                                                   # 101,400
             1024 + (64 * 128 + 64 * 128
                     + 2 * (64 * 128 + 64 * 128 + 64 * 64)) * 2
             + 24 + (3 * 128 + 4 * 2 * 128 + 8) * 4,              # 121,400
             1024 + 64 * 128 * 2 + (128 * 128 + 64 * 128) * 2
             + 32 + 128 * 4,                                      # 67,104
             0, 0],
            [[(64, 64, 16)], [], [(64, 64, 16), (64, 64, 16)],
             [(64, 64, 16)], [], []]),
        "scratch": {"cum": _rows(1, 128, 4096),
                    "state": ((1, 128, 32, 64, 16), torch.float32),
                    "state_grad": ((1, 128, 32, 64, 16), torch.float32),
                    "dots": ((1, 128, 32, 1), torch.float32),
                    "colsum": _rows(1, 128, 4096),
                    "dw": _rows(1, 128, 4096),
                    "dcum_rows": ((1, 1, 128, 4096), torch.float32),
                    "state_rows": _rows(1, 128, 4096),
                    "dS": ((4, 1, 32, 1, 128, 128), torch.bfloat16),
                    "dA_part": ((1, 128, 32), torch.float32),
                    "dD_part": ((1, 128, 32, 1), torch.float32),
                    "dBC_runs": ((2, 4, 1, 4096, 1, 16), torch.float32)},
        "scratch_bytes": 4 * (5 * 524_288 + 2 * 4_194_304 + 3 * 4_096
                              + 524_288)
        + 2 * 2_097_152}),                                  # 50,380,800
    # f32, ragged, two groups, chunk 96 (128-row tiles: two 64-row key
    # blocks in dx / dS, two 64-row blocks of dB and of dC a chunk): 4
    # chunks x 2 groups x 2 = 16 blocks, so each group's 4 heads go in 4
    # runs of one, whose dB and dC parts the reduction adds up
    ((2, 300, 8, 32, 2, 64, 96, torch.float32), {
        **_one(32, 64, 96),
        "variant": "cuda_cores", "rows": 128, "runs": 4, "run_len": 1,
        "key_blocks": 2,
        "phases": _bwd_phases(
            "cuda_cores",
            [(8, 8, 2), (16, 2, 1), (8, 8, 2), (16, 8, 2), (4, 8, 2),
             (75, 2, 1)],
            F32_THREADS,
            [4 * (128 * 68 + 2 * 128 * 36 + 384),                 # 73,216
             0,
             4 * (64 * 68 + 192 * 36 + 32 * 68 + 64 * 132 + 192 * 36
                  + 2 * 128 + 64 + 8 * 128 + 8),                  # 120,608
             4 * (64 * 68 + 128 * 68 + 128 * 68 + 64),            # 87,296
             0, 0],
            [[]] * 6),
        "scratch": {"cum": _rows(2, 8, 384),
                    "state": ((2, 8, 4, 32, 64), torch.float32),
                    "state_grad": ((2, 8, 4, 32, 64), torch.float32),
                    "dots": ((2, 8, 4, 2), torch.float32),
                    "colsum": _rows(2, 8, 384),
                    "dw": _rows(2, 8, 384),
                    "dcum_rows": ((2, 2, 8, 384), torch.float32),
                    "state_rows": _rows(2, 8, 384),
                    "dS": ((4, 2, 4, 2, 128, 128), torch.float32),
                    "dA_part": ((2, 8, 4), torch.float32),
                    "dD_part": ((2, 8, 4, 2), torch.float32),
                    "dBC_runs": ((2, 4, 2, 300, 2, 64), torch.float32)},
        "scratch_bytes": 4 * (6 * 6_144 + 2 * 131_072 + 128 + 64 + 128
                              + 1_048_576 + 614_400)}),   # 7,849,216
    # mamba2-130m trained in f32: one run of 24 heads, as bf16's; dx / dS
    # two stages of x [64, 68] and dy [128, 68] with G [64, 132] apart
    ((8, 2048, 24, 64, 1, 128, 128, torch.float32), {
        **_one(64, 128, 128),
        "variant": "cuda_cores", "rows": 128, "runs": 1, "run_len": 24,
        "key_blocks": 2,
        "phases": _bwd_phases(
            "cuda_cores",
            [(32, 1, 8), (192, 8, 1), (32, 1, 8), (64, 1, 8), (16, 24, 8),
             (3, 1, 1)],
            F32_THREADS,
            [4 * (128 * 132 + 2 * 128 * 68 + 384),                # 138,752
             0,
             4 * (64 * 132 + 192 * 68 + 64 * 132 + 64 * 132 + 192 * 68
                  + 2 * 128 + 64 + 8 * 128 + 8),                  # 211,232
             4 * (64 * 132 + 2 * (64 * 68 + 64 * 132) + 64),      # 136,448
             0, 0],
            [[]] * 6),
        "scratch": {"cum": _rows(8, 24, 2048),
                    "state": ((8, 24, 16, 64, 128), torch.float32),
                    "state_grad": ((8, 24, 16, 64, 128), torch.float32),
                    "dots": ((8, 24, 16, 8), torch.float32),
                    "colsum": _rows(8, 24, 2048),
                    "dw": _rows(8, 24, 2048),
                    "dcum_rows": ((2, 8, 24, 2048), torch.float32),
                    "state_rows": _rows(8, 24, 2048),
                    "dS": ((1, 8, 16, 1, 128, 128), torch.float32),
                    "dA_part": ((8, 24, 16), torch.float32),
                    "dD_part": ((8, 24, 16, 2), torch.float32)},
        "scratch_bytes": 4 * (6 * 393_216 + 2 * 25_165_824 + 24_576
                              + 3_072 + 6_144 + 2_097_152)}),
]


@pytest.mark.parametrize("shape,plan", PLANS_BWD,
                         ids=("mamba2", "jamba", "f32", "mamba2-f32"))
def test_kernel_plan_bwd_literal(shape, plan):
    """Grids, threads, shared memory, head runs and scratch of the
    backward at the training shape, at jamba's (heads split into runs), at
    a ragged f32 shape with two groups and at the training shape in f32."""
    assert ssd.kernel_plan_bwd(*shape) == plan


@pytest.mark.parametrize("n", ssd.HEAD_DIMS)
@pytest.mark.parametrize("p", ssd.HEAD_DIMS)
def test_kernel_plan_bwd_variant_and_fit(p, n):
    """bf16 on the tensor cores (wgmma m64 n{64, 128} k16 on P and N
    padded to 64 or 128), f32 on the CUDA cores; for every P, N and chunk,
    every launch within a block's shared memory, the key blocks of dx / dS
    covering the tile's rows (f32: 64-row key blocks, and dB / dC two
    64-row blocks of each a tile), both walking the same head runs."""
    for chunk in (32, 64, 96, 128):
        nc = -(-1000 // chunk)
        plan = ssd.kernel_plan_bwd(1, 1000, 6, p, 3, n, chunk,
                                   torch.bfloat16)
        pp, np_ = (64 if w <= 64 else 128 for w in (p, n))
        rows = 64 if chunk <= 64 else 128
        assert plan["variant"] == "wgmma" and plan["rows"] == rows
        blocks = plan["key_blocks"]
        assert plan["phases"][2]["threads"] * blocks == 2 * rows
        assert plan["phases"][2]["grid"] == (nc * blocks,
                                             3 * plan["runs"], 1)
        assert [ph["mma"] for ph in plan["phases"]] == [
            [(64, np_, 16)], [], [(64, pp, 16), (64, 64, 16)],
            [(64, np_, 16)], [], []]
        f32 = ssd.kernel_plan_bwd(1, 1000, 6, p, 3, n, chunk, torch.float32)
        assert f32["variant"] == "cuda_cores" and f32["rows"] == rows
        assert (f32["runs"], f32["run_len"]) == (plan["runs"],
                                                 plan["run_len"])
        assert f32["key_blocks"] == rows // 64
        assert f32["phases"][2]["grid"] == (nc * rows // 64,
                                            3 * f32["runs"], 1)
        assert f32["phases"][3]["grid"] == (2 * nc * rows // 64,
                                            3 * f32["runs"], 1)
        assert all(ph["mma"] == [] for ph in f32["phases"])
        for ph in plan["phases"] + f32["phases"]:
            assert ph["smem"] <= 232_448 and ph["threads"] <= 1024


@pytest.mark.parametrize("b,s,h,g,chunk,runs,run_len", [
    (8, 2048, 24, 1, 128, 1, 24),    # 128 blocks: one run
    (1, 4096, 128, 1, 128, 4, 32),   # 32 blocks: 4 runs
    (2, 1024, 10, 2, 128, 3, 2),     # 5 heads a group in runs of 2, 2, 1
    (4, 1024, 10, 1, 128, 4, 3),     # 10 heads in runs of 3, 3, 3, 1
    (1, 100, 3, 3, 32, 1, 1),        # a head a group
    (1, 64, 8, 1, 64, 8, 1),         # one block: a run a head
])
def test_head_runs(b, s, h, g, chunk, runs, run_len):
    """A group's heads split into as many runs as keep the blocks within
    the card's 132 SMs, every run non-empty, the last the shorter."""
    assert ssd.head_runs(b, s, h, g, chunk) == (runs, run_len)
    assert (runs - 1) * run_len < h // g <= runs * run_len


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (8, 2048, 24, 64, 1, 128, 128),     # mamba2-130m's training shape
    (1, 4096, 128, 64, 1, 16, 128),     # jamba's
    (2, 384, 8, 128, 4, 128, 128),      # P = N = 128: two key blocks
])
def test_kernel_plan_bwd_bf16_keeps_no_head_partials(shape, dtype):
    """Neither variant's scratch holds a ``[B, S, H, N]`` tensor (the heads
    of a group are summed in registers, not in device memory), and at the
    training shape it is at most 250 MB (f32: 403 MB less than the head
    partials of the kernel before)."""
    b, s, h, p, g, n, chunk = shape
    plan = ssd.kernel_plan_bwd(*shape, dtype)
    assert all(shape_ != (b, s, h, n)
               for shape_, _ in plan["scratch"].values())
    if shape[0] == 8:
        assert plan["scratch_bytes"] <= 250_000_000


@pytest.mark.parametrize("shape,dtype,want", [
    ((1, 64, 2, 8, 1, 16, 32), torch.bfloat16,
     {"p_width": 16, "p_slices": 1, "launches": 1}),
    ((1, 64, 2, 16, 1, 24, 32), torch.float32,
     {"n_width": 32, "n_slices": 1, "launches": 1}),
    ((1, 64, 2, 16, 1, 16, 48), torch.bfloat16, {"chunk": 64, "rows": 64}),
    ((1, 64, 2, 16, 1, 16, 160), torch.float32, {"chunk": 128, "rows": 128}),
    ((1, 64, 2, 16, 1, 16, 32), torch.float16, "float16"),
    ((65536, 64, 2, 16, 1, 16, 32), torch.bfloat16,
     {"grids": [(2, 65535, 2), (131072, 1, 1), (2, 65535, 2), (4, 65535, 2),
                (2, 65535, 3)]}),
    ((1, 64, 2, 16, 1, 0, 32), torch.bfloat16, "state dim N 0 is below 1"),
])
def test_kernel_plan_bwd_refuses_outside_the_domain(shape, dtype, want):
    """The forward's domain: P or N off the instantiations, a chunk off the
    multiples of 32 and a batch past the grid are taken (the plan reports
    its pads, slices, run chunk and folded grids: 65,536 x 1 run of the
    group's 2 heads, or 65,536 x 2 heads for dcum), and the wrapper on meta
    tensors gives the gradients' shapes; another dtype and an empty state
    dim stay refusals, in the plan and the wrapper."""
    b, s, h, p, g, n, chunk = shape
    meta = dict(device="meta")
    x = torch.empty(b, s, h, p, dtype=dtype, **meta)
    bm = torch.empty(b, s, g, n, dtype=dtype, **meta)
    args = (x, torch.empty(b, s, h, **meta), torch.empty(h, **meta), bm, bm,
            torch.empty(h, **meta), x)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            ssd.kernel_plan_bwd(b, s, h, p, g, n, chunk, dtype)
        with pytest.raises(ValueError, match=want):
            ssd.ssd_scan_bwd_cuda(*args, chunk=chunk)
        return
    plan = ssd.kernel_plan_bwd(b, s, h, p, g, n, chunk, dtype)
    grids = want.pop("grids", None)
    assert {k: plan[k] for k in want} == want
    if grids is not None:
        assert [ph["grid"] for ph in plan["phases"][:5]] == grids
    out = ssd.ssd_scan_bwd_cuda(*args, chunk=chunk)
    assert [tuple(t.shape) for t in out] == [
        (b, s, h, p), (b, s, h), (h,), (b, s, g, n), (b, s, g, n), (h,)]


# ssd_scan_pallas's corners that no instantiation takes as they are (as
# tests/test_torch_ssd.py's CORNERS): b, s, h, p, g, n, chunk
CORNERS = [
    (1, 300, 2, 16, 1, 16, 256),
    (1, 100, 2, 8, 1, 8, 48),
    (2, 200, 2, 48, 1, 24, 160),
    (1, 130, 4, 96, 2, 48, 100),
    (1, 40, 2, 16, 1, 16, 8),
    (1, 96, 2, 192, 1, 32, 64),
    (1, 96, 4, 32, 2, 256, 32),
    (1, 70, 2, 136, 1, 136, 48),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CORNERS)
def test_decomposed_backward_matches_jax_grad(b, s, h, p, g, n, chunk):
    """``ssd_bwd_decomposed`` over the plain backward (the card's route
    over the kernel: run chunk, P and N padded and sliced) against jax.grad
    of the JAX package's sequential scan, and against autograd of the
    port's plain forward at the asked chunk, within the file's 1e-4 of each
    leaf's largest value."""
    arrays, dy = _inputs(s + 3 * p + 7 * n, b, s, h, p, g, n, 0.1, None)
    got = ssd.ssd_bwd_decomposed(
        ref.ssd_scan_bwd_ref, *(torch.from_numpy(a) for a in arrays),
        torch.from_numpy(dy), chunk=chunk)
    got = [t.numpy() for t in got]
    _grads_close(got, _jax_grads(jref.ssd_ref, arrays, dy))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    want = torch.autograd.grad(ref.ssd_scan_ref(*leaves, chunk=chunk),
                               leaves, torch.from_numpy(dy))
    _grads_close(got, [w.numpy() for w in want])

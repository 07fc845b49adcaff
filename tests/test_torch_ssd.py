"""The port's SSD scan against the JAX package's, on the CPU.

The port's plain versions (``ref.ssd_ref``, ``ref.ssd_chunked_ref`` with its
final state, ``ref.ssd_scan_ref``) are held against the JAX ``ref``
functions and the Pallas kernel ``ssd_scan_pallas`` in interpret mode, on
the same numpy inputs, within 2e-4: the tolerance of the reference's kernel
tests (``tests/test_kernels.py``; the chunked and sequential forms add in
different orders).  Gradients are held to 1e-4 of each leaf's largest
value.  The CUDA kernel runs only on a card: its tests are in
``test_torch_ssd_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

TOL = 2e-4
NAMES = ("x", "dt", "A", "Bm", "Cm", "D")


def _inputs(seed, b, s, h, p, g, n, dt_lo=0.001, dt_hi=0.1, A=None):
    """x, dt, A, Bm, Cm, D as numpy f32, drawn as the reference's tests
    draw them."""
    rng = np.random.default_rng(seed)
    A = -rng.uniform(0.5, 2, h) if A is None else np.asarray(A)
    arrays = (rng.standard_normal((b, s, h, p)) * 0.5,
              rng.uniform(dt_lo, dt_hi, (b, s, h)), A,
              rng.standard_normal((b, s, g, n)) * 0.3,
              rng.standard_normal((b, s, g, n)) * 0.3,
              rng.uniform(0, 1, h))
    return [a.astype(np.float32) for a in arrays]


def _port(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(out, want, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _grads_close(got, want, tol=1e-4):
    for name, a, w in zip(NAMES, got, want):
        a, w = a.numpy(), np.asarray(w)
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(a - w).max()) <= tol * scale, name


SHAPES = [
    # b, s, h, p, g, n, chunk: the reference's kernel-test shapes, and a
    # sequence that is not a multiple of the chunk
    (1, 64, 2, 16, 1, 16, 32),
    (2, 128, 4, 32, 2, 32, 64),
    (1, 96, 2, 16, 1, 32, 32),
    (1, 200, 2, 16, 1, 16, 128),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_plain_versions_match_jax_ref(b, s, h, p, g, n, chunk):
    arrays = _inputs(s * 13 + n, b, s, h, p, g, n)
    _close(ref.ssd_ref(*_port(arrays)), jref.ssd_ref(*_jax(arrays)))
    if s % chunk == 0:
        _close(ref.ssd_chunked_ref(*_port(arrays), chunk=chunk),
               jref.ssd_chunked_ref(*_jax(arrays), chunk=chunk))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_scan_matches_pallas_interpret(b, s, h, p, g, n, chunk):
    """``ssd_scan_ref`` (what the CUDA kernel computes) and ``ops.ssd_scan``
    on the CPU against the Pallas kernel, padding included."""
    arrays = _inputs(s * 7 + p, b, s, h, p, g, n)
    want = ssd_scan_pallas(*_jax(arrays), chunk=chunk, interpret=True)
    _close(ref.ssd_scan_ref(*_port(arrays), chunk=chunk), want)
    _close(ops.ssd_scan(*_port(arrays), chunk=chunk), want)


def test_chunked_final_state_matches_jax():
    arrays = _inputs(3, 2, 128, 4, 8, 2, 16)
    y, state = ref.ssd_chunked_ref(*_port(arrays), chunk=32,
                                   return_state=True)
    jy, jstate = jref.ssd_chunked_ref(*_jax(arrays), chunk=32,
                                      return_state=True)
    _close(y, jy)
    _close(state, jstate)
    # and the sequential scan's state: the last row's y, with D = 0, is C h
    arrays[5][:] = 0.0
    _, state = ref.ssd_chunked_ref(*_port(arrays), chunk=32,
                                   return_state=True)
    Ch = np.repeat(arrays[4][:, -1], 2, axis=1)               # [B, H, N]
    last = np.einsum("bhpn,bhn->bhp", state.numpy(), Ch)
    np.testing.assert_allclose(last, ref.ssd_ref(*_port(arrays))[:, -1],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_ops_final_state_matches_jax(b, s, h, p, g, n, chunk):
    """``ops.ssd_scan(return_state=True)`` on the CPU (the prefill's route):
    y as ``ssd_scan_ref``, and the state exactly the port's chunked
    version's over the inputs padded with ``dt = 0`` and within 2e-4 of the
    JAX package's (its ``ssm_prefill`` pads the same way)."""
    arrays = _inputs(s + 11 * p, b, s, h, p, g, n)
    y, state = ops.ssd_scan(*_port(arrays), chunk=chunk, return_state=True)
    pad = (-s) % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in arrays]
    want_y, want = ref.ssd_chunked_ref(*_port(padded), chunk=chunk,
                                       return_state=True)
    assert torch.equal(y, want_y[:, :s]) and torch.equal(state, want)
    assert torch.equal(y, ref.ssd_scan_ref(*_port(arrays), chunk=chunk))
    jy, jstate = jref.ssd_chunked_ref(*_jax(padded), chunk=chunk,
                                      return_state=True)
    _close(y, jy[:, :s])
    _close(state, jstate)


def test_chunked_ref_refuses_a_ragged_sequence():
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_chunked_ref(*_port(_inputs(0, 1, 40, 2, 16, 1, 16)), chunk=32)


def test_gradient_is_finite_where_the_masked_exp_overflows():
    """dt = 0.1 and |A| = 16 over a chunk of 128: sum dt |A| reaches ~200,
    and exp(cum_i - cum_j) above the diagonal overflows.  The port masks
    before the exponential, so its gradient is finite, and it equals
    jax.grad of the sequential scan (which never forms those entries) and,
    for the leaves where JAX's own chunked gradient is finite, that one."""
    arrays = _inputs(5, 1, 256, 2, 16, 1, 16, dt_lo=0.1, dt_hi=0.1,
                     A=[-16.0, -1.0])
    leaves = _port(arrays, grad=True)
    got = torch.autograd.grad(ref.ssd_chunked_ref(*leaves, chunk=128).sum(),
                              leaves)
    argnums = tuple(range(6))
    seq = jax.grad(lambda *a: jref.ssd_ref(*a).sum(), argnums)(*_jax(arrays))
    _grads_close(got, seq)
    chunked = jax.grad(lambda *a: jref.ssd_chunked_ref(*a, chunk=128).sum(),
                       argnums)(*_jax(arrays))
    finite = [i for i, g in enumerate(chunked) if np.isfinite(g).all()]
    assert {0, 3, 4, 5} <= set(finite)
    _grads_close([got[i] for i in finite], [chunked[i] for i in finite])


def _jax_grads(arrays, gy, chunk):
    def f(*a):
        return jnp.sum(jref.ssd_chunked_ref(*a, chunk=chunk) * gy)
    return jax.grad(f, tuple(range(6)))(*_jax(arrays))


def test_ops_gradient_on_the_cpu_matches_jax():
    """The CPU route (autograd through the plain version) against jax.grad
    of the reference's chunked scan, its training path."""
    arrays = _inputs(6, 2, 128, 4, 16, 2, 32)
    gy = np.random.default_rng(7).standard_normal((2, 128, 4, 16)).astype(
        np.float32)
    leaves = _port(arrays, grad=True)
    y = ops.ssd_scan(*leaves, chunk=64)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    _grads_close(got, _jax_grads(arrays, gy, 64))


def test_ssdscan_backward_matches_jax(monkeypatch):
    """``SSDScan`` (the card's route) run on the CPU, with the forward and
    the backward kernel replaced by their plain versions
    (``ref.ssd_scan_ref``, ``ref.ssd_scan_bwd_ref``): its gradients against
    jax.grad.  Both kernels run with autograd off, as their wrappers
    require."""
    grad_mode = []

    def kernel_stand_in(*args, chunk):
        grad_mode.append(torch.is_grad_enabled())
        return ref.ssd_scan_ref(*args, chunk=chunk)

    def bwd_stand_in(*args, chunk):
        grad_mode.append(torch.is_grad_enabled())
        return ref.ssd_scan_bwd_ref(*args, chunk=chunk)

    monkeypatch.setattr(ssd, "ssd_scan_cuda", kernel_stand_in)
    monkeypatch.setattr(ssd, "ssd_scan_bwd_cuda", bwd_stand_in)
    arrays = _inputs(8, 1, 96, 4, 16, 1, 32)
    gy = np.random.default_rng(9).standard_normal((1, 96, 4, 16)).astype(
        np.float32)
    leaves = _port(arrays, grad=True)
    y = ssd.SSDScan.apply(*leaves, 64)      # S = 96: ragged for chunk 64
    assert grad_mode == [False] and y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    assert grad_mode == [False, False]
    padded = [np.pad(a, [(0, 0), (0, 32)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in arrays]
    want = _jax_grads(padded, np.pad(gy, [(0, 0), (0, 32), (0, 0), (0, 0)]),
                      64)
    want = [w[:, :96] if w.ndim > 1 else w for w in want]
    _grads_close(got, want)
    # only the inputs that need a gradient get one
    part = [leaves[0]] + [t.detach() for t in leaves[1:]]
    (gx,) = torch.autograd.grad(ssd.SSDScan.apply(*part, 64), [part[0]],
                                torch.from_numpy(gy))
    _grads_close([gx], want[:1])


def test_cpu_tensors_route_to_the_plain_version():
    args = _port(_inputs(10, 1, 64, 2, 16, 1, 16))
    launches = ssd.ssd_scan_cuda.launches
    out = ops.ssd_scan(*args, chunk=32)
    assert torch.equal(out, ref.ssd_scan_ref(*args, chunk=32))
    assert ssd.ssd_scan_cuda.launches == launches
    # a meta tensor traces the card's program: the kernel's op gives the
    # output's shape and nothing is launched
    out = ops.ssd_scan(*[a.to("meta") for a in args], chunk=32)
    assert out.device.type == "meta" and out.shape == args[0].shape
    assert ssd.ssd_scan_cuda.launches == launches


def test_kernel_wrapper_refuses_cpu_tensors_and_autograd():
    """No fallback: the CUDA wrapper raises rather than compute on the CPU,
    and rather than return a result cut off from the graph."""
    args = _port(_inputs(11, 1, 64, 2, 16, 1, 16))
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssd.ssd_scan_cuda(*args)
    args[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="gradient of Bm would be lost"):
        ssd.ssd_scan_cuda(*args)


# Launch plans, worked out by hand from the layout of csrc/ssd_scan.cu.
# bf16 chunk state: 1,024 bytes to align the swizzled boxes, the x and B
# boxes (64 columns = 128 bytes a row, rows = the chunk rounded up to 64),
# 8 for the mbarrier, 3 floats a row (dt, cum, w); chunk scan: 1,024, the
# C, B and x boxes, h_in's boxes of P-padded-to-64 rows, 8, 2 floats a row.
# f32 (tiles of f32 rows 16 bytes longer than their width, "rows" the chunk
# rounded up to 64): chunk state, B's rows [rows, N + 4], two stages of x
# [rows, P + 4], 3 floats a row; chunk scan, with pt = min(P, 64) columns
# of y a block, C's 64 rows [64, N + 4], h_in's [pt, N + 4], x's first
# stage [rows, pt + 4], then the larger of B's rows [rows, N + 4] and W
# [64, rows + 4] with x's second stage, then 2 floats a row.
def _one(p, n, chunk):
    """The decomposition keys of a shape in the kernels' own domain: one
    launch at the asked chunk and widths."""
    return {"chunk": chunk, "p_slices": 1, "p_width": p, "n_slices": 1,
            "n_width": n, "launches": 1}


def _phases(state, scan, rows_grid, pass_grid):
    return [
        {"name": "ssd_fwd_chunk_state", "grid": rows_grid, "threads": 128,
         "smem": state[0], "mma": state[1]},
        {"name": "ssd_fwd_state_pass", "grid": pass_grid, "threads": 256,
         "smem": 0, "mma": []},
        {"name": "ssd_fwd_chunk_scan", "grid": rows_grid,
         "threads": scan[2], "smem": scan[0], "mma": scan[1]},
    ]


def _f32_phases(grids, state, scan):
    return [{"name": name, "grid": grid, "threads": 256, "smem": 4 * smem,
             "mma": []}
            for name, grid, smem in zip(
                ("ssd_fwd_chunk_state_cc", "ssd_fwd_state_pass",
                 "ssd_fwd_chunk_scan_cc"), grids, (state, 0, scan))]


PLANS = [
    # mamba2-130m's training shape: 16 chunks x 24 heads x 8; state pass
    # 8 blocks of 1,024 state elements for each of 192 heads
    ((8, 2048, 24, 64, 1, 128, 128, torch.bfloat16), {
        **_one(64, 128, 128),
        "variant": "wgmma", "rows": 128,
        "phases": _phases(
            (1_024 + 16_384 * 3 + 8 + 1_536, [(64, 128, 16)]),     # 51,720
            (1_024 + 16_384 * 5 + 8_192 * 2 + 8 + 1_024,           # 100,360
             [(64, 128, 16), (64, 64, 16)], 256),
            (16, 24, 8), (192, 8, 1)),
        "scratch": {"cum": ((8, 24, 2048), torch.float32),
                    "state": ((8, 24, 16, 64, 128), torch.float32),
                    "h_in": ((8, 24, 16, 64, 128), torch.bfloat16)},
        "scratch_bytes": 1_572_864 + 100_663_296 + 50_331_648}),
    # jamba-shaped: N = 16 pads to one 64-column box
    ((1, 4096, 128, 64, 1, 16, 128, torch.bfloat16), {
        **_one(64, 16, 128),
        "variant": "wgmma", "rows": 128,
        "phases": _phases(
            (1_024 + 16_384 * 2 + 8 + 1_536, [(64, 64, 16)]),      # 35,336
            (1_024 + 16_384 * 3 + 8_192 + 8 + 1_024,               # 59,400
             [(64, 128, 16), (64, 64, 16)], 256),
            (32, 128, 1), (128, 1, 1)),
        "scratch": {"cum": ((1, 128, 4096), torch.float32),
                    "state": ((1, 128, 32, 64, 16), torch.float32),
                    "h_in": ((1, 128, 32, 64, 16), torch.bfloat16)},
        "scratch_bytes": 2_097_152 + 16_777_216 + 8_388_608}),
    # chunk 32 in 64-row tiles, one warpgroup in the chunk scan
    ((1, 256, 4, 64, 1, 128, 32, torch.bfloat16), {
        **_one(64, 128, 32),
        "variant": "wgmma", "rows": 64,
        "phases": _phases(
            (1_024 + 8_192 * 3 + 8 + 768, [(64, 128, 16)]),        # 26,376
            (1_024 + 8_192 * 5 + 8_192 * 2 + 8 + 512,              # 58,888
             [(64, 64, 16), (64, 64, 16)], 128),
            (8, 4, 1), (4, 8, 1)),
        "scratch": {"cum": ((1, 4, 256), torch.float32),
                    "state": ((1, 4, 8, 64, 128), torch.float32),
                    "h_in": ((1, 4, 8, 64, 128), torch.bfloat16)},
        "scratch_bytes": 4_096 + 1_048_576 + 524_288}),
    # f32 ragged, two groups: 3 chunks x 2 groups x 2 = 12 blocks, so each
    # group's 4 heads go in 4 runs of one (48 blocks; 96 in the scan, its
    # two 64-row halves a chunk)
    ((2, 300, 8, 32, 2, 64, 128, torch.float32), {
        **_one(32, 64, 128),
        "variant": "cuda_cores", "rows": 128, "runs": 4, "run_len": 1,
        "phases": _f32_phases(
            [(3, 8, 2), (16, 2, 1), (6, 8, 2)],
            128 * 68 + 2 * 128 * 36 + 384,                         # 18,304
            64 * 68 + 32 * 68 + 128 * 36 + 64 * 132 + 128 * 36
            + 256),                                                # 24,448
        "scratch": {"cum": ((2, 8, 384), torch.float32),
                    "state": ((2, 8, 3, 32, 64), torch.float32)},
        "scratch_bytes": 4 * (6_144 + 98_304)}),
    # mamba2-130m trained in f32: 128 (chunk, b) blocks fill the card, so
    # one run of all 24 heads; the scan's late room is W [64, 132] and x's
    # second stage [128, 68] (B's [128, 132] is smaller)
    ((8, 2048, 24, 64, 1, 128, 128, torch.float32), {
        **_one(64, 128, 128),
        "variant": "cuda_cores", "rows": 128, "runs": 1, "run_len": 24,
        "phases": _f32_phases(
            [(16, 1, 8), (192, 8, 1), (32, 1, 8)],
            128 * 132 + 2 * 128 * 68 + 384,                        # 34,688
            64 * 132 + 64 * 132 + 128 * 68 + 64 * 132 + 128 * 68
            + 256),                                                # 43,008
        "scratch": {"cum": ((8, 24, 2048), torch.float32),
                    "state": ((8, 24, 16, 64, 128), torch.float32)},
        "scratch_bytes": 4 * (393_216 + 25_165_824)}),
    # jamba's layer in f32 (phase 7): 3 chunks, so 128 heads in 43 runs of
    # 3 (the last of 2): 129 blocks, 258 in the scan
    ((1, 300, 128, 64, 1, 16, 128, torch.float32), {
        **_one(64, 16, 128),
        "variant": "cuda_cores", "rows": 128, "runs": 43, "run_len": 3,
        "phases": _f32_phases(
            [(3, 43, 1), (128, 1, 1), (6, 43, 1)],
            128 * 20 + 2 * 128 * 68 + 384,                         # 20,352
            64 * 20 + 64 * 20 + 128 * 68 + 64 * 132 + 128 * 68
            + 256),                                                # 28,672
        "scratch": {"cum": ((1, 128, 384), torch.float32),
                    "state": ((1, 128, 3, 64, 16), torch.float32)},
        "scratch_bytes": 4 * (49_152 + 393_216)}),
    # f32, two groups of 6 heads in 3 runs of 2, chunk 64 (64-row tiles),
    # P = 128: y's two 64-column halves are two blocks of the scan
    ((2, 512, 12, 128, 2, 32, 64, torch.float32), {
        **_one(128, 32, 64),
        "variant": "cuda_cores", "rows": 64, "runs": 3, "run_len": 2,
        "phases": _f32_phases(
            [(8, 6, 2), (24, 4, 1), (16, 6, 2)],
            64 * 36 + 2 * 64 * 132 + 192,                          # 19,392
            64 * 36 + 64 * 36 + 64 * 68 + 64 * 68 + 64 * 68
            + 128),                                                # 17,792
        "scratch": {"cum": ((2, 12, 512), torch.float32),
                    "state": ((2, 12, 8, 128, 32), torch.float32)},
        "scratch_bytes": 4 * (12_288 + 786_432)}),
]


@pytest.mark.parametrize("shape,plan", PLANS, ids=lambda v: str(v)[:40])
def test_kernel_plan_literal(shape, plan):
    """Grids, threads, shared memory, head runs and scratch at the training
    shape, a jamba-shaped one and 32-row chunks in bf16; in f32 at the
    ragged shape, mamba2's and jamba's, and two groups in runs of 2."""
    assert ssd.kernel_plan(*shape) == plan


@pytest.mark.parametrize("p", ssd.HEAD_DIMS)
def test_kernel_plan_variant_by_dtype(p):
    """bf16 on the tensor cores, f32 on the CUDA cores: no other choice."""
    for dtype, variant in ((torch.bfloat16, "wgmma"),
                           (torch.float32, "cuda_cores")):
        plan = ssd.kernel_plan(2, 512, 8, p, 1, 64, 128, dtype)
        assert plan["variant"] == variant


@pytest.mark.parametrize("n", ssd.HEAD_DIMS)
@pytest.mark.parametrize("p", ssd.HEAD_DIMS)
def test_kernel_plan_tiles_fit_wgmma_and_the_card(p, n):
    """For every P and N and every chunk: bf16 tiles of 64 or 128 rows that
    hold the chunk, every product m64 n{64, 128} k16 (the instantiated
    wgmma shapes), a warpgroup per 64 rows in the chunk scan, and every
    phase's shared memory within a block's 232,448 bytes."""
    for chunk in (32, 64, 96, 128):
        plan = ssd.kernel_plan(1, 1000, 6, p, 3, n, chunk, torch.bfloat16)
        rows = plan["rows"]
        assert rows in (64, 128) and chunk <= rows < chunk + 64
        assert plan["phases"][2]["threads"] == 2 * rows
        for ph in plan["phases"]:
            assert ph["smem"] <= 232_448 and ph["threads"] <= 1024
            for m, width, k in ph["mma"]:
                assert (m, k) == (64, 16) and width in (64, 128)
        f32 = ssd.kernel_plan(1, 1000, 6, p, 3, n, chunk, torch.float32)
        assert f32["phases"][0]["smem"] <= 232_448


@pytest.mark.parametrize("shape,dtype,want", [
    # P 8 pads to 16; N 24 pads to 32; chunk 48 runs at 64
    ((1, 64, 2, 8, 1, 16, 32), torch.bfloat16,
     {"p_width": 16, "p_slices": 1, "launches": 1}),
    ((1, 64, 2, 16, 1, 24, 32), torch.float32,
     {"n_width": 32, "n_slices": 1, "launches": 1}),
    ((1, 64, 2, 16, 1, 16, 48), torch.bfloat16, {"chunk": 64, "rows": 64}),
    # a batch past the grid's z: (2 heads x 65,536) pairs folded on y, z
    ((65536, 64, 2, 16, 1, 16, 32), torch.bfloat16,
     {"grid": (2, 65535, 3)}),
    ((1, 64, 2, 16, 1, 16, 32), torch.float16, "float16"),
    ((1, 64, 2, 16, 1, 16, 0), torch.float32, "chunk 0 is below 1"),
])
def test_kernel_wrapper_raises_on_what_the_plan_refuses(shape, dtype, want):
    """What was outside the instantiations (P or N off (16, 32, 64, 128), a
    chunk off the multiples of 32, a batch past the grid) the plan now
    takes and reports: its pads, slices, run chunk and folded grid; the
    wrapper on meta tensors (no memory) gives the output's shape.  Another
    dtype and an empty chunk stay refusals, before any device is looked
    at."""
    b, s, h, p, g, n, chunk = shape
    meta = dict(device="meta")
    args = (torch.empty(b, s, h, p, dtype=dtype, **meta),
            torch.empty(b, s, h, **meta), torch.empty(h, **meta),
            torch.empty(b, s, g, n, dtype=dtype, **meta),
            torch.empty(b, s, g, n, dtype=dtype, **meta),
            torch.empty(h, **meta))
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            ssd.kernel_plan(b, s, h, p, g, n, chunk, dtype)
        with pytest.raises(ValueError, match=want):
            ssd.ssd_scan_cuda(*args, chunk=chunk)
        return
    plan = ssd.kernel_plan(b, s, h, p, g, n, chunk, dtype)
    grid = want.pop("grid", None)
    assert {k: plan[k] for k in want} == want
    if grid is not None:
        assert plan["phases"][0]["grid"] == grid
        assert plan["phases"][2]["grid"] == grid
    y = ssd.ssd_scan_cuda(*args, chunk=chunk)
    assert y.shape == (b, s, h, p) and y.dtype == dtype


# The corners of ssd_scan_pallas's domain that no instantiation takes as
# they are: b, s, h, p, g, n, chunk.  mamba_ssm's default chunk of 256;
# chunks 48, 160, 100 and 8; P 8, 48, 96 and 192 (past 128: two slices);
# N 8, 24, 48 and 256 (two slices); P and N past 128 together.
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
def test_decomposition_matches_pallas_at_the_asked_chunk(b, s, h, p, g, n,
                                                         chunk):
    """``ssd_decomposed`` over the plain version (what the card runs over
    the kernel: the run chunk, P and N padded and sliced) against the
    Pallas kernel in interpret mode at the asked chunk, and its final state
    against the JAX package's chunked scan over the inputs padded to that
    chunk with ``dt = 0``, within the file's 2e-4."""
    arrays = _inputs(s * 5 + p + n, b, s, h, p, g, n)
    y, state = ssd.ssd_decomposed(ref.ssd_scan_ref, *_port(arrays),
                                  chunk=chunk, return_state=True)
    _close(y, ssd_scan_pallas(*_jax(arrays), chunk=chunk, interpret=True))
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    pad = (-s) % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in arrays]
    _close(state, jref.ssd_chunked_ref(*_jax(padded), chunk=chunk,
                                       return_state=True)[1])
    assert torch.equal(ssd.ssd_decomposed(ref.ssd_scan_ref, *_port(arrays),
                                          chunk=chunk), y)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CORNERS)
def test_kernel_plan_reports_the_decomposition(b, s, h, p, g, n, chunk):
    """Every corner plans in both dtypes: the run chunk (the smallest
    multiple of 32 at or above the asked one, at most 128), the padded
    widths and slice counts of P and N, one launch a pair of slices, and
    phases in the instantiations' domain."""
    for dtype in (torch.bfloat16, torch.float32):
        for plan in (ssd.kernel_plan(b, s, h, p, g, n, chunk, dtype),
                     ssd.kernel_plan_bwd(b, s, h, p, g, n, chunk, dtype)):
            assert plan["chunk"] == min(128, -(-chunk // 32) * 32)
            for w, k, pad in ((p, plan["p_slices"], plan["p_width"]),
                              (n, plan["n_slices"], plan["n_width"])):
                assert pad in ssd.HEAD_DIMS and k * pad >= w
                assert k == (1 if w <= 128 else -(-w // 128))
                assert k > 1 or pad == 16 or pad < 2 * w   # the least
            assert plan["launches"] == plan["p_slices"] * plan["n_slices"]
            for ph in plan["phases"]:
                assert ph["smem"] <= 232_448 and max(ph["grid"][1:]) <= 65535


@pytest.mark.parametrize("b,h", [(66_000, 2), (1, 66_000), (66_000, 64)])
def test_kernel_plans_fold_batch_and_heads_past_the_grid(b, h):
    """A batch or a head count of 66,000: every grid's y and z within
    65,535 and covering every (batch, head or run) pair, forward and
    backward, both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        for plan in (ssd.kernel_plan(b, 64, h, 16, 1, 16, 32, dtype),
                     ssd.kernel_plan_bwd(b, 64, h, 16, 1, 16, 32, dtype)):
            for ph in plan["phases"]:
                gx, gy, gz = ph["grid"]
                assert gy <= 65535 and gz <= 65535 and gx < 2**31
            heads = plan["phases"][0]["grid"]
            per = plan.get("runs", h)     # one group: its runs, or heads
            assert heads[1] * heads[2] >= b * per

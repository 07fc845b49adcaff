"""The port's CUDA SSD-scan kernel against its plain version, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

Tolerances: 2e-4 in f32, the reference's kernel tolerance
(``tests/test_kernels.py``: the kernel adds in another order than the plain
version); 2e-2 in bf16, where x, B, C and y round to 8 bits of mantissa.
Gradients through ``SSDScan`` come from the f32 backward kernel
(``csrc/ssd_scan_bwd.cu``; its own tests are in
``test_torch_ssd_bwd_cuda.py``), held to autograd through the plain
version within 1e-4 of each leaf's largest value.

bf16 runs the three tensor-core phases (plan variant ``"wgmma"``), f32 the
three CUDA-core phases (``"cuda_cores"``); each case checks which one
launched.
The bf16 phases also round W, the scaled B rows and the carried state to
bf16 before their products, so besides the elementwise 2e-2 each bf16 case
holds the relative error of the whole output, ``|out - want|_F /
|want|_F``, and of its worst ``(b, h)`` slice under ``REL_TOL`` and
``SLICE_TOL``: ~1.8x the most the sound kernel gave on an H100 over these
cases and chip_smoke.py's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
VARIANT = {"float32": "cuda_cores", "bfloat16": "wgmma"}
REL_TOL, SLICE_TOL = 3.2e-3, 5e-3


def relative_errors(out, want) -> tuple[float, float]:
    """The relative error of the whole output and of its worst ``(b, h)``
    slice ``[S, P]``."""
    diff, want = out.float() - want.float(), want.float()
    whole = float(diff.norm() / want.norm())
    per = diff.norm(dim=(1, 3)) / want.norm(dim=(1, 3)).clamp_min(1e-30)
    return whole, float(per.max())


def _card(seed, b, s, h, p, g, n, dtype, dt_hi=0.1):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    x = f(rng.standard_normal((b, s, h, p)) * 0.5)
    dt = f(rng.uniform(0.001, dt_hi, (b, s, h)))
    A = f(-rng.uniform(0.5, 2.0, h))
    Bm = f(rng.standard_normal((b, s, g, n)) * 0.3)
    Cm = f(rng.standard_normal((b, s, g, n)) * 0.3)
    D = f(rng.uniform(0.0, 1.0, h))
    cast = getattr(torch, dtype)
    return x.to(cast), dt, A, Bm.to(cast), Cm.to(cast), D


CUDA_CASES = [
    # b, s, h, p, g, n, chunk, dtype
    (2, 512, 24, 64, 1, 128, 128, "bfloat16"),     # mamba2-130m's block
    (2, 300, 8, 32, 2, 64, 128, "float32"),        # ragged S, two groups
    (1, 1000, 8, 64, 1, 16, 128, "bfloat16"),      # jamba's state size
    (1, 256, 4, 128, 1, 128, 128, "float32"),      # the largest tiles
    (2, 96, 4, 16, 2, 32, 32, "float32"),
    (1, 200, 4, 16, 4, 16, 64, "float32"),
    (3, 130, 6, 32, 3, 128, 96, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(b, s, h, p, g, n, chunk, dtype):
    args = _card(s + n, b, s, h, p, g, n, dtype)
    launches = ssd.ssd_scan_cuda.launches
    with torch.no_grad():
        out = ops.ssd_scan(*args, chunk=chunk)
    want = ref.ssd_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == launches + 1
    assert ssd.ssd_scan_cuda.last_plan["variant"] == VARIANT[dtype]
    assert out.dtype == want.dtype and out.shape == want.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# the tensor-core phases' edge cases: every chunk, ragged S, groups of 2
# and 3 heads, every P and N, B > 1, 64 chunks through the state pass
BF16_CASES = [
    # b, s, h, p, g, n, chunk
    (1, 256, 4, 64, 1, 128, 32),        # chunk 32: 64-row tiles, half padding
    (2, 300, 4, 64, 2, 64, 64),         # chunk 64, ragged, 2 heads a group
    (1, 200, 6, 32, 2, 32, 96),         # chunk 96 in 128-row tiles, 3 a group
    (3, 130, 6, 16, 3, 16, 128),        # P = N = 16, ragged, B = 3
    (1, 512, 4, 128, 1, 64, 128),       # P = 128: two boxes, two M tiles
    (2, 384, 8, 128, 4, 128, 64),       # P = N = 128 in 64-row tiles
    (1, 1000, 8, 64, 1, 16, 128),       # jamba's state size, ragged
    (2, 100, 4, 32, 1, 128, 32),        # ragged in 32-row chunks
    (1, 64, 2, 16, 2, 64, 96),          # S below one chunk, 1 head a group
    (1, 8192, 8, 64, 1, 128, 128),      # 64 chunks through the state pass
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", BF16_CASES)
def test_bf16_kernel_edge_cases(b, s, h, p, g, n, chunk):
    args = _card(3 * s + p + n + chunk, b, s, h, p, g, n, "bfloat16")
    _holds(args, chunk)


def _holds(args, chunk):
    """One counted launch of the tensor-core phases, within 2e-2 of the
    plain version elementwise and within the relative-error limits."""
    launches = ssd.ssd_scan_cuda.launches
    with torch.no_grad():
        out = ops.ssd_scan(*args, chunk=chunk)
    want = ref.ssd_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == launches + 1
    assert ssd.ssd_scan_cuda.last_plan["variant"] == "wgmma"
    assert out.dtype == torch.bfloat16 and bool(out.isfinite().all())
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    whole, worst = relative_errors(out, want)
    assert whole < REL_TOL and worst < SLICE_TOL, (whole, worst)


def test_bf16_kernel_where_the_decay_would_overflow():
    """dt = 0.1 and |A| = 16 on one head: sum dt |A| over a chunk of 128
    reaches ~205, and exp(cum_i - cum_j) above the diagonal would overflow
    if it were formed; the kernel masks before the exponential."""
    x, dt, A, Bm, Cm, D = _card(12, 1, 512, 2, 64, 1, 128, "bfloat16")
    dt = torch.full_like(dt, 0.1)
    A = torch.tensor([-16.0, -1.0], device="cuda")
    _holds((x, dt, A, Bm, Cm, D), 128)


def test_bf16_kernel_reads_strided_inputs():
    """x, B and C as slices of wider bf16 tensors, every stride a multiple
    of 16 bytes, as TMA needs; dt transposed in memory."""
    x, dt, A, Bm, Cm, D = _card(13, 2, 300, 8, 64, 2, 64, "bfloat16")
    wide = torch.cat([Bm, Cm], dim=2)              # [B, S, 2G, N]
    xw = torch.cat([x, x], dim=3)[..., :64]        # row stride 2P
    dtw = dt.transpose(0, 1).contiguous().transpose(0, 1)
    launches = ssd.ssd_scan_cuda.launches
    out = ssd.ssd_scan_cuda(xw, dtw, A, wide[:, :, :2], wide[:, :, 2:], D,
                            chunk=64)
    want = ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=64)
    assert ssd.ssd_scan_cuda.launches == launches + 1
    assert ssd.ssd_scan_cuda.last_plan["variant"] == "wgmma"
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    whole, worst = relative_errors(out, want)
    assert whole < REL_TOL and worst < SLICE_TOL, (whole, worst)


def test_bf16_kernel_refuses_a_stride_tma_cannot_take():
    x, dt, A, Bm, Cm, D = _card(14, 1, 64, 2, 64, 1, 16, "bfloat16")
    odd = torch.cat([Bm, Bm[..., :4]], dim=3)[..., :16]   # rows of 20 bf16
    with pytest.raises(ValueError, match="Bm's stride 20 along axis s"):
        ssd.ssd_scan_cuda(x, dt, A, odd, Cm, D)
    xo = torch.cat([x, x[..., :4]], dim=3)[..., :64]      # 68 bf16 a head
    with pytest.raises(ValueError, match="x's stride 68 along axis h"):
        ssd.ssd_scan_cuda(xo, dt, A, Bm, Cm, D)


# the CUDA-core phases' edge cases: P and N of 16 and 128, chunks of 32
# and 96 in 64- and 128-row tiles, ragged S, G > 1, a run of one head and
# runs of several, y's two 64-column halves at P = 128
F32_CASES = [
    # b, s, h, p, g, n, chunk
    (1, 200, 4, 16, 2, 128, 32),        # P 16, N 128, chunk 32, 2 groups
    (2, 300, 6, 128, 3, 16, 96),        # P 128, N 16, chunk 96, 3 groups
    (1, 256, 8, 128, 1, 128, 128),      # P = N = 128
    (2, 100, 6, 16, 2, 16, 96),         # P = N = 16, S below one tile
    (1, 1000, 12, 64, 2, 64, 64),       # 2 groups in runs of 6 heads
    (8, 512, 24, 64, 1, 128, 128),      # one run of 24 heads
    (1, 300, 128, 64, 1, 16, 128),      # jamba's layer: runs of 3 heads
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", F32_CASES)
def test_f32_kernel_edge_cases(b, s, h, p, g, n, chunk):
    """One counted launch of the CUDA-core phases with the plan's head
    runs, within 2e-4 of the plain version."""
    args = _card(5 * s + p + n + chunk, b, s, h, p, g, n, "float32")
    launches = ssd.ssd_scan_cuda.launches
    with torch.no_grad():
        out = ops.ssd_scan(*args, chunk=chunk)
    want = ref.ssd_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == launches + 1
    plan = ssd.ssd_scan_cuda.last_plan
    assert plan == ssd.kernel_plan(b, s, h, p, g, n, chunk, torch.float32)
    assert plan["variant"] == "cuda_cores" and bool(out.isfinite().all())
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)


def test_cuda_kernel_matches_sequential_scan():
    args = _card(7, 2, 300, 8, 32, 2, 64, "float32")
    out = ssd.ssd_scan_cuda(*args, chunk=128)
    torch.testing.assert_close(out, ref.ssd_ref(*args), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernel_reads_strided_inputs(offset):
    """x, B and C as slices of wider tensors (their last axis contiguous):
    read through their strides, or, where a row does not start on 16 bytes
    (``offset`` 1), copied first; the same y as from dense inputs."""
    x, dt, A, Bm, Cm, D = _card(8, 2, 256, 8, 64, 1, 64, "float32")
    wide = torch.cat([Bm, Cm, Bm], dim=2)        # [B, S, 3G, N]
    xw = torch.cat([x, x], dim=3)                # row stride 2P
    n = Bm.shape[3]
    bw = wide.flatten(2)[..., offset:offset + n].unflatten(2, (1, n))
    cw = wide.flatten(2)[..., n + offset:2 * n + offset].unflatten(2, (1, n))
    want = ref.ssd_scan_ref(xw[..., offset:offset + 64], dt, A, bw, cw, D,
                            chunk=128)
    out = ssd.ssd_scan_cuda(xw[..., offset:offset + 64],
                            dt.transpose(0, 1).contiguous().transpose(0, 1),
                            A, bw, cw, D, chunk=128)
    assert ssd.ssd_scan_cuda.last_plan["variant"] == "cuda_cores"
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)


def test_cuda_gradients_match_plain_version():
    args = _card(9, 2, 256, 8, 64, 1, 128, "float32")
    leaves = [a.clone().requires_grad_(True) for a in args]
    plain = [a.clone().requires_grad_(True) for a in args]
    gy = torch.randn(2, 256, 8, 64, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    launches = ssd.ssd_scan_cuda.launches
    bwd = ssd.ssd_scan_bwd_cuda.launches
    got = torch.autograd.grad(ops.ssd_scan(*leaves, chunk=128), leaves, gy)
    want = torch.autograd.grad(ref.ssd_scan_ref(*plain, chunk=128), plain, gy)
    assert ssd.ssd_scan_cuda.launches == launches + 1
    assert ssd.ssd_scan_bwd_cuda.launches == bwd + 1
    for name, a, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * scale, name


def test_cuda_kernel_refuses_what_it_does_not_take():
    """What no instantiation takes as it is runs through the decomposition
    (P 8 padded to 16, N 24 to 32, chunk 48 at 64; the plan reports it)
    and equals the plain version at the asked chunk; another dtype, an f32
    input in bf16 and a call under autograd stay refusals."""
    x, dt, A, Bm, Cm, D = _card(1, 1, 64, 2, 64, 1, 16, "float32")
    wide = Bm.new_zeros(1, 64, 1, 24).normal_()
    for args, chunk, key, want in (
            ((x[..., :8], dt, A, Bm, Cm, D), 128, "p_width", 16),
            ((x, dt, A, wide, wide, D), 128, "n_width", 32),
            ((x, dt, A, Bm, Cm, D), 48, "chunk", 64)):
        out = ssd.ssd_scan_cuda(*args, chunk=chunk)
        assert ssd.ssd_scan_cuda.last_plan[key] == want
        torch.testing.assert_close(out, ref.ssd_scan_ref(*args, chunk=chunk),
                                   rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="float16"):
        ssd.ssd_scan_cuda(x.half(), dt, A, Bm.half(), Cm.half(), D)
    with pytest.raises(ValueError, match="dt is torch.bfloat16"):
        ssd.ssd_scan_cuda(x, dt.bfloat16(), A, Bm, Cm, D)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd.ssd_scan_cuda(x.requires_grad_(True), dt, A, Bm, Cm, D)


# ssd_scan_pallas's corners that no instantiation takes as they are (as
# tests/test_torch_ssd.py's CORNERS), and a batch of 66,000 past the
# grid's z: b, s, h, p, g, n, chunk
CORNERS = [
    (1, 300, 2, 16, 1, 16, 256),
    (1, 100, 2, 8, 1, 8, 48),
    (2, 200, 2, 48, 1, 24, 160),
    (1, 130, 4, 96, 2, 48, 100),
    (1, 40, 2, 16, 1, 16, 8),
    (1, 96, 2, 192, 1, 32, 64),
    (1, 96, 4, 32, 2, 256, 32),
    (1, 70, 2, 136, 1, 136, 48),
    (66_000, 8, 2, 16, 1, 16, 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_takes_every_corner(dtype):
    """Every corner in one looping test: one counted call of the kernel
    through the decomposition (the plan's launches), y and the final state
    against the plain version at the asked chunk, under the file's limits
    (f32 2e-4; bf16 2e-2 elementwise and the relative errors)."""
    for i, (b, s, h, p, g, n, chunk) in enumerate(CORNERS):
        args = _card(17 + i, b, s, h, p, g, n, dtype)
        launches = ssd.ssd_scan_cuda.launches
        with torch.no_grad():
            y, state = ops.ssd_scan(*args, chunk=chunk, return_state=True)
        want_y, want = ref.ssd_scan_ref(*args, chunk=chunk,
                                        return_state=True)
        torch.cuda.synchronize()
        case = (b, s, h, p, g, n, chunk)
        assert ssd.ssd_scan_cuda.launches == launches + 1, case
        plan = ssd.ssd_scan_cuda.last_plan
        assert plan["variant"] == VARIANT[dtype], case
        assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n), case
        assert bool(y.isfinite().all()) and bool(state.isfinite().all())
        torch.testing.assert_close(y.float(), want_y.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        if dtype == "float32":
            torch.testing.assert_close(state, want, rtol=2e-4, atol=2e-4)
            continue
        whole, worst = relative_errors(y, want_y)
        assert whole < REL_TOL and worst < SLICE_TOL, (case, whole, worst)
        diff = state - want
        whole = float(diff.norm() / want.norm())
        worst = float((diff.norm(dim=(2, 3))
                       / want.norm(dim=(2, 3)).clamp_min(1e-30)).max())
        assert whole < REL_TOL and worst < SLICE_TOL, (case, whole, worst)


STATE_CASES = [
    # b, s, h, p, g, n, chunk, dtype
    (2, 300, 8, 32, 2, 64, 128, "float32"),        # ragged S, two groups
    (1, 300, 8, 64, 1, 16, 128, "float32"),        # jamba's P and N
    (1, 200, 4, 16, 2, 128, 32, "float32"),        # chunk 32, P 16, N 128
    (2, 300, 6, 128, 3, 16, 96, "float32"),        # chunk 96, P 128, N 16
    (1, 1000, 8, 64, 1, 16, 128, "bfloat16"),      # jamba's P and N
    (3, 130, 6, 32, 3, 128, 96, "bfloat16"),       # ragged, chunk of 96
    (2, 512, 24, 64, 1, 128, 128, "bfloat16"),     # mamba2-130m's block
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", STATE_CASES)
def test_cuda_final_state_matches_plain_version(b, s, h, p, g, n, chunk,
                                                dtype):
    """``return_state``: y as without it, and the f32 state after step S
    against the plain chunked version's over the inputs padded with
    ``dt = 0``; within 2e-4 in f32, and in bf16 by the relative error of the
    whole state and of its worst ``(b, h)`` slice ``[P, N]``, under y's
    limits (the bf16 phases round the scaled B rows to bf16 before the
    products that make each chunk's state)."""
    args = _card(s + p + n + 5, b, s, h, p, g, n, dtype)
    launches = ssd.ssd_scan_cuda.launches
    with torch.no_grad():
        y, state = ops.ssd_scan(*args, chunk=chunk, return_state=True)
    want_y, want = ref.ssd_scan_ref(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == launches + 1
    assert ssd.ssd_scan_cuda.last_plan["variant"] == VARIANT[dtype]
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    assert bool(state.isfinite().all())
    torch.testing.assert_close(y.float(), want_y.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if dtype == "float32":
        torch.testing.assert_close(state, want, rtol=2e-4, atol=2e-4)
        return
    diff = state - want
    whole = float(diff.norm() / want.norm())
    worst = float((diff.norm(dim=(2, 3))
                   / want.norm(dim=(2, 3)).clamp_min(1e-30)).max())
    assert whole < REL_TOL and worst < SLICE_TOL, (whole, worst)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_launches_the_kernel(dtype, monkeypatch):
    """``ssm_prefill`` on the card: one launch of the kernel with its state
    output, no call of the plain chunked version; the outputs, the conv tail
    and the state agree with the CPU's prefill of the same parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    cfg = get_config("mamba2-130m", smoke=True, dtype=dtype)
    params = ssm.init_ssm(torch.Generator().manual_seed(3), cfg)
    x = torch.randn(2, 150, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).to(
                        cfg.compute_dtype)
    want = ssm.ssm_prefill(params, cfg, x)
    plain = ref.ssd_chunked_ref

    def refuse_on_the_card(x, *args, **kw):
        assert not x.is_cuda, "the plain chunked version ran on the card"
        return plain(x, *args, **kw)

    monkeypatch.setattr(ref, "ssd_chunked_ref", refuse_on_the_card)
    launches = ssd.ssd_scan_cuda.launches
    with torch.no_grad():
        got = ssm.ssm_prefill({k: v.cuda() for k, v in params.items()}, cfg,
                              x.cuda())
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == launches + 1
    tol = TOL[dtype]
    for name, a, w in zip(("out", "conv tail", "state"), got, want):
        scale = float(w.float().abs().max())
        err = float((a.cpu().float() - w.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)

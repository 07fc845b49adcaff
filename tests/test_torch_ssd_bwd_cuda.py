"""The port's CUDA SSD-scan backward against its plain version, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_ssd_bwd_cuda.py

The kernel (``ssd_scan_bwd_cuda``) is held against ``ref.ssd_scan_bwd_ref``
on the same inputs.  f32 (plan variant ``"cuda_cores"``, f32 FMAs, dS summed
over a run of heads in f32): each gradient within 1e-4 of its largest value
(the kernel adds in another order than the plain version).  bf16 (``"wgmma"``): the kernel rounds M, dS summed over a
run of heads, the carried state, its gradient and the scaled rows of x and
dy to bf16 before their products, so each gradient is held by the relative
error of the whole tensor, ``|got - want|_F / |want|_F``, under
``REL_TOL``, and dx, ddt, dBm and dCm also by their worst ``(b, h)`` (or
``(b, g)``) slice under ``SLICE_TOL``: ~2x the most the first bf16 kernel
(``mma.sync``) gave on an H100 over these cases and chip_smoke.py's shapes.
Two calls give bitwise the same gradients, and neither plan's scratch
holds a ``[B, S, H, N]`` tensor.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]

VARIANT = {"float32": "cuda_cores", "bfloat16": "wgmma"}
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dD")
# the slices of each gradient: (b, h) of dx [B, S, H, P] and ddt [B, S, H],
# (b, g) of dBm, dCm [B, S, G, N]; dA and dD [H] are held whole
SLICE_DIMS = ((1, 3), (1,), None, (1, 3), (1, 3), None)
F32_TOL = 1e-4
# the sound kernel's most on an H100 (NVIDIA H100 80GB HBM3, 700 W) over
# these cases and chip_smoke.py's, whole / worst slice: dx 1.36e-3 /
# 2.79e-3, ddt 9.8e-4 / 1.31e-3, dA 5.46e-3, dBm 2.71e-3 / 2.82e-3, dCm
# 2.75e-3 / 2.85e-3, dD 4e-7 (dD sums exact products of bf16 inputs)
REL_TOL = {"dx": 3e-3, "ddt": 2e-3, "dA": 1.1e-2, "dBm": 5.5e-3,
           "dCm": 5.5e-3, "dD": 1e-6}
SLICE_TOL = {"dx": 6e-3, "ddt": 2.7e-3, "dBm": 6e-3, "dCm": 6e-3}


def _card(seed, b, s, h, p, g, n, dtype, dt_const=None, A=None):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    cast = getattr(torch, dtype)
    x = f(rng.standard_normal((b, s, h, p)) * 0.5).to(cast)
    dt = f(rng.uniform(0.001, 0.1, (b, s, h)) if dt_const is None
           else np.full((b, s, h), dt_const))
    A = f(-rng.uniform(0.5, 2.0, h) if A is None else np.asarray(A))
    Bm = f(rng.standard_normal((b, s, g, n)) * 0.3).to(cast)
    Cm = f(rng.standard_normal((b, s, g, n)) * 0.3).to(cast)
    D = f(rng.uniform(0.0, 1.0, h))
    dy = f(rng.standard_normal((b, s, h, p))).to(cast)
    return x, dt, A, Bm, Cm, D, dy


def relative_errors(got, want, dims) -> tuple[float, float | None]:
    """The relative error of the whole gradient and of its worst slice
    (None where ``dims`` is None)."""
    diff, want = got.float() - want.float(), want.float()
    whole = float(diff.norm() / want.norm())
    if dims is None:
        return whole, None
    per = diff.norm(dim=dims) / want.norm(dim=dims).clamp_min(1e-30)
    return whole, float(per.max())


def _holds(args, chunk, dtype):
    """One counted launch of the variant the dtype picks, bitwise the same
    on a second call, and within the dtype's limits of the plain version."""
    launches = ssd.ssd_scan_bwd_cuda.launches
    got = ssd.ssd_scan_bwd_cuda(*args, chunk=chunk)
    assert ssd.ssd_scan_bwd_cuda.launches == launches + 1
    plan = ssd.ssd_scan_bwd_cuda.last_plan
    assert plan["variant"] == VARIANT[dtype]
    b, s, h, _ = args[0].shape
    assert (b, s, h, args[3].shape[3]) not in [
        shape for shape, _ in plan["scratch"].values()]
    again = ssd.ssd_scan_bwd_cuda(*args, chunk=chunk)
    want = ref.ssd_scan_bwd_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for name, a, w, dims in zip(NAMES, got, want, SLICE_DIMS):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert a.is_contiguous() and bool(a.isfinite().all()), name
        if dtype == "float32":
            err = float((a - w).abs().max() / w.abs().max())
            assert err <= F32_TOL, (name, err)
            continue
        whole, worst = relative_errors(a, w, dims)
        assert whole < REL_TOL[name], (name, whole)
        assert worst is None or worst < SLICE_TOL[name], (name, worst)


CUDA_CASES = [
    # b, s, h, p, g, n, chunk, dtype: the forward's card-test shapes
    (2, 512, 24, 64, 1, 128, 128, "bfloat16"),     # mamba2-130m's block
    (2, 300, 8, 32, 2, 64, 128, "float32"),        # ragged S, two groups
    (1, 1000, 8, 64, 1, 16, 128, "bfloat16"),      # jamba's state size
    (1, 256, 4, 128, 1, 128, 128, "float32"),      # the largest tiles
    (2, 96, 4, 16, 2, 32, 32, "float32"),
    (1, 200, 4, 16, 4, 16, 64, "float32"),
    (3, 130, 6, 32, 3, 128, 96, "bfloat16"),       # ragged, 3 heads a group
    (1, 256, 4, 64, 1, 128, 32, "bfloat16"),       # chunk 32
    (2, 300, 4, 64, 2, 64, 64, "bfloat16"),        # chunk 64, ragged
    (3, 130, 6, 16, 3, 16, 128, "bfloat16"),       # P = N = 16, B = 3
    (2, 384, 8, 128, 4, 128, 64, "bfloat16"),      # P = N = 128
    (1, 64, 2, 16, 2, 64, 96, "bfloat16"),         # S below one chunk
    (1, 200, 6, 128, 2, 16, 96, "float32"),        # P 128, N 16, chunk 96
    (2, 1024, 10, 32, 2, 64, 128, "bfloat16"),     # runs of 2, 2, 1 heads
    (1, 1024, 128, 64, 1, 16, 128, "bfloat16"),    # jamba's, S cut: 16 runs
    (2, 384, 8, 128, 4, 128, 128, "bfloat16"),     # two key blocks a tile
    # the CUDA-core launches' edge cases
    (1, 200, 4, 16, 2, 128, 32, "float32"),        # P 16, N 128, chunk 32
    (2, 300, 6, 128, 3, 16, 96, "float32"),        # P 128, N 16, chunk 96
    (1, 256, 8, 128, 1, 128, 64, "float32"),       # P = N = 128: one stage
    (2, 100, 6, 16, 2, 16, 96, "float32"),         # S below one tile
    (2, 1024, 10, 32, 2, 64, 128, "float32"),      # runs of 2, 2, 1 heads
    (1, 1024, 24, 64, 1, 128, 128, "float32"),     # 8 runs of 3 heads
    (8, 512, 24, 64, 1, 128, 128, "float32"),      # one run of 24 heads
    (1, 300, 128, 64, 1, 16, 128, "float32"),      # jamba's layer
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", CUDA_CASES)
def test_cuda_backward_matches_plain_version(b, s, h, p, g, n, chunk, dtype):
    args = _card(s + p + n + chunk, b, s, h, p, g, n, dtype)
    _holds(args, chunk, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_where_the_decay_would_overflow(dtype):
    """dt = 0.1 and |A| = 16 on one head: sum dt |A| over a chunk of 128
    reaches ~205; the kernel masks the decay before the exponential, and
    exp(cum) underflows to 0 without harm."""
    args = _card(12, 1, 512, 2, 64, 1, 128, dtype, dt_const=0.1,
                 A=[-16.0, -1.0])
    _holds(args, 128, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_backward_reads_strided_inputs(dtype):
    """x, Bm, Cm and dy as slices of wider tensors: the wrapper reads them
    contiguous, with the same gradients as from dense copies."""
    x, dt, A, Bm, Cm, D, dy = _card(13, 2, 300, 8, 64, 2, 64, dtype)
    wide = torch.cat([Bm, Cm], dim=2)
    xw = torch.cat([x, x], dim=3)[..., :64]
    dyw = torch.cat([dy, dy], dim=3)[..., 64:]
    got = ssd.ssd_scan_bwd_cuda(xw, dt, A, wide[:, :, :2], wide[:, :, 2:], D,
                                dyw, chunk=64)
    want = ssd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy, chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cuda_backward_refuses_what_it_does_not_take():
    """P 8 and chunk 48 run through the decomposition (the plan reports
    P padded to 16, the chunk run at 64) and hold to the plain version at
    the asked chunk; another dtype, a dy of another dtype and a call under
    autograd stay refusals."""
    x, dt, A, Bm, Cm, D, dy = _card(1, 1, 64, 2, 64, 1, 16, "float32")
    for args, chunk, key, want in (
            ((x[..., :8], dt, A, Bm, Cm, D, dy[..., :8]), 128, "p_width", 16),
            ((x, dt, A, Bm, Cm, D, dy), 48, "chunk", 64)):
        _holds(args, chunk, "float32")
        assert ssd.ssd_scan_bwd_cuda.last_plan[key] == want
    with pytest.raises(ValueError, match="float16"):
        ssd.ssd_scan_bwd_cuda(x.half(), dt, A, Bm.half(), Cm.half(), D,
                              dy.half())
    with pytest.raises(ValueError, match="dy is"):
        ssd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy.bfloat16())
    with pytest.raises(RuntimeError, match="no backward"):
        ssd.ssd_scan_bwd_cuda(x.requires_grad_(True), dt, A, Bm, Cm, D, dy)


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
def test_cuda_backward_takes_every_corner(dtype):
    """Every corner in one looping test: one counted call through the
    decomposition, bitwise the same on a second call, within the dtype's
    limits of the plain backward at the asked chunk (``_holds``)."""
    for i, (b, s, h, p, g, n, chunk) in enumerate(CORNERS):
        try:
            _holds(_card(31 + i, b, s, h, p, g, n, dtype), chunk, dtype)
        except AssertionError as e:
            raise AssertionError(f"{CORNERS[i]}: {e}") from e


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssdscan_launches_the_backward_kernel(dtype, monkeypatch):
    """Gradients through ``ops.ssd_scan`` on the card: one forward and one
    backward launch, no call of a plain version on the card, and the
    gradients the backward kernel gives on its own."""
    args = _card(21, 2, 256, 8, 64, 1, 128, dtype)
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    plain = (ref.ssd_scan_ref, ref.ssd_chunked_ref, ref.ssd_scan_bwd_ref)

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    for fn in plain:
        monkeypatch.setattr(ref, fn.__name__, refuse)
    fwd, bwd = ssd.ssd_scan_cuda.launches, ssd.ssd_scan_bwd_cuda.launches
    got = torch.autograd.grad(ops.ssd_scan(*leaves, chunk=128), leaves,
                              args[6])
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == fwd + 1
    assert ssd.ssd_scan_bwd_cuda.launches == bwd + 1
    want = ssd.ssd_scan_bwd_cuda(*args, chunk=128)
    assert all(torch.equal(a, w) for a, w in zip(got, want))

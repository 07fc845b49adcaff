"""The port's CUDA SSD-scan kernel against its plain version, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

Tolerances: 2e-4 in f32, the reference's kernel tolerance
(``tests/test_kernels.py``: the kernel adds in another order than the plain
version); 2e-2 in bf16, where x, B, C and y round to 8 bits of mantissa.
Gradients come from the plain version in both paths (``SSDScan``'s backward
recomputes it), so they agree to f32 rounding of the forward's inputs:
1e-4 of each leaf's largest value.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


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
    assert out.dtype == want.dtype and out.shape == want.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_cuda_kernel_matches_sequential_scan():
    args = _card(7, 2, 300, 8, 32, 2, 64, "float32")
    out = ssd.ssd_scan_cuda(*args, chunk=128)
    torch.testing.assert_close(out, ref.ssd_ref(*args), rtol=2e-4, atol=2e-4)


def test_cuda_kernel_reads_strided_inputs():
    """x, B and C as slices of wider tensors (their last axis contiguous)."""
    x, dt, A, Bm, Cm, D = _card(8, 2, 256, 8, 64, 1, 64, "float32")
    wide = torch.cat([Bm, Cm], dim=2)            # [B, S, 2G, N]
    xw = torch.cat([x, x], dim=3)[..., :64]      # row stride 2P
    out = ssd.ssd_scan_cuda(xw, dt.transpose(0, 1).contiguous().transpose(0, 1),
                            A, wide[:, :, :1], wide[:, :, 1:], D, chunk=128)
    want = ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=128)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)


def test_cuda_gradients_match_plain_version():
    args = _card(9, 2, 256, 8, 64, 1, 128, "float32")
    leaves = [a.clone().requires_grad_(True) for a in args]
    plain = [a.clone().requires_grad_(True) for a in args]
    gy = torch.randn(2, 256, 8, 64, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    launches = ssd.ssd_scan_cuda.launches
    got = torch.autograd.grad(ops.ssd_scan(*leaves, chunk=128), leaves, gy)
    want = torch.autograd.grad(ref.ssd_scan_ref(*plain, chunk=128), plain, gy)
    assert ssd.ssd_scan_cuda.launches == launches + 1
    for name, a, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * scale, name


def test_cuda_kernel_refuses_what_it_does_not_take():
    x, dt, A, Bm, Cm, D = _card(1, 1, 64, 2, 64, 1, 16, "float32")
    with pytest.raises(ValueError, match="head dim P=8"):
        ssd.ssd_scan_cuda(x[..., :8], dt, A, Bm, Cm, D)
    wide = Bm.new_zeros(1, 64, 1, 24)
    with pytest.raises(ValueError, match="state dim N=24"):
        ssd.ssd_scan_cuda(x, dt, A, wide, wide, D)
    with pytest.raises(ValueError, match="chunk 48"):
        ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=48)
    with pytest.raises(ValueError, match="float16"):
        ssd.ssd_scan_cuda(x.half(), dt, A, Bm.half(), Cm.half(), D)
    with pytest.raises(ValueError, match="dt is torch.bfloat16"):
        ssd.ssd_scan_cuda(x, dt.bfloat16(), A, Bm, Cm, D)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd.ssd_scan_cuda(x.requires_grad_(True), dt, A, Bm, Cm, D)

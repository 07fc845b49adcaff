"""The port's CUDA flash-attention kernel against its plain version, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

Tolerances are the reference's kernel tolerances (2e-5 for f32, 2e-2 for
bf16): the kernel sums keys in another order than the plain version, and
bf16 rounds the output.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _card(seed, b, hq, hk, sq, sk, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to("cuda", getattr(torch, dtype))
            for s in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


CUDA_CASES = [
    # b, hq, hk, sq, sk, d, dtype, kwargs
    (1, 16, 8, 512, 512, 128, "bfloat16", dict(causal=True)),
    (1, 8, 4, 1000, 1000, 128, "bfloat16", dict(causal=True, window=300,
                                                 softcap=50.0)),
    (2, 8, 8, 256, 256, 96, "bfloat16", dict(causal=True)),
    (2, 4, 2, 300, 300, 64, "float32", dict(causal=True)),
    (1, 4, 2, 128, 1000, 128, "float32", dict(causal=True)),
    (1, 4, 2, 200, 130, 64, "float32", dict(causal=True)),     # masked rows
    (2, 4, 2, 70, 190, 96, "float32", dict(causal=False, window=50)),
]


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,dtype,kw", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(b, hq, hk, sq, sk, d, dtype, kw):
    args = _card(sq + sk, b, hq, hk, sq, sk, d, dtype)
    launches = fa.flash_attention_cuda.launches
    out = ops.flash_attention(*args, **kw)
    want = ref.attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == launches + 1
    assert out.dtype == want.dtype
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_cuda_kernel_refuses_what_it_does_not_take():
    q, k, v = _card(1, 1, 4, 2, 64, 64, 16, "float32")
    with pytest.raises(ValueError, match="head dim 16"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _card(1, 1, 4, 2, 64, 64, 64, "float32")
    with pytest.raises(ValueError, match="not contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="float16"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())

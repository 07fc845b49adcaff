"""The port's flash attention against the JAX package's.

On the CPU, ``repro_torch.kernels.ops.flash_attention`` runs the plain
version (``ref.attention_ref``); it is held against the Pallas kernel
``flash_attention_pallas`` in interpret mode on the same numpy inputs, with
the tolerances of the reference's kernel tests (2e-5 for f32, 2e-2 for
bf16: the two sum keys in another order, and bf16 rounds the output).  A
row whose keys are all masked gives 0 in both.  The CUDA kernel runs only on
a card: its tests are in ``test_torch_flash_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.tier1

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, b, hq, hk, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _close(out, want, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


CASES = [
    # b, hq, hk, sq, sk, d, kwargs
    (1, 2, 2, 64, 64, 32, dict(causal=True)),                    # MHA
    (2, 4, 2, 128, 128, 16, dict(causal=True)),                  # GQA
    (2, 4, 2, 100, 100, 16, dict(causal=False)),                 # ragged
    (1, 4, 1, 96, 224, 32, dict(causal=True)),                   # MQA, sq < sk
    (2, 4, 2, 160, 160, 32, dict(causal=True, window=32)),
    (2, 4, 2, 160, 160, 32, dict(causal=True, softcap=20.0)),
    (1, 4, 2, 150, 150, 16, dict(causal=True, window=48, softcap=50.0)),
    (1, 2, 2, 70, 200, 16, dict(causal=False, window=64)),
    (1, 4, 4, 1, 256, 64, dict(causal=True)),                    # decode-like
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,kw", CASES)
def test_plain_version_matches_pallas(b, hq, hk, sq, sk, d, kw, dtype):
    arrays = _qkv(sq * 7 + sk, b, hq, hk, sq, sk, d)
    out = ops.flash_attention(*_port(arrays, dtype), **kw)
    want = flash_attention_pallas(*_jax(arrays, dtype), bq=64, bk=64,
                                  interpret=True, **kw)
    assert out.dtype == getattr(torch, dtype) and out.shape == want.shape
    _close(out, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_give_zero(dtype):
    """sq > sk under causal masking: the first sq - sk rows see no key.  The
    port gives them 0, as the Pallas kernel does (the JAX package's
    ``attention_ref`` would give the uniform average)."""
    b, hq, hk, sq, sk, d = 1, 4, 2, 80, 48, 16
    arrays = _qkv(5, b, hq, hk, sq, sk, d)
    out = ops.flash_attention(*_port(arrays, dtype), causal=True)
    want = flash_attention_pallas(*_jax(arrays, dtype), causal=True, bq=64,
                                  bk=64, interpret=True)
    _close(out, want, dtype)
    masked = sq - sk
    assert torch.count_nonzero(out[:, :, :masked]) == 0
    assert bool((out[:, :, masked:].abs().sum(-1) > 0).all())


def test_plain_version_matches_jax_ref_where_rows_see_keys():
    arrays = _qkv(11, 2, 4, 2, 120, 120, 32)
    kw = dict(causal=True, window=40, softcap=30.0)
    out = ref.attention_ref(*_port(arrays, "float32"), **kw)
    want = jref.attention_ref(*_jax(arrays, "float32"), **kw)
    _close(out, want, "float32")


def test_cpu_tensors_route_to_the_plain_version():
    args = _port(_qkv(3, 1, 2, 2, 40, 40, 64), "float32")
    launches = fa.flash_attention_cuda.launches
    out = ops.flash_attention(*args, causal=True, scale=0.1)
    assert torch.equal(out, ref.attention_ref(*args, causal=True, scale=0.1))
    assert fa.flash_attention_cuda.launches == launches
    with pytest.raises(ValueError, match="device type 'meta'"):
        ops.flash_attention(*[x.to("meta") for x in args])


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises rather than compute on the CPU."""
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(*_port(_qkv(4, 1, 2, 2, 8, 8, 64), "float32"))


def test_kernel_wrapper_refuses_autograd():
    """The kernel has no backward: under autograd, with an input that needs
    a gradient, the wrapper raises rather than return a result cut off from
    the graph.  Without a gradient to lose it goes on to its other checks."""
    q, k, v = _port(_qkv(6, 1, 2, 2, 8, 8, 64), "float32")
    q.requires_grad_(True)
    v.requires_grad_(True)
    with pytest.raises(RuntimeError, match="gradient of q, v would be lost"):
        fa.flash_attention_cuda(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(q, k, v)

"""The port's CUDA flash-attention backward against its plain version, on a
card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd_cuda.py

The backward kernel (``flash_attention_bwd_cuda``) and ``FlashAttention``
(its forward kernel with the row log-sum-exp, then the backward) against
``ref.attention_bwd_ref`` fed the same output and lse.  f32 (the CUDA-core
kernels): each of dq, dk, dv within 1e-4 of its largest |value|, the
kernel adding in another order than the plain version.  bf16 (TMA and
``wgmma``: P and dS rounded to bf16 before their products): the relative
error of the whole tensor and of its worst row (a row's norm floored at 1%
of the largest row's) within chip_smoke.py's limits.  Two calls give bitwise the
same gradients (no atomics), and a row that sees no key gets exactly zero
dq.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]

TOL = 1e-4
REL_TOL, ROW_TOL, ROW_FLOOR = 5e-3, 1.05e-2, 1e-2
# the bf16 row limit holds from D 16, where it was set: at D 4 and 8 a row
# of dq whose terms cancel moves by P's and dS's bf16 rounding alone past it
# (0.023 at D 4 on an H100); below it the whole tensor's limit stands.  f32
# (no such rounding) keeps its limit at every width, as in the forward's
# test
ROW_MIN_D = 16
VARIANT = {"float32": "cuda_cores", "bfloat16": "wgmma"}


def variant(d: int, dtype: str) -> str:
    """The plan variant of head width ``d``: the whole-width kernels at
    bf16 padded widths 136-256 ("wgmma_256") and f32 past 128
    ("cuda_cores_256"), else the dtype's."""
    if fa.native(d, getattr(torch, dtype)):
        return "wgmma_256" if dtype == "bfloat16" else "cuda_cores_256"
    return VARIANT[dtype]


def _card(seed, b, hq, hk, sq, sk, d, dtype):
    """q, k, v, dO on the card, standard normal from a numpy seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to("cuda", getattr(torch, dtype))
            for s in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d),
                      (b, hq, sq, d))]


def _hold(got, want, dtype, row_check=True):
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert bool(x.isfinite().all()), name
        diff, y = x.float() - y.float(), y.float()
        if dtype == "float32":
            assert float(diff.abs().max()) <= TOL * float(y.abs().max()), name
            continue
        rows = y.norm(dim=-1)
        floor = rows.clamp_min(ROW_FLOOR * float(rows.max()))
        assert float(diff.norm() / y.norm()) < REL_TOL, name
        if row_check:
            assert float((diff.norm(dim=-1) / floor).max()) < ROW_TOL, name


CASES = [
    # b, hq, hk, sq, sk, d, dtype, kwargs
    (2, 16, 8, 512, 512, 128, "bfloat16", dict(causal=True)),
    (1, 8, 4, 1000, 1000, 128, "bfloat16", dict(causal=True, window=300,
                                                 softcap=50.0)),
    (2, 8, 8, 256, 256, 96, "bfloat16", dict(causal=True)),
    (2, 4, 2, 300, 333, 64, "bfloat16", dict(causal=False)),
    (2, 4, 4, 20, 300, 64, "bfloat16", dict(causal=False)),      # cross
    (1, 16, 2, 256, 256, 128, "bfloat16", dict(causal=True)),    # group 8
    (1, 4, 2, 200, 130, 128, "bfloat16", dict(causal=True)),     # no keys
    # group 8 over 10 query tiles a head: 80 tiles through the two stages
    (2, 16, 2, 640, 640, 64, "bfloat16", dict(causal=False)),
    # Sk not a multiple of 128, Sq > Sk: 110 rows see no key
    (1, 4, 2, 300, 190, 96, "bfloat16", dict(causal=True)),
    (2, 4, 2, 300, 300, 64, "float32", dict(causal=True)),
    (1, 4, 2, 128, 1000, 128, "float32", dict(causal=True)),     # offset
    (1, 4, 2, 200, 130, 64, "float32", dict(causal=True)),       # no keys
    (2, 4, 2, 70, 190, 96, "float32", dict(causal=False, window=50,
                                           softcap=20.0)),
    # the Pallas kernel's narrow heads (16, 32) and widths between
    # instantiations (24: a 16-column slice half past D; 80: padded to 128)
    (2, 4, 2, 128, 128, 16, "bfloat16", dict(causal=True)),
    (2, 4, 2, 160, 160, 32, "bfloat16", dict(causal=True, window=32)),
    (1, 4, 2, 150, 150, 16, "bfloat16", dict(causal=True, window=48,
                                            softcap=50.0)),
    (1, 4, 1, 96, 224, 32, "bfloat16", dict(causal=True)),     # Sq < Sk
    (1, 4, 2, 200, 130, 16, "bfloat16", dict(causal=True)),    # no keys
    (2, 16, 8, 1024, 1024, 32, "bfloat16", dict(causal=True)),  # 128 rows
    (1, 4, 2, 333, 333, 24, "bfloat16", dict(causal=False)),
    (2, 8, 4, 300, 300, 80, "bfloat16", dict(causal=True)),
    (2, 4, 2, 128, 128, 16, "float32", dict(causal=True)),
    (2, 4, 2, 160, 160, 32, "float32", dict(causal=True, window=32,
                                           softcap=20.0)),
    (1, 4, 2, 200, 130, 16, "float32", dict(causal=True)),     # no keys
    (1, 4, 1, 96, 224, 24, "float32", dict(causal=True)),      # Sq < Sk
    (2, 4, 2, 70, 190, 80, "float32", dict(causal=False, window=50)),
]
# every width past the narrow domain, in both dtypes: padded (4, 20, 200),
# the wide kernels' column slices (136, 192, 256, 520), with GQA, MQA, a
# window, a softcap, rows without keys and an f32 dQ whose keys split
# (8192 keys); then batches and heads past the grid's 65,535
WIDE_SHAPES = [
    (2, 4, 2, 300, 300, 4, dict(causal=True)),
    (2, 4, 2, 300, 300, 20, dict(causal=True, window=64, softcap=20.0)),
    (2, 4, 2, 300, 300, 136, dict(causal=True)),
    (2, 4, 2, 300, 300, 192, dict(causal=True)),
    (2, 4, 2, 300, 300, 256, dict(causal=True)),
    (2, 4, 2, 300, 300, 520, dict(causal=True)),
    (1, 4, 2, 150, 150, 256, dict(causal=True, window=48, softcap=50.0)),
    (1, 4, 1, 96, 224, 192, dict(causal=True)),
    (2, 4, 1, 300, 500, 136, dict(causal=True, window=100)),    # MQA, Sq < Sk
    (1, 8, 2, 200, 200, 192, dict(causal=False, softcap=30.0)),
    (2, 4, 2, 80, 48, 200, dict(causal=True)),                  # no keys
    (1, 4, 1, 64, 8192, 256, dict(causal=True)),                # f32 split
    (1, 8, 1, 512, 512, 512, dict(causal=True, window=128)),
    (66000, 2, 1, 8, 8, 16, dict(causal=True)),
    (1, 66000, 66000, 8, 8, 8, dict(causal=False)),
]
# the f32 kernels' 64-row tiles: Sq and Sk one past a tile, D 8, 24, 40 and
# 120, GQA groups of 4, rows without keys, window with softcap, and dQ
# blocks whose keys split (16 and 8 ways); then Qwen3-Next's attention in
# f32 at 4,096 tokens (the whole-width kernels on a full grid)
F32_EDGES = [
    (1, 4, 2, 65, 65, 64, dict(causal=True)),
    (1, 8, 2, 129, 129, 8, dict(causal=True)),
    (2, 8, 2, 100, 193, 24, dict(causal=False)),
    (1, 4, 1, 130, 130, 40, dict(causal=True, window=40, softcap=30.0)),
    (1, 4, 2, 200, 65, 120, dict(causal=True)),                 # no keys
    (1, 4, 4, 64, 2048, 64, dict(causal=True)),                 # split 16
    (1, 8, 2, 100, 1500, 120, dict(causal=True, window=700, softcap=50.0)),
    # Qwen3-Next's attention in f32: the whole-width kernels
    (1, 16, 2, 4096, 4096, 256, dict(causal=True)),
]


def _check_backward(b, hq, hk, sq, sk, d, dtype, kw):
    """One case of the backward against its plain version (see the module
    docstring), its plan's dQ split, two calls bitwise equal."""
    q, k, v, do = _card(sq + 3 * sk + d, b, hq, hk, sq, sk, d, dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    launches = fa.flash_attention_bwd_cuda.launches
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_cuda.launches == launches + 2
    plan = fa.flash_attention_bwd_cuda.last_plan
    assert plan["variant"] == variant(d, dtype)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert (plan["width"], plan["slices"]) == (
        fa.padded_width(d), fa.slices(d, getattr(torch, dtype)))
    # past fa.MAX_PAIRS pairs the plan is the first launch's
    chunks = fa.pair_chunks(b, hq, hk)
    assert plan["pair_chunks"] == max(1, len(chunks))
    (r0, r1), (h0, h1) = chunks[0] if chunks else ((0, b), (0, hq))
    pairs = (r1 - r0) * (h1 - h0)
    blocks = pairs * -(-sq // 64) * plan["slices"]
    assert plan["dq"]["split"] == (
        1 if dtype != "float32" else
        fa.wave_split(blocks, -(-sk // 64), n_sm)
        if plan["variant"] == "cuda_cores_256" else
        fa.key_split(blocks, sk, n_sm))
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    _hold(grads, want, dtype, row_check=d >= ROW_MIN_D or dtype == "float32")
    lse0 = ref.attention_lse_ref(q, k, **kw)
    none = torch.isinf(lse0)
    assert torch.equal(torch.isposinf(lse), none)
    torch.testing.assert_close(lse[~none], lse0[~none], rtol=0, atol=1e-4)
    if kw.get("causal") and sq > sk:
        assert torch.count_nonzero(grads[0][:, :, :sq - sk]) == 0


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,dtype,kw", CASES)
def test_backward_kernel_matches_plain_version(b, hq, hk, sq, sk, d, dtype,
                                               kw):
    _check_backward(b, hq, hk, sq, sk, d, dtype, kw)


def test_every_width_and_batch_matches_plain_version(monkeypatch):
    """Every case of WIDE_SHAPES, in bf16 and f32, as
    test_backward_kernel_matches_plain_version holds its cases, then pairs
    past one launch's (``_pairs_past_one_launch_match_plain_version``).
    (One test over the list: the collection's size decides xdist's first
    chunks, ROADMAP Queue C.)"""
    for b, hq, hk, sq, sk, d, kw in WIDE_SHAPES:
        for dtype in ("bfloat16", "float32"):
            _check_backward(b, hq, hk, sq, sk, d, dtype, kw)
    _pairs_past_one_launch_match_plain_version(monkeypatch)


def test_f32_tile_edges_and_dq_splits_match_plain_version():
    """Every case of F32_EDGES as test_backward_kernel_matches_plain_version
    holds its cases.  (One test over the list: the collection's size decides
    xdist's first chunks, ROADMAP Queue C.)"""
    for b, hq, hk, sq, sk, d, kw in F32_EDGES:
        _check_backward(b, hq, hk, sq, sk, d, "float32", kw)


def _pairs_past_one_launch_match_plain_version(monkeypatch):
    """With ``fa.MAX_PAIRS`` lowered to a few (batch, head) pairs, the
    forward and the backward launch once for each of ``fa.pair_chunks``'s
    ranges (rows of whole GQA groups; runs of one group's heads, whose dK
    and dV the later runs add) and hold their plain versions as
    test_backward_kernel_matches_plain_version holds its cases."""
    kw = dict(causal=True, window=100, softcap=20.0)
    for limit, b, hq, hk in ((6, 3, 4, 2), (4, 2, 6, 1)):
        monkeypatch.setattr(fa, "MAX_PAIRS", limit)
        for d in (64, 200):
            for dtype in ("bfloat16", "float32"):
                _check_backward(b, hq, hk, 160, 160, d, dtype, kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_function_on_the_card(dtype):
    """ops.flash_attention under autograd is ``FlashAttention``: one forward
    launch (with lse) and one backward call, the gradients those of the
    kernel fed its own output and lse."""
    q, k, v, do = _card(11, 1, 8, 4, 384, 384, 128, dtype)
    kw = dict(causal=True, window=200, softcap=30.0)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    f0, b0 = fa.flash_attention_cuda.launches, fa.flash_attention_bwd_cuda.launches
    out = ops.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_cuda.launches - f0,
            fa.flash_attention_bwd_cuda.launches - b0) == (1, 1)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out.detach(), o)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    _hold(grads, want, dtype)


def test_backward_kernel_refuses_what_it_does_not_take():
    q, k, v, do = _card(1, 1, 4, 2, 64, 64, 64, "float32")
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="head dim 0 is below 1"):
        fa.flash_attention_bwd_cuda(q[..., :0].contiguous(),
                                    k[..., :0].contiguous(),
                                    v[..., :0].contiguous(), o, lse, do)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, k, v, o, lse[:, :, :10], do)
    with pytest.raises(ValueError, match="do is not a contiguous"):
        fa.flash_attention_bwd_cuda(q, k, v, o, lse,
                                    do.transpose(2, 3).contiguous()
                                    .transpose(2, 3))

"""The port's CUDA flash-attention kernel against its plain version, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

Tolerances are the reference's kernel tolerances (2e-5 for f32, 2e-2 for
bf16): the kernel sums keys in another order than the plain version, and
bf16 rounds P before its product with V and rounds the output.  bf16 runs
the tensor-core kernel (plan variant ``"wgmma"``), f32 the CUDA-core one
(``"cuda_cores"``); each case checks which one launched.

An elementwise 2e-2 is as large as a typical output element at thousands of
keys (about sqrt(e / keys) for these inputs), so each case also holds every
output row's relative error, ``|out_r - want_r| / |want_r|``, under
``ROW_TOL``: bf16 rounding alone gave at most 4.4e-3 at chip_smoke.py's
shapes on an H100, while a key tile dropped or read from the wrong ring
stage moves a row by about ``sqrt(128 / keys)`` or more
(``scripts/flash_fault_reach.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
VARIANT = {"float32": "cuda_cores", "bfloat16": "wgmma"}


def variant(d: int, dtype: str) -> str:
    """The plan variant of head width ``d``: the whole-width kernels at
    bf16 padded widths 136-256 ("wgmma_256") and f32 past 128
    ("cuda_cores_256"), else the dtype's."""
    if fa.native(d, getattr(torch, dtype)):
        return "wgmma_256" if dtype == "bfloat16" else "cuda_cores_256"
    return VARIANT[dtype]
ROW_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# the bf16 row limit holds from D 16, where it was set: a row of 4 or 8
# values whose terms cancel has a norm of ~0.05, which P's rounding to bf16
# alone moves by ~2e-3 (0.044 relative at D 4 on an H100); below it the
# whole output's relative error (REL_TOL) stands in
ROW_MIN_D, REL_TOL = 16, {"float32": 1e-5, "bfloat16": 4e-3}


def _card(seed, b, hq, hk, sq, sk, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to("cuda", getattr(torch, dtype))
            for s in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


def worst_row_error(out, want) -> float:
    """The largest relative error of an output row (a row of zeros wanted
    must come out as zeros)."""
    diff = (out.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())


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
    # the Pallas kernel's narrow heads (its tests' 16 and 32) and widths
    # between instantiations (24: a 16-column slice half past D; 80: padded
    # to 128), on the f32 kernel's kAny instantiations
    (2, 4, 2, 128, 128, 16, "float32", dict(causal=True)),
    (2, 4, 2, 160, 160, 32, "float32", dict(causal=True, window=32)),
    (1, 4, 2, 150, 150, 16, "float32", dict(causal=True, window=48,
                                           softcap=50.0)),
    (1, 4, 2, 200, 130, 32, "float32", dict(causal=True)),     # masked rows
    (2, 4, 2, 70, 190, 80, "float32", dict(causal=False, window=50)),
    (1, 4, 1, 96, 224, 24, "float32", dict(causal=True)),      # MQA, sq < sk
]
# every width past the narrow domain, in both dtypes: off the multiple of 8
# (padded: 4 -> 8, 20 -> 24, 200), past 128 (the wide kernels' column
# slices: 136 with a second slice of 8 columns, 192, 256, 520 with five),
# with GQA, MQA, a window, a softcap and rows that see no key; then batches
# past the grid's 65,535 (the folded grid)
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
    (2, 4, 2, 80, 48, 200, dict(causal=True)),                  # masked rows
    (1, 16, 2, 1024, 1024, 256, dict(causal=True)),
    (1, 8, 1, 512, 512, 512, dict(causal=True, window=128)),
    (66000, 2, 1, 8, 8, 16, dict(causal=True)),
]


def _matches_plain_version(b, hq, hk, sq, sk, d, dtype, kw):
    args = _card(sq + sk, b, hq, hk, sq, sk, d, dtype)
    launches = fa.flash_attention_cuda.launches
    out = ops.flash_attention(*args, **kw)
    want = ref.attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == launches + 1
    assert fa.flash_attention_cuda.last_plan["variant"] == variant(d, dtype)
    assert out.dtype == want.dtype and out.shape == want.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if d >= ROW_MIN_D or dtype == "float32":
        assert worst_row_error(out, want) < ROW_TOL[dtype]
    else:
        diff = out.float() - want.float()
        assert float(diff.norm() / want.float().norm()) < REL_TOL[dtype]
    plan = fa.flash_attention_cuda.last_plan
    assert (plan["width"], plan["slices"]) == (
        fa.padded_width(d), fa.slices(d, getattr(torch, dtype)))
    assert plan["pair_chunks"] == max(1, len(fa.pair_chunks(b, hq, hk)))


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,dtype,kw", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(b, hq, hk, sq, sk, d, dtype, kw):
    _matches_plain_version(b, hq, hk, sq, sk, d, dtype, kw)


def test_every_width_and_batch_matches_plain_version(monkeypatch):
    """Every case of WIDE_SHAPES, in bf16 and f32, as
    test_cuda_kernel_matches_plain_version holds its cases, then pairs past
    one launch's (``_pairs_past_one_launch_match_plain_version``).  (One
    test over the list: the collection's size decides xdist's first chunks,
    ROADMAP Queue C.)"""
    for b, hq, hk, sq, sk, d, kw in WIDE_SHAPES:
        for dtype in ("bfloat16", "float32"):
            _matches_plain_version(b, hq, hk, sq, sk, d, dtype, kw)
    _pairs_past_one_launch_match_plain_version(monkeypatch)


def _pairs_past_one_launch_match_plain_version(monkeypatch):
    """With ``fa.MAX_PAIRS`` lowered to a few (batch, head) pairs, the
    forward launches once for each of ``fa.pair_chunks``'s ranges (rows of
    whole GQA groups; runs of one group's heads) and holds its plain
    version as test_cuda_kernel_matches_plain_version holds its cases."""
    kw = dict(causal=True, window=100, softcap=20.0)
    for limit, b, hq, hk in ((6, 3, 4, 2), (4, 2, 6, 1)):
        monkeypatch.setattr(fa, "MAX_PAIRS", limit)
        for d in (20, 64, 200):
            for dtype in ("bfloat16", "float32"):
                _matches_plain_version(b, hq, hk, 160, 160, d, dtype, kw)


# the tensor-core kernel's edge cases, each with 64-row tiles (one
# warpgroup: B * Hq * ceil(Sq / 128) < 132) and, where noted, 128-row tiles
BF16_CASES = [
    # b, hq, hk, sq, sk, d, kwargs
    (1, 4, 2, 300, 300, 128, dict(causal=True)),                # ragged
    (1, 4, 2, 200, 333, 64, dict(causal=False)),                # ragged, both
    (2, 32, 8, 700, 700, 128, dict(causal=True)),               # ragged, 128 rows
    (1, 4, 2, 200, 130, 128, dict(causal=True)),                # sq > sk
    (1, 4, 2, 128, 1000, 128, dict(causal=True)),               # offset rows
    (1, 4, 2, 70, 190, 96, dict(causal=True)),                  # offset, ragged
    (2, 4, 2, 70, 190, 96, dict(causal=False, window=50)),      # window only
    (2, 4, 2, 300, 300, 64, dict(causal=True, window=100)),
    (1, 4, 4, 500, 500, 64, dict(causal=True, window=100, softcap=30.0)),
    (2, 32, 16, 640, 640, 128, dict(causal=True, window=200, softcap=50.0)),
    (1, 8, 8, 256, 256, 128, dict(causal=True)),                # GQA group 1
    (1, 8, 4, 256, 256, 128, dict(causal=True)),                # group 2
    (1, 16, 2, 256, 256, 128, dict(causal=True)),               # group 8
    (3, 4, 2, 257, 257, 128, dict(causal=True)),                # B > 1
    (4, 16, 4, 384, 384, 64, dict(causal=True)),                # D 64, 128 rows
    (2, 32, 32, 512, 512, 96, dict(causal=True)),               # D 96, 128 rows
    (1, 4, 2, 64, 64, 96, dict(causal=True)),                   # one tile
    (1, 4, 2, 1, 100, 128, dict(causal=True)),                  # one row
    # long rows: 12 to 32 key tiles through the two-stage ring
    (1, 16, 8, 4096, 4096, 128, dict(causal=True)),             # 128 rows
    (1, 4, 2, 3000, 5000, 96, dict(causal=True, window=1500, softcap=50.0)),
    (2, 8, 2, 2500, 2500, 64, dict(causal=False)),              # 128 rows
    # the Pallas kernel's narrow heads: every case of its tests' widths
    # (tests/test_torch_flash.py CASES), then widths between instantiations
    (1, 2, 2, 64, 64, 32, dict(causal=True)),                   # MHA
    (2, 4, 2, 128, 128, 16, dict(causal=True)),                 # GQA
    (2, 4, 2, 100, 100, 16, dict(causal=False)),                # ragged
    (1, 4, 1, 96, 224, 32, dict(causal=True)),                  # MQA, sq < sk
    (2, 4, 2, 160, 160, 32, dict(causal=True, window=32)),
    (2, 4, 2, 160, 160, 32, dict(causal=True, softcap=20.0)),
    (1, 4, 2, 150, 150, 16, dict(causal=True, window=48, softcap=50.0)),
    (1, 2, 2, 70, 200, 16, dict(causal=False, window=64)),
    (1, 4, 2, 200, 130, 16, dict(causal=True)),                 # sq > sk
    (1, 16, 8, 2048, 2048, 16, dict(causal=True)),              # 128 rows
    (2, 4, 2, 257, 257, 8, dict(causal=True)),                  # D 8
    (1, 4, 2, 333, 333, 24, dict(causal=True)),                 # D 24
    (1, 4, 2, 300, 300, 80, dict(causal=True)),                 # D 80 -> 128
    (2, 32, 16, 640, 640, 80, dict(causal=True, window=200, softcap=50.0)),
    (1, 4, 2, 300, 300, 120, dict(causal=False, window=100)),   # D 120
]


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,kw", BF16_CASES)
def test_bf16_kernel_edge_cases(b, hq, hk, sq, sk, d, kw):
    args = _card(7 * sq + sk + d, b, hq, hk, sq, sk, d, "bfloat16")
    launches = fa.flash_attention_cuda.launches
    out = ops.flash_attention(*args, **kw)
    want = ref.attention_ref(*args, **kw)
    torch.cuda.synchronize()
    plan = fa.flash_attention_cuda.last_plan
    assert fa.flash_attention_cuda.launches == launches + 1
    assert plan["variant"] == "wgmma"
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert plan["block_q"] == (64 if b * hq * -(-sq // 128) < n_sm else 128)
    assert out.dtype == torch.bfloat16 and bool(out.isfinite().all())
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert worst_row_error(out, want) < ROW_TOL["bfloat16"]
    if kw.get("causal") and sq > sk:
        # the first sq - sk rows see no key and give 0
        assert torch.count_nonzero(out[:, :, :sq - sk]) == 0


# the f32 kernel's 64 x 64 tiles: Sq and Sk one past a tile, D 8, 24, 40,
# 56, 88, 104 and 120, GQA groups of 4, rows without keys, window with
# softcap
# (b, hq, hk, sq, sk, d, kwargs); then (with the plan's split) f32 query
# tiles that leave SMs idle, whose keys split over several blocks: a window
# that leaves some splits no key tile, rows that see no key in any split
F32_EDGES = [
    (1, 4, 2, 65, 65, 64, dict(causal=True)),
    (2, 4, 2, 129, 193, 128, dict(causal=True)),
    (1, 8, 2, 200, 200, 8, dict(causal=True)),
    (1, 8, 2, 150, 257, 24, dict(causal=False)),
    (1, 4, 1, 130, 130, 40, dict(causal=True, window=40, softcap=30.0)),
    (2, 4, 2, 100, 65, 120, dict(causal=True)),                 # masked rows
    # every layout of the forward's P V columns (full 32-column groups, and
    # a 16-column tail): 88 (3 groups), 104 (3 and a tail), 56 (2)
    (1, 4, 2, 100, 100, 88, dict(causal=True)),
    (1, 4, 2, 90, 130, 104, dict(causal=True, window=60, softcap=30.0)),
    (1, 4, 2, 70, 70, 56, dict(causal=False)),
]
SPLIT_CASES = [
    (1, 4, 4, 64, 2048, 64, dict(causal=True), 16),
    (1, 8, 2, 100, 1500, 120, dict(causal=True, window=700, softcap=50.0), 8),
    (2, 4, 2, 300, 300, 64, dict(causal=True), 2),             # f32 ragged
    (1, 2, 2, 1200, 1100, 64, dict(causal=True), 3),
    (1, 16, 8, 128, 1000, 128, dict(causal=True), 4),           # offset rows
    # Qwen3-Next's attention in f32: the whole-width kernel, 1,024 blocks
    (1, 16, 2, 4096, 4096, 256, dict(causal=True), 1),
]


def test_f32_tile_edges_and_key_splits_match_plain_version():
    """At the f32 tiles' edges (F32_EDGES) and where the keys split
    (SPLIT_CASES, each with the plan's split): the plain version's output
    and lse (+inf exactly on rows without keys), bitwise the same in two
    calls, the output with lse bitwise the output without, and zeros on
    rows without keys.  (One test over both lists: the collection's size
    decides xdist's first chunks, ROADMAP Queue C.)"""
    n_sm = None
    for case in [(*c, None) for c in F32_EDGES] + SPLIT_CASES:
        b, hq, hk, sq, sk, d, kw, split = case
        q, k, v = _card(sq + 5 * sk + d, b, hq, hk, sq, sk, d, "float32")
        n_sm = n_sm or torch.cuda.get_device_properties(0).multi_processor_count
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        plan = fa.flash_attention_cuda.last_plan
        assert plan["variant"] == variant(d, "float32"), case
        assert plan["split"] == (fa.key_split(b * hq * -(-sq // 64), sk, n_sm)
                                 if split is None else split), case
        again = fa.flash_attention_cuda(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        lse0 = ref.attention_lse_ref(q, k, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, again), case
        torch.testing.assert_close(out, want, rtol=TOL["float32"],
                                   atol=TOL["float32"], msg=str(case))
        assert worst_row_error(out, want) < ROW_TOL["float32"], case
        none = torch.isinf(lse0)
        assert torch.equal(torch.isposinf(lse), none), case
        torch.testing.assert_close(lse[~none], lse0[~none], rtol=0,
                                   atol=1e-4, msg=str(case))
        if kw.get("causal") and sq > sk:
            assert torch.count_nonzero(out[:, :, :sq - sk]) == 0, case


def test_cuda_kernel_refuses_what_it_does_not_take():
    q, k, v = _card(1, 1, 4, 2, 64, 64, 0, "float32")
    with pytest.raises(ValueError, match="head dim 0 is below 1"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _card(1, 1, 4, 3, 64, 64, 136, "bfloat16")
    with pytest.raises(ValueError, match="not a multiple of 3 kv heads"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _card(1, 1, 4, 2, 64, 64, 64, "float32")
    with pytest.raises(ValueError, match="not contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="float16"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())

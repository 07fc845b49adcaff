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
from torch_ref_guard import revive_reference_inf  # noqa: F401

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
    # widths the card runs on an instantiation of a wider class
    (1, 2, 2, 64, 64, 8, dict(causal=True)),
    (1, 4, 2, 100, 100, 24, dict(causal=False)),                 # ragged
    (1, 4, 2, 96, 96, 80, dict(causal=True, window=32)),
]
# widths off the multiple of 8 (the card pads them) and past 128 (on the
# card the whole-width kernels; f32 520 in three slices)
WIDE_CASES = [
    (1, 4, 2, 64, 64, 4, dict(causal=True)),
    (1, 4, 2, 100, 100, 20, dict(causal=True, window=32, softcap=20.0)),
    (1, 4, 2, 96, 96, 136, dict(causal=True)),
    (1, 4, 1, 64, 128, 192, dict(causal=True, window=48)),       # sq < sk
    (1, 4, 2, 80, 80, 256, dict(causal=True, softcap=30.0)),
    (1, 2, 1, 64, 64, 520, dict(causal=False)),
]


def _matches_pallas(b, hq, hk, sq, sk, d, kw, dtype):
    arrays = _qkv(sq * 7 + sk, b, hq, hk, sq, sk, d)
    out = ops.flash_attention(*_port(arrays, dtype), **kw)
    want = flash_attention_pallas(*_jax(arrays, dtype), bq=64, bk=64,
                                  interpret=True, **kw)
    assert out.dtype == getattr(torch, dtype) and out.shape == want.shape
    _close(out, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,kw", CASES)
def test_plain_version_matches_pallas(b, hq, hk, sq, sk, d, kw, dtype):
    _matches_pallas(b, hq, hk, sq, sk, d, kw, dtype)


def test_plain_version_matches_pallas_at_every_width():
    """Every case of WIDE_CASES, in f32 and bf16, as
    test_plain_version_matches_pallas holds its cases.  (One test over the
    list: the collection's size decides xdist's first chunks, ROADMAP
    Queue C.)"""
    for case in WIDE_CASES:
        for dtype in ("float32", "bfloat16"):
            _matches_pallas(*case, dtype)


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
    # a meta tensor traces the card's program: the kernel's op gives the
    # output's shape and nothing is launched
    out = ops.flash_attention(*[x.to("meta") for x in args])
    assert out.device.type == "meta" and out.shape == args[0].shape
    assert fa.flash_attention_cuda.launches == launches


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises rather than compute on the CPU."""
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(*_port(_qkv(4, 1, 2, 2, 8, 8, 64), "float32"))


def test_kernel_wrapper_refuses_autograd():
    """The ctypes wrapper's output has no ``grad_fn``: under autograd, with
    an input that needs a gradient, it raises rather than return a result
    cut off from the graph (``FlashAttention`` is the differentiable form).
    Without a gradient to lose it goes on to its other checks."""
    q, k, v = _port(_qkv(6, 1, 2, 2, 8, 8, 64), "float32")
    q.requires_grad_(True)
    v.requires_grad_(True)
    with pytest.raises(RuntimeError, match="gradient of q, v would be lost"):
        fa.flash_attention_cuda(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(q, k, v)


# --------------------------------------------------------- the launch plan
# Key tile, threads and shared-memory bytes of each instantiation, by
# (dtype, D, query rows), written out from csrc/flash_attention.cu's layout
# (every other width runs the instantiation of ``fa.kernel_width``):
# bf16 (wgmma_smem_bytes) is 1 KB of alignment, Q and two K and two V
# stages of 128-key tiles at 64 or 128 bf16 columns, and 64 bytes of
# mbarriers; f32 (f32_smem_bytes) is Q, two K and two V stages of 64 rows
# at D + 4 floats, and P at 72 floats.
GEOMETRY = {
    (torch.bfloat16, 64, 64): (128, 128, 74_816),
    (torch.bfloat16, 64, 128): (128, 256, 83_008),
    (torch.bfloat16, 96, 64): (128, 128, 148_544),
    (torch.bfloat16, 96, 128): (128, 256, 164_928),
    (torch.bfloat16, 128, 64): (128, 128, 148_544),
    (torch.bfloat16, 128, 128): (128, 256, 164_928),
    (torch.float32, 64, 64): (64, 256, 105_472),
    (torch.float32, 96, 64): (64, 256, 146_432),
    (torch.float32, 128, 64): (64, 256, 187_392),
}
# bf16 past 256 columns (any width), 64 query rows: 1 KB of alignment, a
# ring of three stages of two 64 x 128 tiles and 64 bytes of mbarriers
WIDE_GEOMETRY = {torch.bfloat16: (64, 128, 1024 + 3 * 2 * 64 * 128 * 2 + 64)}


def f32_256_geometry(width: int) -> tuple[int, int, int]:
    """The f32 whole-width forward past 128 columns: 64 keys a tile, 256
    threads, and four ring stages of 64-row pieces of 64 columns at 68
    floats a row, Q of 64 rows at the whole width (its pieces side by
    side, 4 floats of pad) up to 256 columns, past it a piece of Q beside
    each piece of K instead, and P of 64 x 68."""
    pieces = -(-width // 64)
    if width <= 256:
        floats = 4 * 64 * 68 + 64 * (64 * pieces + 4) + 64 * 68
    else:
        floats = 4 * 2 * 64 * 68 + 64 * 68
    return 64, 256, floats * 4

PLAN_SHAPES = [
    # b, hq, hk, sq, sk, then the bf16 plan's query rows and blocks along
    # the query axis, and the f32 plan's query tiles (64 rows) and key
    # split: the serving prefill, 8192 tokens, a gemma2-27b local layer,
    # phi3's batch, decode-like and ragged shapes (4 and 40 tiles: 4 and 5
    # key tiles split 2 ways), and offset rows (32 tiles on 132 SMs: their
    # 16 key tiles split 4 ways)
    (1, 16, 8, 512, 512, 64, 8, 8, 1),
    (1, 16, 8, 8192, 8192, 128, 64, 128, 1),
    (1, 32, 16, 8192, 8192, 128, 64, 128, 1),
    (2, 32, 32, 1024, 1024, 128, 8, 16, 1),
    (1, 4, 4, 1, 256, 64, 1, 1, 2),
    (2, 4, 2, 300, 300, 64, 5, 5, 2),
    (1, 16, 8, 128, 1000, 64, 2, 2, 4),
]


@pytest.mark.parametrize("key", list(GEOMETRY), ids=str)
def test_kernel_geometry_fits_the_card_and_wgmma(key):
    """Every instantiation's shared memory is within a block's 232,448
    bytes, and its tiles are ones wgmma takes: 64-row multiples, N (the key
    tile) a multiple of 8 up to 256, K (D) a multiple of 16."""
    dtype, d, block_q = key
    block_k, threads, smem = GEOMETRY[key]
    assert fa.geometry(dtype, d, block_q) == GEOMETRY[key]
    assert smem <= 232_448 and threads <= 1024
    assert block_q % 64 == 0 and d % 16 == 0
    assert block_k % 8 == 0 and block_k <= 256


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("b,hq,hk,sq,sk,rows,gx_bf16,gx_f32,split",
                         PLAN_SHAPES)
def test_kernel_plan_fits_the_card(b, hq, hk, sq, sk, rows, gx_bf16, gx_f32,
                                   split, d, dtype):
    """The plan at each shape: its query rows, the instantiation's geometry,
    a grid of (query tiles x key splits, heads, batch) and the splits'
    scratch (bf16 never splits)."""
    plan = fa.kernel_plan(b, hq, hk, sq, sk, d, dtype)
    if dtype == torch.bfloat16:
        block_q, gx, split = rows, gx_bf16, 1
    else:
        block_q, gx = 64, gx_f32
    block_k, threads, smem = GEOMETRY[(dtype, fa.kernel_width(d), block_q)]
    assert plan == {
        "variant": "wgmma" if dtype == torch.bfloat16 else "cuda_cores",
        "block_q": block_q, "block_k": block_k, "threads": threads,
        "smem": smem, "grid": (gx * split, hq, b), "split": split,
        "scratch": split * b * hq * sq * (d + 2) * 4 if split > 1 else 0,
        "width": d, "slices": 1, "pair_chunks": 1}


SPLIT_PLANS = [
    # b, hq, sq, sk, the card's SMs, the f32 plan's key split
    (1, 16, 128, 1000, 132, 4),     # offset rows: 32 tiles, 4 x 32 = 128
    (1, 16, 128, 1000, 114, 3),     # an H100 PCIe's 114 SMs: 3 x 32 = 96
    (1, 4, 64, 4096, 132, 16),      # 4 tiles of 64 key tiles: at most 16
    (1, 4, 64, 2048, 132, 16),      # 32 key tiles: 16 splits of 2
    (2, 8, 64, 512, 132, 4),        # 16 tiles, 8 key tiles: 4 splits of 2
    (2, 20, 64, 1500, 132, 3),      # 40 tiles: 3 x 40 = 120
    (1, 66, 64, 1024, 132, 2),      # 66 tiles: 2 x 66 = 132
    (1, 67, 64, 1024, 132, 1),      # 67 tiles: 2 x 67 > 132
    (1, 132, 64, 4096, 132, 1),     # the grid fills the card
    (1, 16, 128, 255, 132, 2),      # 4 key tiles: 2 splits of 2
    (1, 16, 128, 100, 132, 1),      # 2 key tiles: one split's worth
    (1, 2, 64, 64, 132, 1),         # the Pallas MHA shape: one key tile
]


def test_f32_plan_splits_keys_when_the_grid_leaves_sms_idle():
    """f32 query tiles that leave SMs idle share their keys among ``split``
    blocks (at least 2 key tiles each, at most 16, within one wave); the
    grid's x counts tiles x splits, and the scratch holds each split's O, m
    and l of every row.  bf16 on the same shapes does not split.  (One test
    over SPLIT_PLANS: the collection's size decides xdist's first chunks,
    ROADMAP Queue C.)"""
    for b, hq, sq, sk, n_sm, split in SPLIT_PLANS:
        tiles = -(-sq // 64)
        for d in (16, 64, 80, 128):
            plan = fa.kernel_plan(b, hq, hq, sq, sk, d, torch.float32, n_sm)
            what = (b, hq, sq, sk, n_sm, d)
            assert plan["split"] == split, what
            assert plan["grid"] == (tiles * split, hq, b), what
            assert tiles * split * hq * b <= max(n_sm, tiles * hq * b), what
            assert plan["scratch"] == (split * b * hq * sq * (d + 2) * 4
                                       if split > 1 else 0), what
            bf16 = fa.kernel_plan(b, hq, hq, sq, sk, d, torch.bfloat16, n_sm)
            assert (bf16["split"], bf16["scratch"]) == (1, 0), what
        assert fa.key_split(tiles * hq * b, sk, n_sm) == split


@pytest.mark.parametrize("b,hq,sq,rows", [
    (1, 16, 512, 64),      # serving prefill: 64 blocks of 128 rows < 132
    (1, 16, 8192, 128),    # 8192 tokens: 1024 blocks
    (1, 131, 128, 64),     # 131 < 132
    (1, 132, 128, 128),    # 132: not fewer than the SMs
    (1, 33, 512, 128),     # 33 x 4 = 132
    (2, 16, 257, 64),      # 2 x 16 x 3 = 96
    (2, 32, 1024, 128),
])
def test_kernel_plan_drops_to_64_rows_below_the_sm_count(b, hq, sq, rows):
    """The 64-row tile exactly when ``B * Hq * ceil(Sq / 128) < 132``."""
    plan = fa.kernel_plan(b, hq, hq, sq, sq, 128, torch.bfloat16)
    assert (b * hq * -(-sq // 128) < 132) == (rows == 64)
    assert plan["block_q"] == rows


@pytest.mark.parametrize("n_sm,rows", [(132, 64), (114, 128), (120, 128),
                                        (121, 64)])
def test_kernel_plan_counts_the_cards_sms(n_sm, rows):
    """The switch to 64-row tiles follows the card's SM count: 30 heads of
    512 tokens make 120 blocks of 128 rows, fewer than an H100 SXM's 132
    SMs but not than an H100 PCIe's 114."""
    plan = fa.kernel_plan(1, 30, 30, 512, 512, 128, torch.bfloat16, n_sm)
    assert plan["block_q"] == rows


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_plan_variant_by_dtype(d):
    """bf16 on the tensor cores, f32 on the CUDA cores: no other choice."""
    for dtype, variant in ((torch.bfloat16, "wgmma"),
                           (torch.float32, "cuda_cores")):
        assert fa.kernel_plan(1, 16, 8, 512, 512, d, dtype)["variant"] == \
            variant


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 4, 64, 0), torch.bfloat16, "head dim 0 is below 1"),
    ((1, 4, 64, 0), torch.float32, "head dim 0 is below 1"),
    ((1, 4, 64, 64), torch.float16, "float16"),
    ((65536, 1, 8, 256), torch.float64, "float64"),
    ((1, 65536, 8, 20), torch.float16, "float16"),
])
def test_kernel_wrapper_raises_on_what_the_plan_refuses(shape, dtype, match):
    """The plan refuses before any device is looked at: meta tensors (no
    memory) reach it here, and the wrapper raises its ValueError."""
    q = torch.empty(shape, dtype=dtype, device="meta")
    kv = torch.empty(shape[0], 1, shape[2], shape[3], dtype=dtype,
                     device="meta")
    with pytest.raises(ValueError, match=match):
        fa.kernel_plan(*shape[:2], 1, shape[2], shape[2], shape[3], dtype)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_cuda(q, kv, kv)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_width_of_each_head_width(d):
    """64, 96 and 128 run their own instantiations; any other width the
    narrowest class that holds it, 64 or 128 columns."""
    want = d if d in (64, 96, 128) else 64 if d < 64 else 128
    assert fa.kernel_width(d) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [0])
def test_both_plans_refuse_widths_outside_the_domain(d, dtype):
    """A head width below 1 (0 here, -8 too): no kernel takes it (every
    other width runs, padded or in column slices)."""
    for width in (d, -8):
        for plan in (fa.kernel_plan, fa.kernel_plan_bwd):
            with pytest.raises(ValueError, match=f"head dim {width} "):
                plan(1, 2, 2, 64, 64, width, dtype)


# d, the kernels' width (padded), the column slices of bf16 (the native
# kernels at widths 136-256, one slice; past 256 slices of 128 columns) and
# of f32 (the whole-width kernels: one slice up to 256 columns, past it
# slices of up to 256)
WIDTHS = [(1, 8, 1, 1), (4, 8, 1, 1), (12, 16, 1, 1), (20, 24, 1, 1),
          (100, 104, 1, 1), (128, 128, 1, 1), (129, 136, 1, 1),
          (136, 136, 1, 1), (192, 192, 1, 1), (256, 256, 1, 1),
          (257, 264, 3, 2), (512, 512, 4, 2), (520, 520, 5, 3),
          (1000, 1000, 8, 4)]
# the native kernels' (block_q, block_k, threads, shared memory) at 64-row
# blocks (24 blocks of 128 would leave SMs idle): the forward's 1 KB of
# alignment, Q of 64 rows and two stages of K and of V of 64 rows, 256 bf16
# columns each, 128 bytes of mbarriers; the backward's
# dK/dV (K, V, two stages of Q and dO, two f32 64 x 64 P^T buffers, 4 x 64
# floats of lse and delta, 64 bytes) and dQ (Q and dO of 128 rows, two
# stages of K, one of V, 64 bytes, 128 rows' lse and delta)
NATIVE_GEOMETRY = (64, 64, 128, 1024 + (64 + 4 * 64) * 512 + 128)
NATIVE_BWD_SMEM = (1024 + 6 * 64 * 512 + 2 * 64 * 64 * 4 + 4 * 64 * 4 + 64,
                   1024 + 7 * 64 * 512 + 64 + 2 * 128 * 4)


def test_both_plans_take_every_width():
    """Every head width >= 1 (WIDTHS, f32 and bf16): the kernels' width is
    d padded to a multiple of 8 (zero columns).  Past 128 columns f32 plans
    the whole-width kernels (one slice up to 256 columns, past it at most
    ceil(width / 256) slices, each forming S over the whole width: 64-row
    blocks, the grids' x counting blocks x slices x splits, the split
    seeing those blocks); bf16 at widths
    136-256 the native kernels (no slices; the dK/dV grid's x counts key
    blocks x shares of the group), past 256 the wide kernels, whose slices
    of 128 columns each form S over the whole width (64-row blocks in both
    plans, shared memory that does not grow with the width).  (One test
    over the widths: the collection's size decides xdist's first chunks,
    ROADMAP Queue C.)"""
    b, hq, hk, sq, sk = 2, 4, 2, 300, 300
    for d, width, bf16_slices, f32_slices in WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            what = (d, dtype)
            native = dtype == torch.bfloat16 and 136 <= width <= 256
            slices = f32_slices if dtype == torch.float32 else bf16_slices
            assert slices <= max(1, -(-width // 256)) or \
                dtype == torch.bfloat16, what
            fwd = fa.kernel_plan(b, hq, hk, sq, sk, d, dtype)
            bwd = fa.kernel_plan_bwd(b, hq, hk, sq, sk, d, dtype)
            assert (fa.padded_width(d), fa.slices(d, dtype)) == \
                (width, slices), what
            assert (fwd["width"], fwd["slices"]) == (width, slices), what
            assert (bwd["width"], bwd["slices"]) == (width, slices), what
            assert fwd["smem"] <= fa.MAX_SMEM, what
            assert max(bwd["dkdv"]["smem"], bwd["dq"]["smem"]) <= \
                fa.MAX_SMEM, what
            if native:   # 5 blocks of 64 rows; 5 key blocks in 2 shares
                assert fwd["variant"] == bwd["variant"] == "wgmma_256", what
                assert (fwd["block_q"], fwd["block_k"], fwd["threads"],
                        fwd["smem"]) == NATIVE_GEOMETRY, what
                assert fwd["grid"] == (5, hq, b) and fwd["scratch"] == 0
                assert (bwd["dkdv"]["rows"], bwd["dq"]["rows"]) == (64, 128)
                assert (bwd["dkdv"]["smem"], bwd["dq"]["smem"]) == \
                    NATIVE_BWD_SMEM, what
                assert bwd["dkdv"]["head_split"] == 2, what
                assert bwd["grids"]["dkdv"] == (10, hk, b), what
                assert bwd["grids"]["dq"] == (3, hq, b), what
                assert bwd["scratch"] == 2 * 2 * b * hk * sk * width * 4
                continue
            if width <= 128:
                assert fwd["smem"] == GEOMETRY[(
                    dtype, fa.kernel_width(d), fwd["block_q"])][2], what
                continue
            f32 = dtype == torch.float32
            assert fwd["variant"] == bwd["variant"] == (
                "cuda_cores_256" if f32 else "wgmma"), what
            assert (fwd["block_q"], fwd["block_k"], fwd["threads"],
                    fwd["smem"]) == (64, *(f32_256_geometry(width) if f32
                                           else WIDE_GEOMETRY[dtype])), what
            assert fwd["grid"] == (5 * slices * fwd["split"], hq, b), what
            assert fwd["scratch"] == (
                fwd["split"] * b * hq * sq * (width + 2) * 4
                if fwd["split"] > 1 else 0), what
            assert bwd["dkdv"]["rows"] == bwd["dq"]["rows"] == 64, what
            assert bwd["grids"]["dkdv"][1:] == (hk, b), what
            assert bwd["grids"]["dq"] == (5 * slices * bwd["dq"]["split"],
                                          hq, b), what
            # the split rule sees the slices' blocks: f32 two waves of
            # 132 SMs, at most a split a key tile (5 of them)
            assert fwd["split"] == (min(5, 264 // (b * hq * 5 * slices))
                                    if f32 else 1), what
            assert bwd["dq"]["split"] == fwd["split"], what
            if f32:   # a dK/dV block walks at most 2 heads x 5 query tiles
                kv_blocks = b * hk * 5 * slices
                assert bwd["dkdv"]["split"] == min(10, 264 // kv_blocks)
                assert bwd["grids"]["dkdv"][0] == \
                    5 * slices * bwd["dkdv"]["split"], what


# (b, h), then the grid's (y, z)
HEAD_GRIDS = [
    (1, 1, (1, 1)), (65535, 65535, (65535, 65535)),
    (65536, 1, (65535, 2)), (1, 65536, (65535, 2)),
    (70000, 2, (65535, 3)), (3, 100000, (65535, 5)),
    (2**31 - 1, 1, (65535, 32769)),
]


def test_head_grid_folds_pairs_past_the_grid():
    """(h, b) on the grid's y and z while both fit 65,535; else the b * h
    pairs (at most one launch's ``MAX_PAIRS``) folded onto y (65,535) and
    z, covering every pair.  Both plans fold batches and head counts past
    65,535 in both dtypes (the Pallas kernel's grid takes them), and past
    one launch's pairs in several (``_pairs_past_one_launch_go_in_several``).
    (One test over HEAD_GRIDS: the collection's size decides xdist's first
    chunks, ROADMAP Queue C.)"""
    for b, h, grid in HEAD_GRIDS:
        y, z = fa.head_grid(h, b)
        assert (y, z) == grid, (b, h)
        assert y <= fa.MAX_GRID_YZ and z <= fa.MAX_GRID_YZ
        assert y * z >= h * b and y * (z - 1) < h * b
    for dtype in (torch.bfloat16, torch.float32):
        for b, hq, hk in ((70000, 2, 1), (1, 70000, 70000), (2, 65536, 8)):
            fwd = fa.kernel_plan(b, hq, hk, 8, 8, 16, dtype)
            bwd = fa.kernel_plan_bwd(b, hq, hk, 8, 8, 16, dtype)
            assert fwd["grid"][1:] == fa.head_grid(hq, b)
            assert bwd["grids"]["dq"][1:] == fa.head_grid(hq, b)
            assert bwd["grids"]["dkdv"][1:] == fa.head_grid(hk, b)
            for grid in (fwd["grid"], bwd["grids"]["dq"],
                         bwd["grids"]["dkdv"]):
                assert max(grid[1:]) <= fa.MAX_GRID_YZ
    _pairs_past_one_launch_go_in_several()


# b, hq, hk, the pairs a launch may take, then pair_chunks's launches
PAIR_CHUNKS = [
    (3, 4, 2, 12, []),
    (3, 4, 2, 6, [((0, 3), (0, 2)), ((3, 6), (0, 2))]),
    (3, 4, 2, 5, [((0, 2), (0, 2)), ((2, 4), (0, 2)), ((4, 6), (0, 2))]),
    (2, 6, 1, 4, [((0, 1), (0, 4)), ((0, 1), (4, 6)), ((1, 2), (0, 4)),
                  ((1, 2), (4, 6))]),
]


def _pairs_past_one_launch_go_in_several():
    """Past ``MAX_PAIRS`` (batch, head) pairs (the kernels' pair index and
    TMA's coordinates are 32-bit) the ops launch once for each of
    ``pair_chunks``'s ranges over the [b * hk, group] view of the query
    heads: every pair in exactly one launch, none over the limit, a group
    cut into runs of heads only where it alone passes the limit.  Both
    plans then give the first launch's plan and their count: 2^31 pairs
    (bf16, 8 columns, one query row: 69 GB of q and o, which a card holds)
    take two launches, 2^32 three, and no grid is refused."""
    for b, hq, hk, limit, want in PAIR_CHUNKS:
        chunks = fa.pair_chunks(b, hq, hk, limit)
        assert chunks == want, (b, hq, hk, limit)
        group, seen = hq // hk, []
        for (r0, r1), (h0, h1) in chunks or [((0, b * hk), (0, group))]:
            assert (r1 - r0) * (h1 - h0) <= limit or not chunks
            seen += [(r, h) for r in range(r0, r1) for h in range(h0, h1)]
        assert sorted(seen) == [(r, h) for r in range(b * hk)
                                for h in range(group)], (b, hq, hk, limit)
    assert fa.pair_chunks(65535, 32768, 1) == []
    for dtype in (torch.bfloat16, torch.float32):
        for (b, hq, hk), n, first in (((65536, 32768, 1), 2, (65535, 32768)),
                                      ((65536, 65536, 1), 3, (32767, 65536)),
                                      ((2, 2**31, 2), 4, (1, 2**30)),
                                      ((1, 2**32, 1), 3, (1, 2**31 - 1))):
            chunks = fa.pair_chunks(b, hq, hk)
            assert len(chunks) == n, (b, hq, hk)
            (r0, r1), (h0, h1) = chunks[0]
            assert (r1 - r0, h1 - h0) == first, (b, hq, hk)
            fwd = fa.kernel_plan(b, hq, hk, 1, 1, 8, dtype)
            bwd = fa.kernel_plan_bwd(b, hq, hk, 1, 1, 8, dtype)
            assert fwd["pair_chunks"] == bwd["pair_chunks"] == n
            assert fwd["grid"][1:] == fa.head_grid(*first[::-1])
            assert bwd["grids"]["dq"][1:] == fa.head_grid(*first[::-1])
            assert bwd["grids"]["dkdv"][1:] == fa.head_grid(1, first[0])


def test_padding_the_head_axis_is_exact():
    """The op's padding: zero columns to a multiple of 8, the scale of the
    real width, the output sliced back, equals the unpadded function (zero
    columns add exact zeros to q.k and give zero columns of o), at D 4, 20
    and 136."""
    for d in (4, 20, 136):
        q, k, v = _port(_qkv(d, 1, 4, 2, 70, 70, d), "float32")
        kw = dict(causal=True, window=40, softcap=20.0, scale=d ** -0.5)
        want = ref.attention_ref(q, k, v, **kw)
        width = fa.padded_width(d)
        padded = fa._pad(width, q, k, v)
        assert all(x.shape[-1] == width and x.is_contiguous() for x in padded)
        assert all(torch.count_nonzero(x[..., d:]) == 0 for x in padded)
        out = fa._unpad(d, ref.attention_ref(*padded, **kw))[0]
        assert out.shape == want.shape and out.is_contiguous()
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
        lse = ref.attention_lse_ref(*padded[:2], **kw)
        torch.testing.assert_close(lse, ref.attention_lse_ref(q, k, **kw),
                                   rtol=1e-6, atol=1e-6)


def test_ops_trace_every_width_on_meta_tensors():
    """The kernels' ops plan any width (D 4, 20, 136, 520) on meta tensors
    (the dry-run's program) and give the unpadded shapes, launching
    nothing."""
    launches = fa.flash_attention_cuda.launches
    for d in (4, 20, 136, 520):
        q = torch.empty(2, 4, 64, d, dtype=torch.bfloat16, device="meta")
        k = torch.empty(2, 2, 64, d, dtype=torch.bfloat16, device="meta")
        out, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, k, k, True, None, 0.0, d ** -0.5, True)
        assert out.shape == q.shape and lse.shape == (2, 4, 64)
        grads = torch.ops.repro_torch.flash_attention_bwd(
            q, k, k, out, lse, out, True, None, 0.0, d ** -0.5)
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    assert fa.flash_attention_cuda.launches == launches


def _registry_heads() -> list:
    from repro_torch.configs import ARCH_IDS, get_config
    return [(arch, smoke, get_config(arch, smoke=smoke).d_head)
            for arch in ARCH_IDS for smoke in (True, False)]


@pytest.mark.parametrize("arch,smoke,d", _registry_heads())
def test_every_registry_head_width_is_in_both_plans_domain(arch, smoke, d):
    """Every config of the registry, smoke and full, has heads both flash
    plans take in f32 and in bf16: the smoke models run on the card."""
    assert d in fa.HEAD_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        fa.kernel_plan(2, 4, 2, 128, 128, d, dtype)
        fa.kernel_plan_bwd(2, 4, 2, 128, 128, d, dtype)

"""The flash-attention backward's math against the JAX package's gradient,
on the CPU.

The JAX package has no backward kernel: it trains through ``flash_xla``
(``repro/models/attention.py``), differentiated by ``jax.vjp``.  The port's
backward kernel computes ``ref.attention_bwd_ref``'s arithmetic from the
forward's output and its row log-sum-exp (``ref.attention_lse_ref``); on
the CPU, ``FlashAttention`` runs exactly these plain versions.  Both are
held against ``jax.vjp(flash_xla)`` on the same numpy inputs and a random
dO, in f32 at the gradient tolerance of ``test_torch_train.py`` (rtol 1e-4,
atol 1e-6: the two add in other orders).  The lse is held against
``jax.nn.logsumexp`` of the masked logits.  The kernel itself runs only on
a card: ``test_torch_flash_bwd_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_xla
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

RTOL, ATOL = 1e-4, 1e-6

CASES = [
    # b, hq, hk, sq, sk, d, kwargs
    (1, 4, 2, 48, 48, 64, dict(causal=True)),                     # GQA 4/2
    (1, 4, 2, 40, 72, 64, dict(causal=True)),                     # Sq < Sk
    (1, 4, 2, 72, 40, 64, dict(causal=True)),   # Sq > Sk: 32 rows see no key
    (1, 2, 2, 64, 64, 128, dict(causal=True, window=16)),
    (1, 4, 2, 48, 48, 96, dict(causal=True, softcap=50.0)),       # phi3's D
    (1, 4, 2, 64, 64, 128, dict(causal=True, window=24, softcap=5.0)),
    (2, 2, 2, 37, 53, 64, dict(causal=False)),                    # ragged
    (1, 2, 1, 1, 45, 64, dict(causal=False)),   # one query row (cross decode)
    # the Pallas kernel's narrow heads, which the smoke configs use
    (1, 4, 2, 48, 48, 16, dict(causal=True, window=16, softcap=50.0)),
    (1, 4, 1, 40, 72, 32, dict(causal=True)),                     # Sq < Sk
    # widths the card runs on an instantiation of a wider class
    (1, 2, 2, 56, 40, 8, dict(causal=True)),    # Sq > Sk: 16 rows see no key
    (2, 2, 2, 37, 53, 24, dict(causal=False)),                    # ragged
    (1, 4, 2, 48, 48, 80, dict(causal=True, window=16)),
]
# widths off the multiple of 8 (padded on the card) and past 128 (the wide
# kernels' column slices)
WIDE_CASES = [
    (1, 4, 2, 48, 48, 4, dict(causal=True)),
    (1, 4, 2, 40, 72, 20, dict(causal=True, window=16, softcap=50.0)),
    (1, 4, 2, 48, 48, 136, dict(causal=True)),
    (1, 4, 2, 48, 48, 192, dict(causal=True, window=16)),
    (1, 2, 2, 56, 40, 256, dict(causal=True, softcap=5.0)),   # Sq > Sk
    (1, 2, 1, 37, 53, 520, dict(causal=False)),               # ragged
    (1, 4, 1, 48, 48, 192, dict(causal=True, window=16)),     # MQA 4/1
]
# MQA 4/1 past 128 columns: dk sums the terms of 4 query heads, and the f32
# sums of the plain version and of jax.vjp alike land up to ~1.8e-6 from the
# f64 gradient (0.44 and 0.80 units below), past ATOL where an element is
# near zero.  There dk is held elementwise to the f64 gradient (numpy, the
# conventions of ``_masked_logits``) within one unit of f32 rounding of the
# magnitude of its terms, u A with u = 2^-24 and A = scale sum |dS^T| |q|
# over the group, |dS| = |P| (|dO| |V|^T + rowsum |dO o|): the first-order
# bound of each f32 product and sum that makes it; and the plain version to
# jax.vjp within 2 u A.  dq and dv are held as every case.
F64_HELD = [(1, 4, 1, 48, 48, 192, dict(causal=True, window=16))]
IDS = [f"{c[0]}x{c[1]}/{c[2]}x{c[3]}x{c[4]}xD{c[5]}-" +
       "-".join(f"{k}{v}" for k, v in c[6].items()) for c in CASES]


def _inputs(seed, b, hq, hk, sq, sk, d):
    """q, k, v and dO, standard normal (logits of about unit size: the
    softcap of 5 bends them by a few per cent)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d),
                             (b, hq, sq, d)))
    return q, k, v, do


def _jax_vjp(q, k, v, do, kw):
    """(out, (dq, dk, dv)) of the reference's flash_xla by jax.vjp."""
    kw = {"window": None, "softcap": 0.0, **kw}
    scale = q.shape[-1] ** -0.5
    out, vjp = jax.vjp(lambda q_, k_, v_: flash_xla(q_, k_, v_, scale=scale,
                                                    **kw),
                       *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _masked_logits(q, k, kw):
    """The capped logits ``[B, Hq, Sq, Sk]`` with -inf where masked, in
    numpy, from the reference's conventions."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    kk = np.repeat(k, hq // hk, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q, kk) * d ** -0.5
    if kw.get("softcap"):
        s = kw["softcap"] * np.tanh(s / kw["softcap"])
    row = np.arange(sq)[:, None] + (sk - sq)
    col = np.arange(sk)[None, :]
    valid = np.ones((sq, sk), bool)
    if kw["causal"]:
        valid &= col <= row
    if kw.get("window") is not None:
        valid &= col > row - kw["window"]
    return np.where(valid, s, -np.inf)


def _dk_f64(q, k, v, do, kw):
    """dk of attention in f64 (numpy) and the magnitude A of its terms (see
    ``F64_HELD``), both ``[B, Hk, Sk, D]``."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g, scale = hq // hk, d ** -0.5
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    s = _masked_logits(q, k, kw)
    m = np.max(s, axis=-1, keepdims=True)
    p = np.where(np.isfinite(s), np.exp(s - np.where(np.isfinite(m), m, 0)),
                 0.0)
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-300)
    vv = np.repeat(v, g, axis=1)
    o = p @ vv
    ds = p * (do @ vv.transpose(0, 1, 3, 2) - (do * o).sum(-1, keepdims=True))
    if kw.get("softcap"):
        raise ValueError("the f64 check is written without a softcap")
    abs_ds = p * (np.abs(do) @ np.abs(vv).transpose(0, 1, 3, 2)
                  + (np.abs(do) * np.abs(o)).sum(-1, keepdims=True))

    def dk_of(dscores, queries):   # scale dS^T q, summed over the group
        return scale * (dscores.transpose(0, 1, 3, 2) @ queries).reshape(
            b, hk, g, sk, d).sum(2)

    return dk_of(ds, q), dk_of(abs_ds, np.abs(q))


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _matches_jax_vjp(b, hq, hk, sq, sk, d, kw, path, f64=False):
    """The path's out, dq, dk, dv against jax.vjp's; with ``f64``, dk as
    ``F64_HELD`` holds it."""
    q, k, v, do = _inputs(sq * 7 + sk, b, hq, hk, sq, sk, d)
    jout, jgrads = _jax_vjp(q, k, v, do, kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    if path == "attention_bwd_ref":
        out = ref.attention_ref(tq, tk, tv, **kw)
        lse = ref.attention_lse_ref(tq, tk, **kw)
        grads = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    else:
        leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        out = fa.FlashAttention.apply(*leaves, kw["causal"], kw.get("window"),
                                      kw.get("softcap", 0.0), None)
        grads = torch.autograd.grad(out, leaves, tdo)
    _close(out, jout, "out")
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == torch.float32 and got.shape == want.shape
        if f64 and name == "dk":
            exact, mag = _dk_f64(q, k, v, do, kw)
            unit = 2.0 ** -24 * mag
            got = got.detach().numpy()
            assert np.all(np.abs(got - exact) <= unit), path
            assert np.all(np.abs(want - exact) <= unit), "jax.vjp"
            assert np.all(np.abs(got - want) <= 2 * unit), path
            continue
        _close(got, want, name)


@pytest.mark.parametrize("path", ["attention_bwd_ref", "FlashAttention"])
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,kw", CASES, ids=IDS)
def test_backward_matches_jax_vjp(b, hq, hk, sq, sk, d, kw, path):
    _matches_jax_vjp(b, hq, hk, sq, sk, d, kw, path)


def _lse_matches(b, hq, hk, sq, sk, d, kw):
    q, k, _, _ = _inputs(sq * 7 + sk, b, hq, hk, sq, sk, d)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(_masked_logits(q, k, kw)),
                                       axis=-1))
    got = ref.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                **kw).numpy()
    assert got.shape == (b, hq, sq) and got.dtype == np.float32
    none = np.isneginf(want)
    assert np.array_equal(np.isposinf(got), none)
    np.testing.assert_allclose(got[~none], want[~none], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,kw", CASES, ids=IDS)
def test_lse_matches_jax_logsumexp(b, hq, hk, sq, sk, d, kw):
    """lse is the natural-log log-sum-exp of the capped, masked logits;
    +inf (the backward's marker) where JAX gives -inf (no key)."""
    _lse_matches(b, hq, hk, sq, sk, d, kw)


def test_backward_and_lse_match_jax_at_every_width():
    """Every case of WIDE_CASES as test_backward_matches_jax_vjp (both
    paths) and test_lse_matches_jax_logsumexp hold theirs.  (One test over
    the list: the collection's size decides xdist's first chunks, ROADMAP
    Queue C.)"""
    for case in WIDE_CASES:
        for path in ("attention_bwd_ref", "FlashAttention"):
            _matches_jax_vjp(*case, path, f64=case in F64_HELD)
        _lse_matches(*case)


@pytest.mark.parametrize("path", ["attention_bwd_ref", "FlashAttention"])
def test_fully_masked_rows_get_zero_dq(path):
    """Sq > Sk under a causal mask: the first Sq - Sk rows see no key, give
    a zero output and exactly zero dq, and their dO reaches no dk or dv."""
    b, hq, hk, sq, sk, d = 1, 4, 2, 72, 40, 64
    q, k, v, do = map(torch.from_numpy, _inputs(5, b, hq, hk, sq, sk, d))
    hidden = sq - sk

    def grads(do):
        if path == "attention_bwd_ref":
            out = ref.attention_ref(q, k, v)
            lse = ref.attention_lse_ref(q, k)
            assert torch.isposinf(lse[:, :, :hidden]).all()
            return out, ref.attention_bwd_ref(q, k, v, out, lse, do)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.FlashAttention.apply(*leaves, True, None, 0.0, None)
        return out, torch.autograd.grad(out, leaves, do)

    out, (dq, dk, dv) = grads(do)
    assert torch.equal(out[:, :, :hidden], torch.zeros_like(out[:, :, :hidden]))
    assert torch.equal(dq[:, :, :hidden], torch.zeros_like(dq[:, :, :hidden]))
    assert dq[:, :, hidden:].abs().min() >= 0 and dq[:, :, hidden:].abs().max() > 0
    noisy = do.clone()
    noisy[:, :, :hidden] = 1e3           # dO of the hidden rows changes nothing
    _, again = grads(noisy)
    for x, y in zip((dq, dk, dv), again):
        assert torch.equal(x, y)


def test_ops_routes_gradients_through_flash_attention():
    """With grad enabled and an input that requires one, ops.flash_attention
    is ``FlashAttention`` (the same output as the plain version); otherwise
    the plain version, with no graph.  The CPU never launches a kernel."""
    q, k, v, _ = map(torch.from_numpy, _inputs(9, 1, 4, 2, 24, 24, 64))
    launches = (fa.flash_attention_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    want = ref.attention_ref(q, k, v, causal=True)
    plain = ops.flash_attention(q, k, v)
    assert torch.equal(plain, want) and plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = ops.flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert qg.grad is not None and qg.grad.shape == q.shape
    with torch.no_grad():
        assert ops.flash_attention(qg, k, v).grad_fn is None
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == launches


def test_backward_wrapper_refuses_cpu_tensors_and_autograd():
    """No fallback: the CUDA wrapper raises rather than compute on the CPU,
    and under autograd with an input that requires a gradient."""
    q, k, v, do = map(torch.from_numpy, _inputs(3, 1, 2, 2, 8, 8, 64))
    o, lse = ref.attention_ref(q, k, v), ref.attention_lse_ref(q, k)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    with pytest.raises(RuntimeError, match="gradient of q would be lost"):
        fa.flash_attention_bwd_cuda(q.requires_grad_(True), k, v, o, lse, do)


# --------------------------------------------------------- the launch plan
# The other side's rows a tile, threads and the dK/dV and dQ kernels'
# shared-memory bytes for blocks of `rows` own rows, written out from
# csrc/flash_attention_bwd.cu's layout: bf16 (dkdv_smem_bytes,
# dq_smem_bytes) 1 KB of alignment, the block's two tiles and two stages of
# the other side's two 64-row tiles of 64 or 128 bf16 columns, 64 bytes of
# mbarriers, and in dK/dV 1 KB of lse and delta a warpgroup; f32
# (cc_smem_bytes) six 64-row tiles of D + 4 floats (dK/dV: K, V and two
# stages of Q and dO; dQ: Q, dO and two stages of K and V) and a 64 x 68
# score tile.
GEOMETRY_BWD = {
    (torch.bfloat16, 64, 64): (64, 128, 1024 + 384 * 64 * 2 + 64 + 1024,
                               1024 + 384 * 64 * 2 + 64),
    (torch.bfloat16, 64, 128): (64, 256, 1024 + 512 * 64 * 2 + 64 + 2048,
                                1024 + 512 * 64 * 2 + 64),
    (torch.bfloat16, 96, 64): (64, 128, 1024 + 384 * 128 * 2 + 64 + 1024,
                               1024 + 384 * 128 * 2 + 64),
    (torch.bfloat16, 96, 128): (64, 256, 1024 + 512 * 128 * 2 + 64 + 2048,
                                1024 + 512 * 128 * 2 + 64),
    (torch.bfloat16, 128, 64): (64, 128, 1024 + 384 * 128 * 2 + 64 + 1024,
                                1024 + 384 * 128 * 2 + 64),
    (torch.bfloat16, 128, 128): (64, 256, 1024 + 512 * 128 * 2 + 64 + 2048,
                                 1024 + 512 * 128 * 2 + 64),
    (torch.float32, 64, 64): (64, 256, 121_856, 121_856),
    (torch.float32, 96, 64): (64, 256, 171_008, 171_008),
    (torch.float32, 128, 64): (64, 256, 220_160, 220_160),
}


@pytest.mark.parametrize("key", list(GEOMETRY_BWD), ids=str)
def test_backward_geometry_fits_the_card(key):
    dtype, d, rows = key
    other, threads, smem_dkdv, smem_dq = fa.geometry_bwd(dtype, d, rows)
    assert (other, threads, smem_dkdv, smem_dq) == GEOMETRY_BWD[key]
    assert max(smem_dkdv, smem_dq) <= fa.MAX_SMEM and threads <= 1024
    if dtype == torch.bfloat16:         # a warpgroup a 64 rows; k-steps of 16
        assert rows == 64 * threads // 128 and other % 16 == 0


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float32, "cuda_cores")])
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,bf16_rows,f32_split", [
    (8, 16, 8, 2048, 2048, 128, (128, 128), 1),    # internlm2 training
    (2, 20, 20, 64, 1500, 64, (128, 64), 3),       # whisper cross-attention
    (1, 32, 32, 1024, 1024, 96, (128, 128), 1),    # phi3
    (1, 8, 8, 256, 128, 64, (64, 64), 1),          # rows that see no key
    (2, 20, 20, 64, 64, 64, (64, 64), 1),          # whisper decoder
])
def test_kernel_plan_bwd(b, hq, hk, sq, sk, d, bf16_rows, f32_split, dtype,
                         variant):
    """bf16 blocks own 128 rows (two warpgroups) unless that leaves fewer
    blocks than the card's 132 SMs (whisper's decoder: 2 x 20 heads x one
    128-key block), then 64; dK/dV counts kv heads and keys, dQ query heads
    and queries.  f32 blocks own 64 rows, and f32 dQ blocks that leave SMs
    idle split their keys (whisper's cross-attention: 40 blocks, 24 key
    tiles, 3 splits); bf16 never splits."""
    plan = fa.kernel_plan_bwd(b, hq, hk, sq, sk, d, dtype)
    rows = bf16_rows if dtype == torch.bfloat16 else (64, 64)
    split = f32_split if dtype == torch.float32 else 1
    kernels = {}
    for i, (kernel, r) in enumerate(zip(("dkdv", "dq"), rows)):
        other, threads, *smem = fa.geometry_bwd(dtype, d, r)
        kernels[kernel] = {"rows": r, "other": other, "threads": threads,
                           "smem": smem[i]}
    kernels["dq"]["split"] = split
    kernels["dkdv"]["head_split"] = 1
    assert plan == {
        "variant": variant, **kernels,
        "scratch": split * b * hq * sq * d * 4 if split > 1 else 0,
        "grids": {"delta": (-(-b * hq * sq // 8),),
                  "dkdv": (-(-sk // rows[0]), hk, b),
                  "dq": (-(-sq // rows[1]) * split, hq, b)},
        "width": d, "slices": 1, "pair_chunks": 1}
    # a card with fewer SMs keeps two warpgroups where a 132-SM card drops
    # to one
    assert fa.kernel_plan_bwd(b, hq, hk, sq, sk, d, dtype, n_sm=8)["dq"][
        "rows"] == (128 if dtype == torch.bfloat16 else 64)


DQ_SPLITS = [
    # b, hq, hk, sq, sk, the card's SMs, the f32 dQ key split
    (1, 16, 16, 128, 1000, 132, 4),     # f32 offset rows: 32 dQ blocks
    (1, 16, 16, 128, 1000, 114, 3),     # on 114 SMs
    (1, 4, 1, 96, 224, 132, 2),         # the Pallas MQA shape: 4 key tiles
    (2, 8, 8, 256, 128, 132, 1),        # rows without keys: 2 key tiles
    (2, 16, 8, 512, 512, 132, 1),       # padded width 80: 256 dQ blocks
    (1, 4, 2, 64, 8192, 132, 16),       # 4 blocks of 128 key tiles
    (1, 33, 33, 128, 2048, 132, 2),     # 66 blocks: 2 x 66 = 132
]


def test_f32_dq_splits_keys_when_the_grid_leaves_sms_idle():
    """The f32 dQ blocks share their keys among ``split`` blocks when they
    leave SMs idle (the forward's rule, ``fa.key_split``); dK/dV never
    splits, and the scratch holds each split's dQ rows.  (One test over
    DQ_SPLITS: the collection's size decides xdist's first chunks, ROADMAP
    Queue C.)"""
    for b, hq, hk, sq, sk, n_sm, split in DQ_SPLITS:
        blocks = -(-sq // 64)
        for d in (16, 64, 80, 128):
            plan = fa.kernel_plan_bwd(b, hq, hk, sq, sk, d, torch.float32,
                                      n_sm)
            what = (b, hq, hk, sq, sk, n_sm, d)
            assert plan["dq"]["split"] == split, what
            assert plan["grids"]["dq"] == (blocks * split, hq, b), what
            assert plan["grids"]["dkdv"] == (-(-sk // 64), hk, b), what
            assert plan["scratch"] == (split * b * hq * sq * d * 4
                                       if split > 1 else 0), what


@pytest.mark.parametrize("args,match", [
    ((1, 2, 2, 64, 64, 0, torch.bfloat16), "head dim 0 is below 1"),
    ((1, 2, 2, 64, 64, -8, torch.float32), "head dim -8 is below 1"),
    ((1, 2, 2, 64, 64, 64, torch.float16), "dtype torch.float16"),
    ((1, 70000, 70000, 64, 64, 136, torch.float64), "dtype torch.float64"),
    ((65536, 65536, 1, 64, 64, 0, torch.float32), "head dim 0 is below 1"),
])
def test_kernel_plan_bwd_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        fa.kernel_plan_bwd(*args)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float32, "cuda_cores")])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_plan_bwd_takes_every_width(d, dtype, variant):
    """Every width of the domain: the variant by dtype, and the dK/dV and
    dQ kernels' shared memory and threads those of the width's class
    (``fa.kernel_width``), within a block's limits."""
    plan = fa.kernel_plan_bwd(2, 16, 8, 512, 512, d, dtype)
    assert plan["variant"] == variant
    for i, kernel in enumerate(("dkdv", "dq")):
        k = plan[kernel]
        other, threads, *smem = GEOMETRY_BWD[(dtype, fa.kernel_width(d),
                                              k["rows"])]
        assert (k["other"], k["threads"], k["smem"]) == (other, threads,
                                                         smem[i])
        assert k["smem"] <= fa.MAX_SMEM and k["threads"] <= 1024


# bf16 past 256 columns: 64-row blocks owning one slice of 128 columns, 1 KB
# of alignment, a ring of three stages of two 64 x 128 bf16 tiles, 64 bytes
# of mbarriers (dK/dV 1 KB more of lse and delta)
WIDE_BWD = (64, 128, 1024 + 3 * 32_768 + 64 + 1024, 1024 + 3 * 32_768 + 64)


def f32_256_bwd_geometry(width: int) -> tuple[int, int, int, int]:
    """The f32 whole-width backward past 128 columns: tiles of 64 rows of
    the other side, 256 threads, and the dK/dV and dQ shared memory (the
    same): four ring stages of 64-row pieces of 64 columns at 68 floats a
    row; up to 256 columns the block's two own tiles of 64 rows at the
    whole width (K and V; Q and dO; pieces side by side, 4 floats of pad),
    past it a piece of them beside each piece instead; a 64 x 68 score
    tile."""
    pieces, piece = -(-width // 64), 64 * 68
    if width <= 256:
        floats = 4 * piece + 2 * 64 * (64 * pieces + 4) + 64 * 68
    else:
        floats = 4 * 2 * piece + 64 * 68
    return 64, 256, floats * 4, floats * 4


# (b, hq, hk, sq, sk, f32 slices), then the f32 whole-width kernels' dQ key
# split and dK/dV shares (``wave_split``): 1 where the grid fills 132 SMs,
# else as many as bring it to two waves (264 blocks), at most one a tile of
# the block's walk and 16.  [2, 4/2, 300, 300]: 40 dQ blocks of 5 key
# tiles and 20 dK/dV blocks walking 2 heads x 5 query tiles, a slice;
# 4,096 tokens: 1,024 dQ blocks, 128 dK/dV blocks of 8 heads x up to 64
# tiles; 64 x 8,192: 4 dQ blocks of 128 key tiles, 128 dK/dV blocks of 4
# heads x 1 tile
WAVE_SPLITS = {
    (2, 4, 2, 300, 300, 1): (5, 10),
    (2, 4, 2, 300, 300, 2): (3, 6),
    (2, 4, 2, 300, 300, 3): (2, 4),
    (1, 16, 2, 4096, 4096, 1): (1, 2),
    (1, 16, 2, 4096, 4096, 2): (1, 1),
    (1, 16, 2, 4096, 4096, 3): (1, 1),
    (1, 4, 1, 64, 8192, 1): (16, 2),
    (1, 4, 1, 64, 8192, 2): (16, 1),
    (1, 4, 1, 64, 8192, 3): (16, 1),
}


def _wide_plans_bwd_slice_columns_and_split_keys():
    """Past 128 columns in f32 the whole-width kernels: 64-row blocks, one
    slice up to 256 columns and past it at most ceil(width / 256); past 256
    in bf16 (below, the native kernels) the wide kernels' 64-row blocks,
    one slice of 128 columns each.  The grids' x count blocks x
    slices, the f32 dQ split sees the slices' blocks, its scratch at the
    padded width, and a dK/dV block walks every query head of its GQA
    group.  (One test over the widths and shapes: the collection's size
    decides xdist's first chunks, ROADMAP Queue C.)"""
    for blocks, tiles, n_sm, split in ((40, 5, 132, 5), (120, 5, 132, 2),
                                       (132, 9, 132, 1), (4, 128, 132, 16),
                                       (40, 10, 114, 5), (1, 1, 132, 1)):
        assert fa.wave_split(blocks, tiles, n_sm) == split
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        for d, width, n_bf16, n_f32 in (
                (136, 136, 1, 1), (192, 192, 1, 1), (200, 200, 1, 1),
                (256, 256, 1, 1), (300, 304, 3, 2), (512, 512, 4, 2),
                (520, 520, 5, 3)):
            if not f32 and d <= 256:
                continue     # the native kernels
            n = n_f32 if f32 else n_bf16
            geometry = f32_256_bwd_geometry(width) if f32 else WIDE_BWD
            assert fa.geometry_bwd(dtype, d, 64) == geometry
            assert geometry[2] <= fa.MAX_SMEM and geometry[3] <= fa.MAX_SMEM
            for b, hq, hk, sq, sk in ((2, 4, 2, 300, 300), (1, 16, 2, 4096,
                                                            4096),
                                      (1, 4, 1, 64, 8192)):
                plan = fa.kernel_plan_bwd(b, hq, hk, sq, sk, d, dtype)
                what = (dtype, d, b, hq, hk, sq, sk)
                assert plan["variant"] == ("cuda_cores_256" if f32
                                           else "wgmma"), what
                assert (plan["width"], plan["slices"]) == (width, n), what
                assert plan["dkdv"]["rows"] == plan["dq"]["rows"] == 64, what
                other, threads, s_dkdv, s_dq = geometry
                assert (plan["dkdv"]["smem"], plan["dq"]["smem"]) == \
                    (s_dkdv, s_dq), what
                blocks = -(-sq // 64) * n
                k_blocks = -(-sk // 64) * n
                split, shares = (WAVE_SPLITS[(b, hq, hk, sq, sk, n)]
                                 if f32 else (1, 1))
                assert plan["dq"]["split"] == split, what
                assert plan["dkdv"].get("split", 1) == shares, what
                assert plan["dkdv"]["head_split"] == 1, what
                assert plan["grids"]["dq"] == (blocks * split, hq, b), what
                assert plan["grids"]["dkdv"] == (k_blocks * shares, hk, b), \
                    what
                assert plan["scratch"] == (
                    (split * b * hq * sq * width * 4 if split > 1 else 0)
                    + (2 * shares * b * hk * sk * width * 4 if shares > 1
                       else 0)), what


def test_padding_the_backward_is_exact():
    """The op's padding of q, k, v, o and dO with zero columns, the scale of
    the real width, and dq, dk, dv sliced back, equals the unpadded
    gradient, at D 4, 20 and 136."""
    for d in (4, 20, 136):
        q, k, v, do = map(torch.from_numpy, _inputs(d, 1, 4, 2, 40, 56, d))
        kw = dict(causal=True, window=24, softcap=5.0, scale=d ** -0.5)
        out = ref.attention_ref(q, k, v, **kw)
        lse = ref.attention_lse_ref(q, k, **kw)
        want = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
        width = fa.padded_width(d)
        padded = fa._pad(width, q, k, v, out, do)
        got = fa._unpad(d, *ref.attention_bwd_ref(*padded[:4], lse,
                                                  padded[4], **kw))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == w.shape and g.is_contiguous(), (d, name)
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6,
                                       msg=f"D {d} {name}")


def test_wide_plans_bwd_slice_columns_and_split_keys():
    """The wide backward plans' slices, geometry, splits and scratch
    (``_wide_plans_bwd_slice_columns_and_split_keys``)."""
    _wide_plans_bwd_slice_columns_and_split_keys()


# (b, hq, hk, sq, sk), then the native dK/dV shares of the group: one where
# the key blocks fill two waves of 132 SMs, else as many as reach two waves,
# at most the group's heads
NATIVE_SHARES = [
    ((1, 16, 2, 4096, 4096), 3),     # Qwen3-Next: 128 key blocks
    ((2, 4, 2, 300, 300), 2),        # 20 blocks: 14 wanted, the group's 2
    ((8, 16, 8, 2048, 2048), 1),     # 2,048 blocks
    ((1, 8, 1, 1000, 1000), 8),      # MQA: 16 blocks, 17 wanted, 8 heads
    ((1, 4, 4, 128, 128), 1),        # MHA: a group of one head
]


def test_native_variant_by_width_and_dtype():
    """The native kernels run exactly at bf16 padded widths 136-256 (D 129
    pads to 136): forward 256 threads (two warpgroups) on 128-row blocks
    (64 where those would leave SMs idle), backward 256 threads, dK/dV blocks of
    64 keys in the group's shares (``head_split``), dQ blocks of 128
    queries; shared memory within 232,448 bytes.  bf16 past 256 runs the
    slice kernels ("wgmma" with slices); f32 at every width past 128 the
    whole-width kernels ("cuda_cores_256": one slice up to 256 columns, two
    at 264-512), 64-row blocks, dK/dV's 128 blocks (of 132 SMs) shared two
    ways at one slice.  The native shares' f32 parts are the scratch, and
    add a combine launch."""
    for d in (120, 128, 129, 136, 192, 200, 256, 257, 264, 512):
        for dtype in (torch.bfloat16, torch.float32):
            bf16_native = dtype == torch.bfloat16 and 129 <= d <= 256
            f32_native = dtype == torch.float32 and d > 128
            fwd = fa.kernel_plan(1, 16, 2, 4096, 4096, d, dtype)
            bwd = fa.kernel_plan_bwd(1, 16, 2, 4096, 4096, d, dtype)
            assert fa.native(d, dtype) == (bf16_native or f32_native)
            assert (fwd["variant"] == "wgmma_256") == bf16_native, (d, dtype)
            assert (bwd["variant"] == "wgmma_256") == bf16_native, (d, dtype)
            assert (fwd["variant"] == bwd["variant"] == "cuda_cores_256") \
                == f32_native, (d, dtype)
            assert fwd["smem"] <= 232_448
            assert max(bwd["dkdv"]["smem"], bwd["dq"]["smem"]) <= 232_448
            if f32_native:
                assert fwd["slices"] == bwd["slices"] == (1 if d <= 256
                                                          else 2), d
                assert (fwd["block_q"], fwd["threads"]) == (64, 256)
                assert (bwd["dkdv"]["rows"], bwd["dq"]["rows"]) == (64, 64)
                assert bwd["dkdv"]["head_split"] == 1
                assert bwd["dkdv"]["split"] == (2 if d <= 256 else 1)
                assert bwd["grids"]["dkdv"] == (128, 2, 1)
                assert "combine" not in bwd["grids"]
                continue
            if not bf16_native:
                assert (fwd["slices"] > 1) == (d > 128), (d, dtype)
                continue
            assert (fwd["threads"], fwd["block_q"], fwd["slices"]) == \
                (256, 128, 1)
            assert bwd["dkdv"]["threads"] == bwd["dq"]["threads"] == 256
            assert (bwd["dkdv"]["rows"], bwd["dq"]["rows"]) == (64, 128)
            assert bwd["dkdv"]["head_split"] == 3
            assert bwd["grids"]["dkdv"] == (64 * 3, 2, 1)
            assert bwd["grids"]["dq"] == (32, 16, 1)
            width = fa.padded_width(d)
            assert bwd["scratch"] == 2 * 3 * 2 * 4096 * width * 4
            assert bwd["grids"]["combine"] == (2 * 2 * 4096 * width // 1024,)
    small = fa.kernel_plan(2, 4, 1, 300, 500, 136, torch.bfloat16)
    assert (small["variant"], small["block_q"], small["threads"],
            small["smem"]) == ("wgmma_256", 64, 128, 1024 + 320 * 512 + 128)
    for (b, hq, hk, sq, sk), shares in NATIVE_SHARES:
        assert fa.head_split(b, hk, sk, hq // hk) == shares, (b, hq, hk)
        plan = fa.kernel_plan_bwd(b, hq, hk, sq, sk, 256, torch.bfloat16)
        assert plan["dkdv"]["head_split"] == shares
        assert plan["grids"]["dkdv"][0] == -(-sk // 64) * shares
        assert ("combine" in plan["grids"]) == (shares > 1)

"""The kernels under ``local_map`` and the sharded train step on the card
(``cuda`` marker; torch and numpy only, as the GPU host has no JAX): NCCL
at world size 1 on a ``(1, 1)`` ``("data", "model")`` mesh.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_sharded_cuda.py

* ``ops.flash_attention`` and ``ops.ssd_scan`` on ``DTensor`` inputs
  (batch and heads placed, as the models place them) run the hand-written
  kernels on the rank's block through ``local_map``: the output equals the
  plain version's on the same inputs within the card tests' tolerances
  (``test_torch_flash_cuda.py``, ``test_torch_ssd_cuda.py``), the flash
  gradients within the same, and each call launches the kernel once
  through one ``local_map`` block.
* The sharded step (smoke widths with the head dim the flash kernel takes,
  f32 and bf16 compute, so both variants of each kernel run) is bitwise the
  plain step on the same card: loss, grad norm, every updated leaf; its
  gradients reach AdamW in their parameters' placements
  (``param_shardings``), and its flash forward, backward and SSD launches
  equal the plain step's, each forward through ``local_map``.
"""
import dataclasses
import tempfile
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.dist import (
    activation_shardings, distribute, input_pspec_tree, named,
    param_pspec_tree)
from repro_torch.dist.sharding import P
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.train import OptConfig, adamw_init, make_train_step

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    with tempfile.TemporaryDirectory() as where:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(where) / "store"), 1), rank=0, world_size=1)
        try:
            yield make_host_mesh((1, 1), ("data", "model"))
        finally:
            dist.destroy_process_group()


def _counts():
    return (flash_attention_cuda.launches, flash_attention_bwd_cuda.launches,
            ssd_scan_cuda.launches, dict(ops.local_map_blocks))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_under_local_map_matches_plain_version(mesh, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    b, hq, hk, s, d = 2, 8, 2, 384, 64
    q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda").to(dt)
               for h in (hq, hk, hk))
    do = torch.randn(b, hq, s, d, generator=g, device="cuda").to(dt)
    heads = P("data", "model", None, None)
    qd, kd, vd = (distribute(mesh, {"x": t}, {"x": heads})["x"]
                  .requires_grad_(True) for t in (q, k, v))
    c0 = _counts()
    out = ops.flash_attention(qd, kd, vd, causal=True, window=200)
    out.backward(distribute(mesh, {"x": do}, {"x": heads})["x"])
    c1 = _counts()
    assert tuple(out.placements) == tuple(qd.placements)
    want = ref.attention_ref(q, k, v, causal=True, window=200)
    lse = ref.attention_lse_ref(q, k, causal=True, window=200)
    wq, wk, wv = ref.attention_bwd_ref(q, k, v, want, lse, do, causal=True,
                                       window=200)
    tol = FLASH_TOL[dtype]
    for got, exp in ((out, want), (qd.grad, wq), (kd.grad, wk),
                     (vd.grad, wv)):
        got = got.full_tensor().float()
        assert (got - exp.float()).abs().max() <= tol * max(
            1.0, exp.float().abs().max())
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 1)
    assert c1[3]["flash_attention"] - c0[3]["flash_attention"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_under_local_map_matches_plain_version(mesh, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(1)
    b, s, h, p, grp, n, chunk = 2, 256, 4, 64, 1, 128, 128
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(dt)
    dtv = torch.rand(b, s, h, generator=g, device="cuda") * 0.1
    A = -torch.rand(h, generator=g, device="cuda") * 4
    Bm, Cm = (torch.randn(b, s, grp, n, generator=g, device="cuda").to(dt)
              for _ in range(2))
    D = torch.randn(h, generator=g, device="cuda")
    lay = {"x": P("data", None, "model", None), "dt": P("data", None, "model"),
           "A": P("model"), "D": P("model"),
           "Bm": P("data", None, "model", None),
           "Cm": P("data", None, "model", None)}
    placed = distribute(mesh, {"x": x, "dt": dtv, "A": A, "Bm": Bm, "Cm": Cm,
                               "D": D}, lay)
    c0 = _counts()
    with torch.no_grad():
        y = ops.ssd_scan(placed["x"], placed["dt"], placed["A"],
                         placed["Bm"], placed["Cm"], placed["D"], chunk=chunk)
    c1 = _counts()
    want = ref.ssd_scan_ref(x, dtv, A, Bm, Cm, D, chunk=chunk)
    got = y.full_tensor().float()
    assert (got - want.float()).abs().max() <= SSD_TOL[dtype] * max(
        1.0, want.float().abs().max())
    assert c1[2] - c0[2] == 1
    assert c1[3]["ssd_scan"] - c0[3]["ssd_scan"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,microbatches", [("internlm2-1.8b", 2),
                                               ("mamba2-130m", 2)])
def test_sharded_step_is_bitwise_the_plain_step(mesh, arch, microbatches,
                                                dtype):
    cfg = get_config(arch, smoke=True, dtype=dtype)
    attn = any(cfg.mixer_kind(i) == "attn" for i in range(cfg.period))
    if attn:
        cfg = dataclasses.replace(cfg, d_head=64)
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=g,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(model, opt_cfg, microbatches=microbatches)
    c0 = _counts()
    want, _, want_m = step(params, adamw_init(params), batch)
    c1 = _counts()

    specs = param_pspec_tree(params, mesh)
    placed = distribute(mesh, params, specs)
    sharded = make_train_step(model, opt_cfg, microbatches=microbatches,
                              param_shardings=named(mesh, specs))
    db = distribute(mesh, batch,
                    input_pspec_tree({"batch": batch}, mesh)["batch"])
    with activation_shardings(mesh):
        got, state, got_m = sharded(placed, adamw_init(placed), db)
    c2 = _counts()

    assert torch.equal(got_m["loss"].full_tensor(), want_m["loss"])
    assert torch.equal(got_m["grad_norm"].full_tensor(), want_m["grad_norm"])
    for (path, a), b, p in zip(tree.leaves_with_path(want), tree.leaves(got),
                               tree.leaves(placed)):
        assert tuple(b.placements) == tuple(p.placements), tree.key(path)
        assert torch.equal(b.full_tensor(), a), tree.key(path)
    plain = [c1[i] - c0[i] for i in range(3)]
    sharded_n = [c2[i] - c1[i] for i in range(3)]
    assert sharded_n == plain and sum(plain) > 0
    kernel = "flash_attention" if attn else "ssd_scan"
    n_fwd = plain[0] if attn else plain[2]
    assert c2[3][kernel] - c1[3][kernel] == n_fwd

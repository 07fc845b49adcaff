"""The mesh layer on one card: NCCL at world size 1, a ``(1, 1)``
``("data", "model")`` mesh, at narrow widths.

Every test is marked ``cuda`` and skips without an NVIDIA GPU; the file
imports torch, numpy and ``repro_torch`` only (the card's host has no JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dist_cuda.py

The expert-parallel MoE layer (granite-moe's smoke widths, f32) against
its local path within 2e-4 (aux 1e-4) at both schedules, forward and
gradient; Fig. 4's campaign through ``run_campaign(mesh=)`` bitwise the
unsharded run; internlm2's smoke parameters through ``named`` and
``distribute_tensor`` bitwise.  Each test makes and destroys its process
group (a ``FileStore`` in ``tmp_path``).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import result_to_numpy
from repro_torch.core import run_campaign, scenarios, stack_scenarios
from repro_torch.dist import (
    activation_shardings, distribute, param_pspec_tree)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, moe

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


@pytest.fixture
def mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_host_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("b,s,schedule", [(2, 8, "token_gather"),
                                          (4, 16, "weight_gather")])
def test_expert_parallel_moe_on_the_card(mesh, b, s, schedule):
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    params = moe.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg)
    x = torch.randn(b, s, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    runs = []
    for ep in (False, True):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xx = x.clone().requires_grad_(True)
        if ep:
            with activation_shardings(mesh):
                y, aux = moe.moe_apply(p, cfg, xx)
            assert moe._moe_shard_map.schedule == schedule
        else:
            y, aux = moe._moe_local(p, cfg, xx)
        (y.square().sum() + aux).backward()
        runs.append((y.detach(), aux.detach(), xx.grad,
                     {k: v.grad for k, v in p.items()}))
    (y0, a0, dx0, g0), (y1, a1, dx1, g1) = runs
    assert float((y1 - y0).abs().max()) <= 2e-4
    assert float((a1 - a0).abs()) <= 1e-4
    for want, got in [(dx0, dx1)] + [(g0[k], g1[k]) for k in g0]:
        assert float((got - want).abs().max()) <= \
            2e-4 * float(want.abs().max())


def test_sharded_campaign_on_the_card(mesh):
    batched = stack_scenarios([scenarios.fig4_scenario(hp, vp)
                               for hp in (0, 1) for vp in (0, 1)] * 2)
    want = result_to_numpy(run_campaign(batched))
    for kw in ({}, {"chunk_size": 4}):
        got = result_to_numpy(run_campaign(batched, mesh=mesh, **kw))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_parameters_through_distribute_tensor(mesh):
    model = build_model(get_config("internlm2-1.8b", smoke=True))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    shards = distribute(mesh, params, param_pspec_tree(params, mesh))
    for (path, x), d in zip(tree.leaves_with_path(params),
                            tree.leaves(shards)):
        assert torch.equal(d.full_tensor(), x), tree.key(path)

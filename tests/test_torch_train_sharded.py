"""The sharded train step over gloo processes, against the port's
one-process step and the JAX package's one-device step.

Each case draws the reference's parameters (``PRNGKey(0)``) and two
batches, runs two steps of the reference's jitted ``make_train_step``
here, and starts one ``tests/torch_gloo_worker.py`` process per rank of a
``(2, 2)`` ``("data", "model")`` mesh (case ``train_sharded``), which
carries the same parameters across (``convert.params_from_arrays``) and
runs the port's step in one process and then sharded: ``DTensor``
parameters from ``distribute`` of the same values by ``param_pspec_tree``,
their AdamW moments, the batches placed by ``input_pspec_tree``,
``param_shardings`` the parameters' placements, the kernels (here their
plain versions) under ``local_map``.  The archs are the reference's own
mesh tests' (``test_dryrun_smoke.py``): internlm2, granite-moe with its
expert-parallel MoE and mamba2 with 2 microbatches, and qwen3-32b with 1,
at smoke widths, in f32.

Held, at each of the two steps:
* the loss within 1e-5 relative of the one-process step's (the same
  arithmetic, summed in another order across ranks), and within the
  reference's own 1e-3 of its one-device step's
  (``test_dryrun_smoke.py:149``);
* ``grad_norm`` within 1e-4 relative of both;
* after the two steps, each parameter within 1e-4 of its largest value of
  the one-process step's, and within 2e-4 of the reference's (two
  frameworks' f32 rounding over two AdamW steps).  The learning rate is
  1e-3 with no warmup, so every step moves every leaf (the default
  schedule's first step has a learning rate of 0);
* every gradient reaching AdamW in its parameter's placements, and every
  updated leaf and moment keeping them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train import OptConfig as JaxOptConfig
from repro.train import adamw_init as jax_adamw_init
from repro.train import make_train_step as jax_make_train_step
from test_torch_dist_gloo import _flat, _same_on_every_rank, _spawn

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.dist import (
    P, activation_shardings, distribute, named, param_pspec_tree)
from repro_torch.models import build_model
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.train import step as step_mod
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

LR = 1e-3
B, S = 4, 32
STEPS = 2


@pytest.mark.parametrize("arch,microbatches", [
    ("internlm2-1.8b", 2),
    ("granite-moe-1b-a400m", 2),
    ("mamba2-130m", 2),
    ("qwen3-32b", 1),
])
def test_sharded_step_matches_one_process_and_the_reference(
        tmp_path, arch, microbatches):
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batches = [{k: rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    step = jax.jit(jax_make_train_step(
        model, JaxOptConfig(lr=LR, warmup_steps=0), microbatches=microbatches))
    ref_params, state = params, jax_adamw_init(params)
    ref = []
    for batch in batches:
        ref_params, state, metrics = step(
            ref_params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        ref.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    data = {f"{k}{i}": v for i, b in enumerate(batches) for k, v in b.items()}
    out = _same_on_every_rank(_spawn(
        "train_sharded", 4, tmp_path,
        {"arch": arch, "mesh": [2, 2], "microbatches": microbatches,
         "lr": LR, "steps": STEPS},
        {**data, **_flat(params, "params")}))

    assert out["sharded/grads_placed"].all()
    assert out["sharded/kept_placed"].all()
    for i in range(STEPS):
        loss, norm = (float(out[f"sharded/{k}{i}"])
                      for k in ("loss", "grad_norm"))
        one = (float(out[f"plain/loss{i}"]), float(out[f"plain/grad_norm{i}"]))
        assert abs(loss - one[0]) <= 1e-5 * abs(one[0]), (i, loss, one)
        assert abs(loss - ref[i][0]) < 1e-3, (i, loss, ref[i])
        for want in (one[1], ref[i][1]):
            assert abs(norm - want) <= 1e-4 * abs(want), (i, norm, want)
    want_params = {k[len("p/"):]: v for k, v in
                   _flat(ref_params, "p").items()}
    for name, leaves, tol in (
            ("one process", {k[len("plain/params/"):]: v
                             for k, v in out.items()
                             if k.startswith("plain/params/")}, 1e-4),
            ("reference", want_params, 2e-4)):
        assert leaves.keys() == want_params.keys(), name
        for k, want in leaves.items():
            got = out[f"sharded/params/{k}"]
            assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
                (name, k)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_sharded_prefill_and_decode_match_one_process(tmp_path, arch):
    """The dry-run's prefill and decode cells on 4 gloo ranks of a ``(2,
    2)`` mesh: ``DTensor`` parameters, prompt, caches (laid out by
    ``input_pspec_tree``), token and position; the decode attention and
    the SSM recurrence run on each rank's block under ``local_map``.  The
    prefill's and the decode step's logits and the caches after it equal
    the one-process run's within 1e-5 of their largest value (f32: the
    same arithmetic, reduced in another order across ranks)."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, size=(B, 24)).astype(np.int32)
    out = _same_on_every_rank(_spawn(
        "serve_sharded", 4, tmp_path, {"arch": arch, "mesh": [2, 2], "L": 32},
        {"tokens": tokens}))
    plain = {k[len("plain/"):]: v for k, v in out.items()
             if k.startswith("plain/")}
    assert plain
    for k, want in plain.items():
        got = out[f"sharded/{k}"]
        assert got.shape == want.shape, k
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0), k


def test_param_shardings_places_the_gradients(tmp_path, monkeypatch):
    """One gloo rank, a ``(1, 1)`` mesh, parameters placed whole: without
    ``param_shardings`` the gradients reach AdamW as autograd left them,
    some as partial sums unlike their parameters; with the placement tree
    of ``param_pspec_tree`` every one reaches it in the tree's, and the
    loss is the same.  Plain parameters refuse a placement tree."""
    from repro_torch.launch.mesh import make_host_mesh

    model = build_model(get_config("internlm2-1.8b", smoke=True))
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, model.cfg.vocab, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    seen = []
    adamw = step_mod.adamw_update

    def spy(grads, opt_state, ps, opt_cfg):
        seen.append([tuple(g.placements) for g in tree.leaves(grads)])
        return adamw(grads, opt_state, ps, opt_cfg)

    replicated = tree.map_tree(lambda _: P(), params)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1))
        tree_pl = named(mesh, param_pspec_tree(params, mesh))
        with pytest.raises(ValueError, match="DTensor"):
            make_train_step(model, OptConfig(), param_shardings=tree_pl)(
                params, adamw_init(params), batch)
        whole = distribute(mesh, params, replicated)
        placed_batch = distribute(mesh, batch, {k: P() for k in batch})
        monkeypatch.setattr(step_mod, "adamw_update", spy)
        losses = []
        for pin in (None, tree_pl):
            step = make_train_step(model, OptConfig(), microbatches=2,
                                   param_shardings=pin)
            with activation_shardings(mesh):
                _, _, metrics = step(whole, adamw_init(whole), placed_batch)
            losses.append(metrics["loss"].full_tensor())
    finally:
        dist.destroy_process_group()
    own = [tuple(p.placements) for p in tree.leaves(whole)]
    want = [tuple(pl) for pl in _placement_leaves(tree_pl, params)]
    assert seen[0] != own
    assert any(pl.is_partial() for leaf in seen[0] for pl in leaf)
    assert seen[1] == want != own
    assert torch.equal(losses[0], losses[1])


def _placement_leaves(tree_pl, params) -> list:
    out = []
    for path, _ in tree.leaves_with_path(params):
        node = tree_pl
        for k in path:
            node = node[k]
        out.append(node)
    return out

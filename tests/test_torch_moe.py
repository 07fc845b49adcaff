"""The port's MoE layer and MoE models against the JAX package's, on the CPU.

The routing pieces (``_capacity``, ``_route``, ``_dispatch_slots``) take the
same numpy inputs on both sides: integers and expert choices must be equal;
gates and the router's means within 1e-6 (XLA's softmax and torch's round
the gates differently in the last bit).  ``moe_apply`` must agree within 1e-5 in f32
with tokens past an expert's capacity (dropped) and with every token kept.
granite-moe and qwen3-moe (smoke widths) go through ``Model.prefill`` and
``decode_step`` on parameters drawn by the JAX package and carried across
(``convert.params_from_arrays``): logits within 1e-4, caches within 1e-5,
greedy tokens equal, as the dense models' tests hold them; the loss, with
its balance term, within 1e-5.  The JAX side runs attention through the
Pallas kernel in interpret mode and through XLA.  The two ``ServingEngine``s
serve granite-moe in lockstep.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import _lockstep_requests, _models, _np, _same_tree

from repro.core import SPACE_SHARED
from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import lm, moe
from repro_torch.serving import ServingEngine
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("n,e,k,factor", [
    (1, 4, 2, 1.25), (100, 4, 2, 1.25), (512, 32, 8, 1.25), (4, 32, 8, 1.25),
    (16384, 128, 8, 1.25), (333, 16, 2, 0.5), (64, 4, 2, 8.0)])
def test_capacity_matches(n, e, k, factor):
    assert moe._capacity(n, e, k, factor) == jax_moe._capacity(n, e, k, factor)


@pytest.mark.parametrize("t,d,e,k,tie", [(37, 16, 4, 2, False),
                                         (64, 32, 32, 8, False),
                                         (20, 8, 16, 2, True)])
def test_route_matches(t, d, e, k, tie):
    """Gates, experts (a tie puts the lower expert first), and the router's
    mean probability and count per expert.  ``tie``: a zero router, so every
    expert is equally likely."""
    rng = np.random.default_rng(t)
    xt = rng.standard_normal((t, d)).astype(np.float32)
    router = (np.zeros((d, e)) if tie
              else rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    got = moe._route(torch.from_numpy(xt), torch.from_numpy(router), e, k)
    want = jax_moe._route(jnp.asarray(xt), jnp.asarray(router), e, k)
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    for a, w in zip((got[0], *got[2:]), (want[0], *want[2:])):
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_dispatch_slots_match(seed):
    """Order, sorted experts, slots and keep, with ids past the last expert
    (never kept) and capacities that drop."""
    rng = np.random.default_rng(seed)
    n, e = int(rng.integers(1, 200)), int(rng.choice([2, 4, 8]))
    cap = int(rng.integers(1, 33))
    ids = rng.integers(0, e + 1, n)
    got = moe._dispatch_slots(torch.from_numpy(ids), e, cap)
    want = jax_moe._dispatch_slots(jnp.asarray(ids, jnp.int32), e, cap)
    for a, w in zip(got, want):
        assert a.tolist() == np.asarray(w).tolist()


@pytest.mark.parametrize("factor", [0.5, 8.0])
def test_moe_apply_matches(factor):
    """factor 0.5: 96 tokens top-2 of 4 experts get 32 slots an expert for
    ~48 entries each, so tokens are dropped; 8.0 keeps every token."""
    cfg = dataclasses.replace(
        get_config("granite-moe-1b-a400m", smoke=True),
        moe=dataclasses.replace(get_config("granite-moe-1b-a400m",
                                           smoke=True).moe,
                                capacity_factor=factor))
    jparams = jax_moe.init_moe(jax.random.PRNGKey(7), cfg)
    params = params_from_arrays(jparams, "cpu")
    x = np.random.default_rng(8).standard_normal((3, 32, cfg.d_model))
    x = x.astype(np.float32)
    T, m = 3 * 32, cfg.moe
    cap = moe._capacity(T, m.n_experts, m.top_k, factor)
    _, ids, _, _ = moe._route(torch.from_numpy(x).reshape(T, -1),
                              params["router"], m.n_experts, m.top_k)
    counts = torch.bincount(ids.reshape(-1), minlength=m.n_experts)
    assert (int(counts.max()) > cap) == (factor < 1)    # drops where meant
    out, aux = moe.moe_apply(params, cfg, torch.from_numpy(x))
    jout, jaux = jax_moe.moe_apply(jparams, cfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match(arch, impl):
    jcfg, _, jparams, model, params = _models(arch, seed=9)
    jmodel = jax_build_model(dataclasses.replace(jcfg, attn_impl=impl))
    prompt = np.random.default_rng(10).integers(0, jcfg.vocab, size=(2, 19))
    prompt = prompt.astype(np.int32)
    max_len = 32
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                      max_len)
    logits, caches = model.prefill(params,
                                   {"tokens": torch.from_numpy(prompt)},
                                   max_len)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    _same_tree(caches, jcaches, 1e-5)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = logits.argmax(-1)[:, None]
    jpos, pos = jnp.full((2,), 19, jnp.int32), torch.full((2,), 19)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(4):
        assert tok.tolist() == np.asarray(jtok).tolist()
        jlogits, jcaches = decode(jparams, jcaches, jtok, jpos)
        logits, caches = model.decode_step(params, caches, tok, pos)
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4,
                                   atol=1e-4)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
        tok = logits.argmax(-1)[:, None]
        jpos, pos = jpos + 1, pos + 1
    _same_tree(caches, jcaches, 1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_with_balance_term_matches(arch, impl):
    jcfg, _, jparams, model, params = _models(arch, seed=11)
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    full = np.random.default_rng(12).integers(0, jcfg.vocab, size=(2, 41))
    tokens, labels = full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)
    labels[0, :5] = -100
    want = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                 "labels": jnp.asarray(labels)})
    got = model.loss(params, {"tokens": torch.from_numpy(tokens),
                              "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    _, aux = lm.forward_hidden(params, model.cfg, torch.from_numpy(tokens))
    _, jaux = jax_lm.forward_hidden(jparams, jcfg, jnp.asarray(tokens))
    assert float(aux) > 0.0     # the balance term is summed over the layers
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_engines_step_in_lockstep():
    """granite-moe through both engines: each prefill routes its own
    ``[1, P]`` prompt, each decode step the ``[n_slots, 1]`` batch with its
    idle slots."""
    jcfg, jmodel, jparams, model, params = _models("granite-moe-1b-a400m",
                                                   seed=13)
    kw = dict(n_slots=2, max_len=24, policy=SPACE_SHARED, replan_every=0)
    jeng = JaxServingEngine(jmodel, jparams, **kw)
    eng = ServingEngine(model, params, device="cpu", **kw)
    for prompt, new in _lockstep_requests(np.random.default_rng(14),
                                          jcfg.vocab):
        jeng.submit(prompt, max_new_tokens=new)
        eng.submit(prompt, max_new_tokens=new)
    while any(not r.done for r in jeng.requests) and jeng.steps < 40:
        jout, out = jeng.step(), eng.step()
        assert out["finished"] == jout["finished"]
        assert eng.tokens.tolist() == np.asarray(jeng.tokens).tolist()
        assert eng.pos.tolist() == np.asarray(jeng.pos).tolist()
    assert eng.steps == jeng.steps and all(r.done for r in eng.requests)
    _same_tree(eng.caches, jeng.caches, 1e-5)


def test_serve_cli_serves_granite_moe_on_the_cpu():
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-moe-1b-a400m", "--smoke", "--device", "cpu", "--requests",
         "3", "--replan-every", "4"],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] done=True" in proc.stdout

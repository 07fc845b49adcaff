"""The port's hybrid family (jamba: SSM, attention and MoE in one period)
against the JAX package's, on the CPU.

jamba at smoke widths (one period of 8 layers: 7 SSD mixers and one
attention, MoE on every other layer) on parameters drawn by the JAX package
and carried across (``convert.params_from_arrays``): ``Model.prefill`` and
4 greedy ``decode_step``s (logits within 1e-4, caches, the SSM conv tails
and states included, within 1e-5, tokens equal), and ``Model.loss`` with
the MoE balance term within 1e-5.  The JAX side runs attention and the SSD
scan through its Pallas kernels in interpret mode and through XLA (its
prefill runs the plain chunked scan either way; the port's prefill routes
through ``ops.ssd_scan`` with the final state).  The two ``ServingEngine``s
serve it in lockstep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import _lockstep_requests, _models, _np, _same_tree

from repro.core import SPACE_SHARED
from repro.models import build_model as jax_build_model
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.serving import ServingEngine
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ARCH = "jamba-v0.1-52b"


def test_smoke_config_is_one_hybrid_period():
    cfg = _models(ARCH)[3].cfg
    assert cfg.n_periods == 1 and cfg.period == 8
    assert [cfg.mixer_kind(i) for i in range(8)] == ["ssm"] * 7 + ["attn"]
    assert [cfg.mlp_kind(i) for i in range(8)] == ["dense", "moe"] * 4


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_hybrid_prefill_and_decode_match(impl):
    jcfg, _, jparams, model, params = _models(ARCH, seed=20)
    jmodel = jax_build_model(dataclasses.replace(jcfg, attn_impl=impl))
    # 45 tokens: a ragged second SSD chunk of 32
    prompt = np.random.default_rng(21).integers(0, jcfg.vocab, size=(2, 45))
    prompt = prompt.astype(np.int32)
    max_len = 56
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                      max_len)
    logits, caches = model.prefill(params,
                                   {"tokens": torch.from_numpy(prompt)},
                                   max_len)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    _same_tree(caches, jcaches, 1e-5)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = logits.argmax(-1)[:, None]
    jpos, pos = jnp.full((2,), 45, jnp.int32), torch.full((2,), 45)
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
def test_hybrid_loss_matches(impl):
    jcfg, _, jparams, model, params = _models(ARCH, seed=22)
    jmodel = jax_build_model(dataclasses.replace(jcfg, attn_impl=impl))
    full = np.random.default_rng(23).integers(0, jcfg.vocab, size=(2, 65))
    tokens, labels = full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)
    labels[1, -7:] = -100
    want = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                 "labels": jnp.asarray(labels)})
    got = model.loss(params, {"tokens": torch.from_numpy(tokens),
                              "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_hybrid_engines_step_in_lockstep():
    jcfg, jmodel, jparams, model, params = _models(ARCH, seed=24)
    kw = dict(n_slots=2, max_len=24, policy=SPACE_SHARED, replan_every=0)
    jeng = JaxServingEngine(jmodel, jparams, **kw)
    eng = ServingEngine(model, params, device="cpu", **kw)
    for prompt, new in _lockstep_requests(np.random.default_rng(25),
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

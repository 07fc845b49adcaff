"""The port's vlm family (qwen2-vl: M-RoPE and frontend embeddings) against
the JAX package's, on the CPU.

``layers.apply_mrope`` within 1e-6 of the reference's on the same inputs.
qwen2-vl at smoke widths on parameters drawn by the JAX package and carried
across (``convert.params_from_arrays``), with frontend (patch) embeddings
from a numpy seed prepended to the tokens: ``Model.prefill`` with ``[3, B,
S]`` M-RoPE positions (logits within 1e-4, caches within 1e-5), 4 greedy
``decode_step``s (the decode rotates by the cache position on all three
streams, as the reference does), ``Model.loss`` within 1e-5 and its
gradients within rtol 1e-4 / atol 1e-6 of ``jax.grad`` (through XLA: the
Pallas kernel has no VJP), and the reference's other branch, plain RoPE
from 2-D positions.  The JAX side runs attention through the Pallas kernel
in interpret mode and through XLA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import _models, _np, _same_tree
from test_torch_train import _same_tree as _same_grads

from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch.models import layers, lm
from repro_torch.train.step import value_and_grad
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ARCH = "qwen2-vl-72b"


def _mrope_positions(b, n_patch, n_text, grid_w):
    """Patches at t = 0 on a grid of ``grid_w`` columns, then text at
    ``grid rows + j`` on all three streams: ``[3, b, n_patch + n_text]``."""
    i = np.arange(n_patch)
    patch = np.stack([np.zeros_like(i), i // grid_w, i % grid_w])
    text = np.broadcast_to(n_patch // grid_w + np.arange(n_text), (3, n_text))
    pos = np.concatenate([patch, text], axis=1)
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).astype(np.int32)


@pytest.mark.parametrize("dh,sections,dtype", [
    (16, (2, 3, 3), "float32"), (128, (16, 24, 24), "float32"),
    (64, (8, 12, 12), "bfloat16")])
def test_apply_mrope_matches(dh, sections, dtype):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 21, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 500, size=(3, 2, 21)).astype(np.int32)
    got = layers.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(pos), 1e6, sections)
    want = jax_layers.apply_mrope(jnp.asarray(x, dtype), jnp.asarray(pos),
                                  1e6, sections)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_apply_mrope_refuses_sections_that_miss_the_head_dim():
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2),
                           1e4, (2, 2, 2))


def _vlm_inputs(cfg, seed, n_text=13):
    rng = np.random.default_rng(seed)
    fe = rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
    tokens = rng.integers(0, cfg.vocab, size=(2, n_text)).astype(np.int32)
    pos = _mrope_positions(2, cfg.n_frontend_tokens, n_text, grid_w=4)
    return fe.astype(np.float32), tokens, pos


@pytest.mark.parametrize("mrope", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_vlm_prefill_and_decode_match(impl, mrope):
    """``mrope``: ``[3, B, S]`` positions; else none, which both packages
    read as ``0 .. S-1`` with plain RoPE."""
    jcfg, _, jparams, model, params = _models(ARCH, seed=40)
    jmodel = jax_build_model(dataclasses.replace(jcfg, attn_impl=impl))
    fe, tokens, pos = _vlm_inputs(jcfg, 41)
    S = fe.shape[1] + tokens.shape[1]
    max_len = S + 8
    jbatch = {"tokens": jnp.asarray(tokens), "frontend_embeds": jnp.asarray(fe)}
    batch = {"tokens": torch.from_numpy(tokens),
             "frontend_embeds": torch.from_numpy(fe)}
    if mrope:
        jbatch["positions"] = jnp.asarray(pos)
        batch["positions"] = torch.from_numpy(pos)
    jlogits, jcaches = jmodel.prefill(jparams, jbatch, max_len)
    logits, caches = model.prefill(params, batch, max_len)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    _same_tree(caches, jcaches, 1e-5)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = logits.argmax(-1)[:, None]
    jpos, tpos = jnp.full((2,), S, jnp.int32), torch.full((2,), S)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(4):
        assert tok.tolist() == np.asarray(jtok).tolist()
        jlogits, jcaches = decode(jparams, jcaches, jtok, jpos)
        logits, caches = model.decode_step(params, caches, tok, tpos)
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4,
                                   atol=1e-4)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
        tok = logits.argmax(-1)[:, None]
        jpos, tpos = jpos + 1, tpos + 1
    _same_tree(caches, jcaches, 1e-5)


def test_vlm_two_dimensional_positions_take_plain_rope():
    """The reference's branch for 2-D positions with ``mrope_sections``
    set: plain RoPE, here from positions that are not ``0 .. S-1``."""
    jcfg, _, jparams, model, params = _models(ARCH, seed=42)
    fe, tokens, pos = _vlm_inputs(jcfg, 43)
    pos2 = pos[1] + 3
    want = jax_lm.lm_logits(jparams, jcfg, jnp.asarray(tokens),
                            jnp.asarray(pos2), jnp.asarray(fe))
    got = lm.lm_logits(params, model.cfg, torch.from_numpy(tokens),
                       torch.from_numpy(pos2), torch.from_numpy(fe))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    three = lm.lm_logits(params, model.cfg, torch.from_numpy(tokens),
                         torch.from_numpy(pos), torch.from_numpy(fe))
    assert not torch.allclose(got, three)   # the two branches differ


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_vlm_loss_matches(impl):
    jcfg, _, jparams, model, params = _models(ARCH, seed=44)
    jmodel = jax_build_model(dataclasses.replace(jcfg, attn_impl=impl))
    fe, tokens, pos = _vlm_inputs(jcfg, 45)
    S = fe.shape[1] + tokens.shape[1]
    labels = np.random.default_rng(46).integers(0, jcfg.vocab, size=(2, S))
    labels[:, :jcfg.n_frontend_tokens] = -100        # no loss on patches
    labels = labels.astype(np.int32)
    want = jmodel.loss(jparams, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "positions": jnp.asarray(pos), "frontend_embeds": jnp.asarray(fe)})
    got = model.loss(params, {
        "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
        "positions": torch.from_numpy(pos),
        "frontend_embeds": torch.from_numpy(fe)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_vlm_gradients_match():
    """M-RoPE positions and the frontend embeddings through ``Model.loss``
    and its gradient."""
    jcfg, jmodel, jparams, model, params = _models(ARCH, seed=47)
    fe, tokens, pos = _vlm_inputs(jcfg, 48)
    S = fe.shape[1] + tokens.shape[1]
    labels = np.random.default_rng(49).integers(0, jcfg.vocab, size=(2, S))
    labels[:, :jcfg.n_frontend_tokens] = -100
    batch = {"tokens": tokens, "labels": labels.astype(np.int32),
             "positions": pos, "frontend_embeds": fe}
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _same_grads(grads, jgrads, rtol=1e-4, atol=1e-6)


def test_vlm_needs_frontend_embeddings():
    _, _, _, model, params = _models(ARCH)
    with pytest.raises(ValueError, match="frontend"):
        model.prefill(params, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                      8)

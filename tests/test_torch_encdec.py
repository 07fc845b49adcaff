"""The port's encoder-decoder (whisper) against the JAX package's, on the CPU.

whisper at smoke widths (2 encoder and 2 decoder layers, 32 frames) on
parameters drawn by the JAX package and carried across
(``convert.params_from_arrays``, which keeps the stacked ``enc_layers`` /
``dec_layers`` tree); the frame embeddings (the stubbed audio frontend) and
the prompts come from numpy seeds.  ``encode`` within 1e-5,
``encdec_loss`` within 1e-5, ``Model.prefill`` (logits within 1e-4; the
self-attention cache ``k``, ``v`` and the cross K/V ``ck``, ``cv`` within
1e-5) and 4 greedy ``decode_step``s (logits within 1e-4, tokens equal).
The JAX side runs attention through the Pallas kernel in interpret mode and
through XLA, as the dense models' tests do.  The loss's gradients against
``jax.grad`` through XLA (the Pallas kernel has no VJP) within rtol 1e-4 /
atol 1e-6, with and without remat; with it, bitwise the run without.
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
from repro.models import encdec as jax_encdec
from repro_torch import tree
from repro_torch.models import build_model, encdec, lm
from repro_torch.train.step import value_and_grad
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ARCH = "whisper-large-v3"


def _setup(impl, seed):
    jcfg, _, jparams, model, params = _models(ARCH, seed=seed)
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    frames = np.random.default_rng(seed + 1).standard_normal(
        (2, jcfg.encoder.n_ctx, jcfg.d_model)).astype(np.float32)
    return jcfg, jparams, model, params, frames


def test_parameter_tree_is_the_reference_one():
    """``Model.init`` draws the reference's tree: the same keys and shapes,
    f32 leaves."""
    _, _, jparams, model, _ = _models(ARCH)

    def walk(mine, ref):
        assert mine.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], dict):
                walk(mine[k], ref[k])
            else:
                assert tuple(mine[k].shape) == ref[k].shape, k
                assert mine[k].dtype == torch.float32, k

    walk(model.init(torch.Generator().manual_seed(0)), jparams)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encode_matches(impl):
    jcfg, jparams, model, params, frames = _setup(impl, 30)
    got = encdec.encode(params, model.cfg, torch.from_numpy(frames))
    want = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encdec_loss_matches(impl):
    jcfg, jparams, model, params, frames = _setup(impl, 32)
    full = np.random.default_rng(33).integers(0, jcfg.vocab, size=(2, 25))
    tokens, labels = full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)
    labels[0, -3:] = -100
    want = jax_build_model(jcfg).loss(jparams, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
        "labels": jnp.asarray(labels)})
    got = model.loss(params, {"frames": torch.from_numpy(frames),
                              "tokens": torch.from_numpy(tokens),
                              "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_encdec_gradients_match():
    """A frames batch through ``Model.loss``: the non-causal encoder over
    the frames and cross-attention with Sq != Sk in the gradient."""
    jcfg, jparams, model, params, frames = _setup("xla", 34)
    full = np.random.default_rng(35).integers(0, jcfg.vocab, size=(2, 25))
    tokens, labels = full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)
    labels[1, :4] = -100
    batch = {"frames": frames, "tokens": tokens, "labels": labels}
    runs = {}
    for remat in (False, True):
        jmodel = jax_build_model(dataclasses.replace(jcfg, remat=remat))
        jloss, jgrads = jax.value_and_grad(jmodel.loss)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        m = build_model(dataclasses.replace(model.cfg, remat=remat))
        calls = lm.remat_call.calls
        loss, grads = value_and_grad(m, params, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        enc, dec = jcfg.encoder.n_layers, jcfg.n_layers
        assert lm.remat_call.calls - calls == (enc + dec + 1 if remat else 0)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _same_grads(grads, jgrads, rtol=1e-4, atol=1e-6)
        runs[remat] = loss, tree.leaves(grads)
    assert torch.equal(runs[False][0], runs[True][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1], runs[True][1]))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encdec_prefill_and_decode_match(impl):
    jcfg, jparams, model, params, frames = _setup(impl, 34)
    jmodel = jax_build_model(jcfg)
    prompt = np.random.default_rng(35).integers(0, jcfg.vocab, size=(2, 11))
    prompt = prompt.astype(np.int32)
    max_len = 24
    jlogits, jcaches = jmodel.prefill(
        jparams, {"frames": jnp.asarray(frames),
                  "tokens": jnp.asarray(prompt)}, max_len)
    logits, caches = model.prefill(
        params, {"frames": torch.from_numpy(frames),
                 "tokens": torch.from_numpy(prompt)}, max_len)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    assert sorted(caches) == ["ck", "cv", "k", "v"]
    _same_tree(caches, jcaches, 1e-5)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = logits.argmax(-1)[:, None]
    jpos, pos = jnp.full((2,), 11, jnp.int32), torch.full((2,), 11)
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


def test_init_caches_match_the_reference_shapes():
    jcfg, jmodel, _, model, _ = _models(ARCH)
    caches = model.init_caches(3, 20, "cpu")
    jcaches = jmodel.init_caches(3, 20)
    _same_tree(caches, jcaches, 0.0)

"""Smoke models with head widths off the flash kernels' narrow domain,
against the JAX package's, on the CPU.

gemma2 (window, both softcaps, GQA 4/2) and internlm2 at their smoke sizes
with ``d_head`` widened by ``dataclasses.replace`` to 256 (the whole-width
kernels on the card) and to 20 (padded to 24 on the card), the same
replacement on both sides.  Parameters are drawn by the JAX package and
carried across; tokens come from numpy seeds.  Serving: a prefill against
the Pallas flash kernel in interpret mode (``attn_impl="pallas"``) and four
greedy decode steps, logits within 1e-4, caches within 1e-5, tokens equal
(``test_torch_serving.py``'s limits).  Training: the loss and every
gradient against ``jax.value_and_grad``, then one AdamW step against the
reference's train step (``test_torch_train.py``'s limits).  On the card
``chip_smoke.py`` runs the same models through the kernels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train import OptConfig as JaxOptConfig
from repro.train import adamw_init as jax_adamw_init
from repro.train import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import build_model
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.train.step import value_and_grad
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ARCHS, D_HEADS = ("gemma2-27b", "internlm2-1.8b"), (20, 256)


def _models(arch, d_head, impl, seed=0):
    """(jax model, jax params, port model, port params): the smoke config
    with heads ``d_head`` wide on both sides."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               d_head=d_head, attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(get_config(arch, smoke=True), d_head=d_head)
    return jmodel, jparams, build_model(cfg), params_from_arrays(jparams,
                                                                 "cpu")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _same_tree(port, ref, rtol, atol):
    want = {tree.key(p): v for p, v in tree.leaves_with_path(ref)}
    got = {tree.key(p): v for p, v in tree.leaves_with_path(port)}
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _serves(arch, d_head):
    jmodel, jparams, model, params = _models(arch, d_head, "pallas")
    assert model.cfg.d_head == d_head
    prompt = np.random.default_rng(1).integers(
        0, model.cfg.vocab, size=(2, 21)).astype(np.int32)
    max_len = 32
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                      max_len)
    with torch.no_grad():
        logits, caches = model.prefill(
            params, {"tokens": torch.from_numpy(prompt)}, max_len)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4,
                               atol=1e-4)
    _same_tree(caches, jcaches, 1e-5, 1e-5)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = logits.argmax(-1)[:, None]
    jpos, pos = jnp.full((2,), 21, jnp.int32), torch.full((2,), 21)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(4):
        assert tok.tolist() == np.asarray(jtok).tolist()
        jlogits, jcaches = decode(jparams, jcaches, jtok, jpos)
        with torch.no_grad():
            logits, caches = model.decode_step(params, caches, tok, pos)
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4,
                                   atol=1e-4)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
        tok = logits.argmax(-1)[:, None]
        jpos, pos = jpos + 1, pos + 1
    _same_tree(caches, jcaches, 1e-5, 1e-5)


def _trains(arch, d_head):
    jmodel, jparams, model, params = _models(arch, d_head, "xla", seed=2)
    full = np.random.default_rng(3).integers(0, model.cfg.vocab, (2, 33))
    tokens, labels = (full[:, :-1].astype(np.int32),
                      full[:, 1:].astype(np.int32))
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, jbatch)
    loss, grads = value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _same_tree(grads, jgrads, rtol=1e-4, atol=1e-6)

    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jparams, _, jm = jax.jit(jax_make_train_step(jmodel, JaxOptConfig(**kw)))(
        jparams, jax_adamw_init(jparams), jbatch)
    params, _, m = make_train_step(model, OptConfig(**kw))(
        params, adamw_init(params), batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    _same_tree(params, jparams, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_widened_smoke_model_serves_and_trains(arch):
    """The smoke model with heads of each of D_HEADS, served and trained as
    the module docstring says.  (One test an arch: the collection's size
    decides xdist's first chunks, ROADMAP Queue C.)"""
    for d_head in D_HEADS:
        _serves(arch, d_head)
        _trains(arch, d_head)

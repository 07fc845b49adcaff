"""``remat_policy="save_named"`` against ``"none"`` and against the JAX
package's ``jax.checkpoint`` with ``save_only_these_names("remat_ckpt")``,
on the CPU at smoke widths, f32.

Under ``save_named`` each checkpointed period keeps the values tagged
``layers.remat_ckpt`` (the mixer's output and the dense MLP's; the local
MoE path tags nothing, as in the reference) and recomputes the rest, so
the loss and every gradient are bitwise those of ``"none"``, and each tag
copies once per forward: the replay takes the saved copy.  Against the
reference: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, the
tolerances of ``tests/test_torch_train.py``.  The encoder-decoder and the
loss chunks checkpoint without a policy in both packages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_train import _batch, _models, _same_tree

from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.models import build_model, layers, lm
from repro_torch.train.step import value_and_grad
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1


def _tags(cfg) -> int:
    """Tagged values of one forward: every mixer, and every dense MLP."""
    return sum(1 + (cfg.mlp_kind(i) == "dense")
               for i in range(cfg.period)) * cfg.n_periods


def _run(model, params, batch, policy):
    m = build_model(dataclasses.replace(model.cfg, remat=True,
                                        remat_policy=policy))
    copies, calls = layers.remat_ckpt.copies, lm.remat_call.calls
    loss, grads = value_and_grad(m, params, batch)
    return (loss, grads, layers.remat_ckpt.copies - copies,
            lm.remat_call.calls - calls)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-v0.1-52b",
                                  "granite-moe-1b-a400m", "mamba2-130m",
                                  "gemma2-27b"])
def test_save_named_changes_no_bit(arch):
    jmodel, jparams, model, params = _models(arch)
    jbatch, batch = _batch(model.cfg.vocab)
    l0, g0, copies0, calls0 = _run(model, params, batch, "none")
    l1, g1, copies1, calls1 = _run(model, params, batch, "save_named")
    assert copies0 == 0 and copies1 == _tags(model.cfg) > 0
    assert calls0 == calls1 == model.cfg.n_periods + 1
    assert torch.equal(l0, l1)
    for (path, a), b in zip(tree.leaves_with_path(g0), tree.leaves(g1)):
        assert torch.equal(a, b), tree.key(path)
    jm = jax_build_model(dataclasses.replace(jmodel.cfg, remat=True,
                                             remat_policy="save_named"))
    jloss, jgrads = jax.value_and_grad(jm.loss)(jparams, jbatch)
    np.testing.assert_allclose(float(l1), float(jloss), rtol=1e-5)
    _same_tree(g1, jgrads, rtol=1e-4, atol=1e-6)


def test_save_named_leaves_the_encoder_decoder_alone():
    """whisper checkpoints its layers without a policy, as the reference's
    encoder-decoder does: no tag, the same bits as ``"none"``."""
    _, _, model, params = _models("whisper-large-v3")
    rng = np.random.default_rng(3)
    cfg = model.cfg
    full = rng.integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": torch.from_numpy(full[:, :-1]),
             "labels": torch.from_numpy(full[:, 1:]),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32))}
    l0, g0, _, _ = _run(model, params, batch, "none")
    l1, g1, copies, calls = _run(model, params, batch, "save_named")
    assert copies == 0 and calls > 0
    assert torch.equal(l0, l1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b)


def test_remat_ckpt_is_identity_outside_a_checkpoint():
    """The tag is ``x`` itself unless a ``save_named`` checkpoint runs; in
    one it is a copy, and its gradient passes through unchanged."""
    x = torch.arange(6.0, requires_grad=True)
    assert layers.remat_ckpt(x) is x
    copies = layers.remat_ckpt.copies
    y = layers.tagging(layers.remat_ckpt)(x)
    assert layers.remat_ckpt.copies == copies + 1
    assert y is not x and torch.equal(y, x)
    (y * torch.arange(6.0)).sum().backward()
    assert torch.equal(x.grad, torch.arange(6.0))

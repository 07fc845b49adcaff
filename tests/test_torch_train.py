"""The port's training path against the JAX package's, on the CPU.

Parameters are drawn by the JAX package and carried across with
``convert.params_from_arrays``; tokens come from numpy seeds or from both
packages' Markov pipelines.  The JAX side runs its default ``attn_impl=
"xla"``, which trains mamba2 through ``ref.ssd_chunked_ref`` (it cannot
differentiate its Pallas SSD kernel), and ``"pallas"`` where only the
forward is compared.  Tolerances (f32, the two add in other orders): loss
rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, parameters after 3 AdamW steps
atol 1e-5, logits and caches 1e-4 / 1e-5 as in ``test_torch_serving.py``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.data import ShardedLoader as JaxShardedLoader
from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro.train import OptConfig as JaxOptConfig
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import make_train_step as jax_make_train_step
from repro_torch import ckpt, tree
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_arrays, params_from_arrays
from repro_torch.data import ShardedLoader
from repro_torch.launch.train import run_training
from repro_torch.models import build_model, lm
from repro_torch.train import OptConfig, adamw_init, adamw_update
from repro_torch.train import make_train_step
from repro_torch.train.step import value_and_grad
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ARCHS = ["mamba2-130m", "internlm2-1.8b"]
# every LM family's gradient: gemma2 (softcaps, sliding window), phi3, the
# MoE dispatch (granite) and the hybrid (jamba: SSM, attention and MoE)
GRAD_ARCHS = ARCHS + ["gemma2-27b", "phi3-mini-3.8b", "granite-moe-1b-a400m",
                      "jamba-v0.1-52b"]


def _models(arch, seed=0, impl="xla"):
    """(jax model, jax params, port model, port params) at smoke size, f32."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(get_config(arch, smoke=True))
    return jmodel, jparams, model, params_from_arrays(jparams, "cpu")


def _batch(vocab, b=2, s=64, seed=1):
    """Tokens and next-token labels, the first three labels of row 0 masked;
    S a multiple of the smoke chunk (the reference's XLA SSD path asks for
    one)."""
    full = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    tokens, labels = full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)
    labels[0, :3] = -100
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})


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


# ------------------------------------------------------------- loss, grads
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients_match(arch):
    jmodel, jparams, model, params = _models(arch)
    jbatch, batch = _batch(model.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, jbatch)
    np.testing.assert_allclose(float(model.loss(params, batch)), float(jloss),
                               rtol=1e-5)
    loss, grads = value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _same_tree(grads, jgrads, rtol=1e-4, atol=1e-6)
    assert all(p.grad is None and not p.requires_grad
               for p in tree.leaves(params))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-v0.1-52b"])
def test_remat_changes_no_bit(arch):
    """``remat=True`` checkpoints each period and loss chunk: the loss and
    gradients are bitwise those without it, and within the gradient
    tolerance of the reference's run with ``jax.checkpoint``."""
    jmodel, jparams, model, params = _models(arch)
    jbatch, batch = _batch(model.cfg.vocab)
    runs = {}
    for remat in (False, True):
        m = build_model(dataclasses.replace(model.cfg, remat=remat))
        calls = lm.remat_call.calls
        runs[remat] = value_and_grad(m, params, batch)
        assert lm.remat_call.calls - calls == (
            m.cfg.n_periods + 1 if remat else 0)  # periods and one chunk
    (l0, g0), (l1, g1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for (path, a), b in zip(tree.leaves_with_path(g0), tree.leaves(g1)):
        assert torch.equal(a, b), tree.key(path)
    jmodel = jax_build_model(dataclasses.replace(jmodel.cfg, remat=True))
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, jbatch)
    np.testing.assert_allclose(float(l1), float(jloss), rtol=1e-5)
    _same_tree(g1, jgrads, rtol=1e-4, atol=1e-6)


def test_remat_policy_save_named_is_refused():
    """``save_named`` is ported (``tests/test_torch_remat.py`` holds it to
    the reference); a policy that neither package knows is refused where a
    checkpoint would apply, and nowhere else."""
    _, _, model, params = _models("internlm2-1.8b")
    _, batch = _batch(model.cfg.vocab)
    m = build_model(dataclasses.replace(model.cfg, remat=True,
                                        remat_policy="save_named"))
    assert torch.isfinite(value_and_grad(m, params, batch)[0])
    m = build_model(dataclasses.replace(model.cfg, remat=True,
                                        remat_policy="save_everything"))
    with pytest.raises(ValueError, match="save_everything"):
        value_and_grad(m, params, batch)
    with torch.no_grad():
        assert torch.isfinite(m.loss(params, batch))


@pytest.mark.parametrize("arch,microbatches",
                         list(itertools.product(ARCHS, [1, 2])))
def test_train_steps_match(arch, microbatches):
    jmodel, jparams, model, params = _models(arch, seed=2)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxOptConfig(**kw),
                                        microbatches))
    step = make_train_step(model, OptConfig(**kw), microbatches)
    jstate, state = jax_adamw_init(jparams), adamw_init(params)
    for i in range(3):
        jbatch, batch = _batch(model.cfg.vocab, b=4, s=32, seed=10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        params, state, m = step(params, state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    _same_tree(params, jparams, rtol=0, atol=1e-5)
    _same_tree(state, jstate, rtol=1e-4, atol=1e-6)


def test_adamw_update_matches():
    """A random tree whose keys exercise the decay mask: ``norm`` and ``_b``
    leaves are not decayed, ``A_log`` and ``D`` are (the mask reads the
    leaf's own key).  Three updates from a carried-across JAX state."""
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 5), "norm": (5,), "conv_b": (7,), "A_log": (4,),
              "D": (4,), "sub": {"norm1": (5,), "out_proj": (5, 3)}}

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return rng.standard_normal(t).astype(np.float32)

    arrays = draw(shapes)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.5,
               clip_norm=0.5)
    jparams = tree.map_tree(jnp.asarray, arrays)
    jstate = jax_adamw_init(jparams)
    jparams, jstate, _ = jax_adamw_update(
        tree.map_tree(jnp.asarray, draw(shapes)), jstate,
        jparams, JaxOptConfig(**cfg))
    params = params_from_arrays(jparams, "cpu")
    state = opt_state_from_arrays(jstate, "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    for _ in range(3):
        g = draw(shapes)
        jparams, jstate, jm = jax_adamw_update(
            tree.map_tree(jnp.asarray, g), jstate, jparams,
            JaxOptConfig(**cfg))
        params, state, m = adamw_update(params_from_arrays(g, "cpu"), state,
                                        params, OptConfig(**cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    _same_tree(params, jparams, rtol=1e-6, atol=1e-6)
    _same_tree(state, jstate, rtol=1e-6, atol=1e-7)
    # with zero gradients only the decayed leaves move
    zero = tree.map_tree(torch.zeros_like, params)
    moved, _, _ = adamw_update(zero, adamw_init(params), params,
                               OptConfig(lr=0.1, warmup_steps=0))
    for (path, p), q in zip(tree.leaves_with_path(params), tree.leaves(moved)):
        decayed = not torch.equal(q, p)
        assert decayed == (path[-1] in ("w", "A_log", "D", "out_proj")), path


# ------------------------------------------------------------- mamba2 model
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mamba2_logits_prefill_and_decode_match(impl):
    jmodel, jparams, model, params = _models("mamba2-130m", seed=4, impl=impl)
    jcfg = jmodel.cfg
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 64))
    want = jax_lm.lm_logits(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    got = lm.lm_logits(params, model.cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)

    prompt = tokens[:, :21].astype(np.int32)          # ragged for chunk 32
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                      32)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                   32)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    _same_tree(caches, jcaches, rtol=1e-5, atol=1e-5)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = logits.argmax(-1)[:, None]
    pos, jpos = torch.full((2,), 21), jnp.full((2,), 21, jnp.int32)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(3):
        assert tok.tolist() == np.asarray(jtok).tolist()
        jlogits, jcaches = decode(jparams, jcaches, jtok, jpos)
        logits, caches = model.decode_step(params, caches, tok, pos)
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4,
                                   atol=1e-4)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
        tok = logits.argmax(-1)[:, None]
        pos, jpos = pos + 1, jpos + 1
    _same_tree(caches, jcaches, rtol=1e-5, atol=1e-5)
    fresh = model.init_caches(2, 32, "cpu")
    _same_tree(fresh, jmodel.init_caches(2, 32), rtol=0, atol=0)


# ------------------------------------------------------------- data, ckpt
def test_loader_batches_match_the_reference():
    mine = ShardedLoader(256, 4, 33, host_id=1, n_hosts=2, seed=5)
    theirs = JaxShardedLoader(256, 4, 33, host_id=1, n_hosts=2, seed=5)
    try:
        for _ in range(3):
            a, b = next(mine), next(theirs)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    finally:
        mine.close()
        theirs.close()


def _train_state(seed):
    jmodel, jparams, model, params = _models("mamba2-130m", seed=seed)
    jbatch, batch = _batch(model.cfg.vocab, s=32)
    jstate = jax_adamw_update(jax.grad(jmodel.loss)(jparams, jbatch),
                              jax_adamw_init(jparams), jparams,
                              JaxOptConfig())[1]
    return (jparams, jstate), (params, opt_state_from_arrays(jstate, "cpu"))


def _bit_equal(port, ref):
    want = {tree.key(p): np.asarray(v) for p, v in tree.leaves_with_path(ref)}
    got = {tree.key(p): v.numpy() for p, v in tree.leaves_with_path(port)}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert np.array_equal(got[k], want[k]), k


def test_checkpoints_cross_between_the_packages(tmp_path):
    (jtree, ptree) = _train_state(6)
    jax_ckpt.save(str(tmp_path / "jax"), 3, jtree)
    template = tree.map_tree(torch.zeros_like, ptree)
    restored, step = ckpt.restore(str(tmp_path / "jax"), template)
    assert step == 3 and isinstance(restored, tuple)
    _bit_equal(restored, jtree)

    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path / "port"), 5, ptree, extra={"arch": "mamba2"})
    saver.wait()
    assert ckpt.latest_step(str(tmp_path / "port")) == 5
    jrestored, step = jax_ckpt.restore(str(tmp_path / "port"), jtree)
    assert step == 5
    _bit_equal(ptree, jrestored)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path / "port"), ({"extra": torch.zeros(1)},))


# ------------------------------------------------------------- run_training
def test_run_training_on_the_cpu(tmp_path):
    cfg = get_config("mamba2-130m", smoke=True)
    out = run_training(cfg, steps=12, global_batch=4, seq_len=32, lr=3e-3,
                       ckpt_dir=str(tmp_path), ckpt_every=6, log_every=0,
                       device="cpu")
    losses = out["losses"]
    assert out["steps_run"] == 12 and len(out["grad_norms"]) == 12
    assert np.isfinite(losses).all() and np.isfinite(out["grad_norms"]).all()
    assert np.mean(losses[-3:]) < losses[0]
    assert out["ssd_launches"] == out["ssd_bwd_launches"] == 0
    assert out["tokens_per_sec"] > 0
    assert ckpt.latest_step(str(tmp_path)) == 12
    # resuming from the last checkpoint runs no further step
    again = run_training(cfg, steps=12, global_batch=4, seq_len=32,
                         ckpt_dir=str(tmp_path), log_every=0, device="cpu")
    assert again["steps_run"] == 0
    for a, b in zip(tree.leaves(again["params"]), tree.leaves(out["params"])):
        assert torch.equal(a, b)


def test_run_training_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(get_config("mamba2-130m", smoke=True), steps=1)

"""The port's model zoo and serving stack against the JAX package's, on the CPU.

Parameters are drawn by the JAX package (``Model.init``) and carried across
with ``convert.params_from_arrays``; prompts come from numpy seeds.  The JAX
side runs both with ``attn_impl="pallas"`` (the Pallas flash kernel in
interpret mode, the reference of the port's kernel) and with the default
``"xla"``.  Logits must agree to 1e-4 (f32: the two sum in another order),
KV caches to 1e-5, and greedy tokens exactly.  The two ``ServingEngine``s,
stepped in lockstep, must make the same tokens, positions, finishes and
counts.  The re-plan's policy and metrics match to rtol 1e-5, the engine
tolerance of the reference.
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

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core import SPACE_SHARED, TIME_SHARED
from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import capacity as jax_capacity
from repro.serving import choose_policy as jax_choose_policy
from repro.serving import queue_scenario as jax_queue_scenario
from repro.serving.scheduler import Request as JaxRequest
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_arrays, scenario_from_arrays
from repro_torch.models import build_model, lm
from repro_torch.serving import (
    Request, ServingEngine, capacity, choose_policy, queue_scenario)
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

DENSE = ["internlm2-1.8b", "gemma2-27b", "qwen3-32b", "phi3-mini-3.8b"]


def _models(arch, seed=0):
    """(jax cfg, jax model, jax params, port model, port params)."""
    jcfg = jax_get_config(arch, smoke=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(get_config(arch, smoke=True))
    return jcfg, jmodel, jparams, model, params_from_arrays(jparams, "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _same_tree(port, ref, tol):
    assert port.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            _same_tree(port[k], ref[k], tol)
        else:
            assert tuple(port[k].shape) == tuple(ref[k].shape), k
            np.testing.assert_allclose(_np(port[k]), _np(ref[k]), rtol=tol,
                                       atol=tol, err_msg=k)


# ------------------------------------------------------------- configs
def test_registry_matches_the_reference():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            mine = dataclasses.asdict(get_config(arch, smoke=smoke))
            ref = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
            assert ref.pop("attn_impl") == "xla"
            assert mine == ref, arch
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert capacity.kv_bytes_per_token(cfg) == \
            jax_capacity.kv_bytes_per_token(jcfg)
        if capacity.n_attn_layers(cfg):     # mamba2 keeps no KV cache
            assert capacity.kv_blocks_per_device(cfg, 80e9) == \
                jax_capacity.kv_blocks_per_device(jcfg, 80e9)
    assert get_config("internlm2-1.8b").compute_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_builds_every_arch(arch):
    """Every family of the registry builds, and its parameters and caches
    have the reference's tree and shapes."""
    jcfg = jax_get_config(arch, smoke=True)
    jmodel = jax_build_model(jcfg)
    model = build_model(get_config(arch, smoke=True))
    params = model.init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jcaches = jax.eval_shape(lambda: jmodel.init_caches(2, 16))
    for mine, ref in ((params, shapes), (model.init_caches(2, 16, "cpu"),
                                         jcaches)):
        got = [(tree.key(p), tuple(v.shape))
               for p, v in tree.leaves_with_path(mine)]
        want = [("/".join(str(k.key) for k in p), tuple(v.shape))
                for p, v in jax.tree_util.tree_leaves_with_path(ref)]
        assert got == want, arch


# ------------------------------------------------------------- models
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match(arch, impl):
    jcfg, jmodel, jparams, model, params = _models(arch)
    jmodel = jax_build_model(dataclasses.replace(jcfg, attn_impl=impl))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab, size=(2, 21)).astype(np.int32)
    max_len = 32
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                      max_len)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                   max_len)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    _same_tree(caches, jcaches, 1e-5)

    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = logits.argmax(-1)[:, None]
    jpos = jnp.full((2,), 21, jnp.int32)
    pos = torch.full((2,), 21)
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


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-32b"])
def test_lm_logits_match(arch):
    jcfg, _, jparams, model, params = _models(arch, seed=3)
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, size=(2, 40))
    want = jax_lm.lm_logits(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    got = lm.lm_logits(params, model.cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_decode_past_the_cache_writes_nothing():
    """An idle slot's position runs past ``max_len``; the reference's one-hot
    write is then all zeros, and the port's indexed store skips it."""
    jcfg, jmodel, jparams, model, params = _models("internlm2-1.8b")
    jcaches = jmodel.init_caches(2, 8)
    caches = model.init_caches(2, 8, "cpu")
    pos = np.array([3, 9], np.int32)
    tok = np.array([[5], [7]], np.int32)
    jlogits, jcaches = jmodel.decode_step(jparams, jcaches, jnp.asarray(tok),
                                          jnp.asarray(pos))
    logits, caches = model.decode_step(params, caches,
                                       torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos).long())
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4, atol=1e-4)
    _same_tree(caches, jcaches, 1e-5)
    assert torch.count_nonzero(caches["sub0"]["k"][:, 1]) == 0


# ------------------------------------------------------------- serving
def _lockstep_requests(rng, vocab):
    return [(rng.integers(0, vocab, size=int(n)), int(m))
            for n, m in zip(rng.integers(4, 12, size=5),
                            rng.integers(3, 8, size=5))]


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("policy", [SPACE_SHARED, TIME_SHARED])
def test_engines_step_in_lockstep(policy, slots):
    """With a quantum of 3 steps, these seeds preempt under time sharing
    and still drain (the reference's re-admission restarts a preempted
    request, so other seeds can cycle for ever: ROADMAP Queue C)."""
    jcfg, jmodel, jparams, model, params = _models("internlm2-1.8b", seed=4)
    kw = dict(n_slots=slots, max_len=24, policy=policy, quantum=3,
              replan_every=0)
    jeng = JaxServingEngine(jmodel, jparams, **kw)
    eng = ServingEngine(model, params, device="cpu", **kw)
    rng = np.random.default_rng(slots - 1)
    for prompt, new in _lockstep_requests(rng, jcfg.vocab):
        jeng.submit(prompt, max_new_tokens=new)
        eng.submit(prompt, max_new_tokens=new)
    while any(not r.done for r in jeng.requests) and jeng.steps < 40:
        jout, out = jeng.step(), eng.step()
        assert out["finished"] == jout["finished"]
        assert out["active"] == jout["active"]
        assert eng.tokens.tolist() == np.asarray(jeng.tokens).tolist()
        assert eng.pos.tolist() == np.asarray(jeng.pos).tolist()
        assert [r.slot for r in eng.requests] == [r.slot for r in jeng.requests]
    assert eng.steps == jeng.steps and all(r.done for r in eng.requests)
    for r, jr in zip(eng.requests, jeng.requests):
        assert (r.finish_time, r.generated) == (jr.finish_time, jr.generated)
    assert eng.stats["decode_steps"] == eng.steps
    if policy == TIME_SHARED:
        assert eng.stats["prefills"] > len(eng.requests)    # re-prefills
    else:
        assert eng.stats["prefills"] == len(eng.requests)


def test_ssm_engines_step_in_lockstep():
    """mamba2 through both engines: the slot rows of the conv and state
    caches are written by prefill and advanced by decode."""
    jcfg, jmodel, jparams, model, params = _models("mamba2-130m", seed=5)
    kw = dict(n_slots=2, max_len=24, policy=SPACE_SHARED, replan_every=0)
    jeng = JaxServingEngine(jmodel, jparams, **kw)
    eng = ServingEngine(model, params, device="cpu", **kw)
    for prompt, new in _lockstep_requests(np.random.default_rng(3),
                                          jcfg.vocab):
        jeng.submit(prompt, max_new_tokens=new)
        eng.submit(prompt, max_new_tokens=new)
    while any(not r.done for r in jeng.requests) and jeng.steps < 40:
        jout, out = jeng.step(), eng.step()
        assert out["finished"] == jout["finished"]
        assert eng.tokens.tolist() == np.asarray(jeng.tokens).tolist()
    assert eng.steps == jeng.steps and all(r.done for r in eng.requests)
    _same_tree(eng.caches, jeng.caches, 1e-5)


def test_serving_runs_without_gradients(monkeypatch):
    """The engine serves under ``torch.no_grad()``, so the flash kernel's
    wrapper, which refuses autograd, serves parameters that require a
    gradient."""
    from repro_torch.models import attention
    _, _, _, model, params = _models("internlm2-1.8b")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    seen = []
    plain = attention.ops.flash_attention

    def recording(*args, **kw):
        seen.append(torch.is_grad_enabled())
        return plain(*args, **kw)

    monkeypatch.setattr(attention.ops, "flash_attention", recording)
    eng = ServingEngine(model, params, n_slots=1, max_len=16, device="cpu")
    eng.submit(np.arange(5), max_new_tokens=3)
    eng.run_until_drained()
    assert seen and not any(seen) and eng.requests[0].done


def _queue(n, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        new = int(rng.integers(4, 100))
        reqs.append(dict(rid=i, arrival=float(i), prompt_len=8,
                         max_new_tokens=new, generated=int(rng.integers(0, new)),
                         slot=i % 3 - 1, done=bool(i % 5 == 4)))
    return reqs


@pytest.mark.parametrize("n,slots,tps", [(8, 2, 100.0), (5, 4, 37.5),
                                         (1, 1, 250.0), (12, 3, 80.0)])
def test_choose_policy_matches(n, slots, tps):
    reqs = _queue(n, n)
    pol, metrics = choose_policy([Request(**r) for r in reqs], slots, tps,
                                 device="cpu")
    jpol, jmetrics = jax_choose_policy([JaxRequest(**r) for r in reqs], slots,
                                       tps)
    assert pol == jpol and metrics.keys() == jmetrics.keys()
    for name in jmetrics:
        for key, want in jmetrics[name].items():
            np.testing.assert_allclose(metrics[name][key], want, rtol=1e-5)


@pytest.mark.parametrize("vm_policy", [SPACE_SHARED, TIME_SHARED])
def test_queue_scenario_matches(vm_policy):
    reqs = _queue(7, 0)
    scn = queue_scenario([Request(**r) for r in reqs], 3, 55.0, vm_policy,
                         device="cpu")
    want = scenario_from_arrays(
        jax_queue_scenario([JaxRequest(**r) for r in reqs], 3, 55.0, vm_policy),
        "cpu")
    for a, b in zip(scn.leaves(), want.leaves(), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_choose_policy_on_an_empty_queue():
    reqs = [Request(rid=0, arrival=0.0, prompt_len=4, max_new_tokens=4,
                    done=True)]
    assert choose_policy(reqs, 2, 100.0, device="cpu") == (SPACE_SHARED, {})


def test_serve_cli_runs_on_the_cpu():
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "internlm2-1.8b", "--smoke", "--device", "cpu", "--requests", "3",
         "--replan-every", "4"],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] done=True" in proc.stdout

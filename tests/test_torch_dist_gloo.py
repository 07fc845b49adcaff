"""The port's multi-rank paths over gloo processes, against its one-process
paths and the JAX package's.

Each test computes the reference's values here, writes them with the
inputs to ``tmp_path``, and starts one ``tests/torch_gloo_worker.py``
process per rank (torch, numpy and ``repro_torch`` only), which meet in a
``FileStore`` under ``tmp_path`` and destroy their process group before
they exit; the join has its own timeout.

* Expert-parallel MoE on a ``(2, 2)`` mesh (granite-moe, smoke widths):
  both schedules, sequence parallelism and the fallback to the local path,
  and on a ``(2, 1, 2)`` ``("pod", "data", "model")`` mesh;
  output within 2e-4 and the balance loss within 1e-4 of the port's local
  path and of the reference's ``_moe_local``, as the reference's own EP
  test holds them; the gradients of ``sum(y * w) + 3 aux`` within 2e-4 of
  each leaf's largest value of the local path's.
* Length-sharded decode on a ``(1, 4)`` mesh (internlm2 smoke: 2 kv heads
  over 4 ranks, a 16-row cache): logits within 2e-3 and caches within
  1e-5 of the port's unsharded decode and of the reference's.
* The sharded campaign on ``(4, 1)``: whole, in chunks and folded, bitwise
  the port's local run; against ``jax.jit(simulate)`` integers and
  ``n_events`` exactly and floats within rtol 1e-6.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import scenarios as jax_scenarios
from repro.core import simulate as jax_simulate
from repro.core import stack_scenarios as jax_stack_scenarios
from repro.dist import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_gloo_worker.py"
TIMEOUT_S = 240


def _flat(values, prefix: str) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(values)
    return {f"{prefix}/{jax_sharding._path_str(p)}": np.asarray(v)
            for p, v in flat}


def _spawn(case: str, world: int, where: Path, args: dict,
           data: dict) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks; each rank's outputs."""
    (where / "args.json").write_text(json.dumps(args))
    np.savez(where / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(world), str(where)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [dict(np.load(where / f"out{r}.npz")) for r in range(world)]


def _same_on_every_rank(outs: list[dict]) -> dict:
    for other in outs[1:]:
        assert other.keys() == outs[0].keys()
        for k in outs[0]:
            np.testing.assert_array_equal(other[k], outs[0][k], err_msg=k)
    return outs[0]


# ----------------------------------------------------------------- MoE EP
@pytest.mark.parametrize("B,S,seq_par,schedule,mesh", [
    (4, 16, False, "weight_gather", (2, 2)),
    (2, 8, False, "token_gather", (2, 2)),
    (4, 16, True, "weight_gather", (2, 2)),
    (1, 8, False, "local", (2, 2)),      # B does not divide the data axis
    # batch over ("pod", "data"), F over "data" alone: the weight gather
    # runs over the F axis, not the batch axes
    (4, 16, False, "weight_gather", (2, 1, 2)),
])
def test_expert_parallel_moe_matches_the_local_path(tmp_path, B, S, seq_par,
                                                    schedule, mesh):
    arch = "granite-moe-1b-a400m"
    cfg = jax_get_config(arch, smoke=True)
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    pp = jax.tree.map(lambda a: a[0], jparams["periods"])["sub0"]["mlp"]
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = jax_moe._moe_local(pp, cfg, jnp.asarray(x))
    axes = ("pod", "data", "model")[-len(mesh):]
    out = _same_on_every_rank(_spawn(
        "moe", 4, tmp_path, {"arch": arch, "mesh": list(mesh), "axes": axes,
                             "sequence_parallel": seq_par},
        {"x": x, "w": w, **_flat(pp, "params")}))
    assert str(out["schedule"]) == schedule
    for want_y, want_aux in ((out["local/y"], out["local/aux"]),
                             (np.asarray(y_ref), np.asarray(aux_ref))):
        assert np.abs(out["ep/y"] - want_y).max() < 2e-4
        assert abs(float(out["ep/aux"]) - float(want_aux)) < 1e-4
    grads = [k[len("local/"):] for k in out if k.startswith("local/grads/")
             or k == "local/dx"]
    assert len(grads) == 5
    for k in grads:
        want, got = out[f"local/{k}"], out[f"ep/{k}"]
        assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max(), k


# --------------------------------------------------- length-sharded decode
def test_length_sharded_decode_matches_the_unsharded(tmp_path):
    arch = "internlm2-1.8b"
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    B, S, L = 4, 8, 16
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         cfg.vocab, jnp.int32))
    _, caches = model.prefill(params, {"tokens": jnp.asarray(toks[:, :S - 2])},
                              L)
    pos = jnp.full((B,), S - 2, jnp.int32)
    ref_logits, ref_caches = model.decode_step(
        params, caches, jnp.asarray(toks[:, S - 2][:, None]), pos)
    assert cfg.n_kv_heads % 4 and L % 4 == 0        # the sharded path runs
    out = _same_on_every_rank(_spawn(
        "decode", 4, tmp_path, {"arch": arch, "mesh": [1, 4], "S": S,
                                "L": L},
        {"tokens": toks, **_flat(params, "params")}))
    ref = {"logits": np.asarray(ref_logits),
           **{k[len("c/"):]: v for k, v in _flat(ref_caches, "c").items()}}
    for want in ({"logits": out["plain/logits"],
                  **{k[len("plain/caches/"):]: v for k, v in out.items()
                     if k.startswith("plain/caches/")}}, ref):
        assert np.abs(out["sharded/logits"] - want["logits"]).max() < 2e-3
        keys = [k for k in want if k != "logits"]
        assert len(keys) == 2
        for k in keys:
            got = out[f"sharded/caches/{k}"]
            assert np.abs(got - want[k]).max() < 1e-5, k


# ------------------------------------------------------- sharded campaign
def test_sharded_campaign_is_bitwise_the_local_run(tmp_path):
    jres = jax.jit(jax_simulate)(jax_stack_scenarios([
        jax_scenarios.fig4_scenario(hp, vp)
        for hp in (0, 1) for vp in (0, 1)] * 2))
    out = _same_on_every_rank(_spawn("campaign", 4, tmp_path,
                                     {"mesh": [4, 1]}, {}))
    fields = [k[len("local/"):] for k in out if k.startswith("local/")]
    assert "finish_t" in fields and "n_events" in fields
    for name in ("sharded", "chunked"):
        for f in fields:
            np.testing.assert_array_equal(out[f"{name}/{f}"],
                                          out[f"local/{f}"], err_msg=f)
    folds = [k[len("fold_local/"):] for k in out
             if k.startswith("fold_local/")]
    assert len(folds) > 3
    for k in folds:
        np.testing.assert_array_equal(out[f"fold_sharded/{k}"],
                                      out[f"fold_local/{k}"], err_msg=k)
    for f in fields:
        want = np.asarray(getattr(jres, f))
        got = out[f"sharded/{f}"]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)

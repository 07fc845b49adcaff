"""The port's twins of ``examples/`` (``examples_torch/``) against the JAX
package's functions on the same inputs, on the CPU.

Each twin's ``main(["--device", "cpu", ...])`` returns the numbers it
prints.  Engine numbers are held to the reference's ``jax.jit(simulate)``
(integers exactly, floats within rtol 1e-5, as in
``tests/test_torch_engine.py``); the search to the reference's rung loop
on the reference's drawn table and outage schedules (as in
``tests/test_torch_search.py``); the served requests to the reference's
``ServingEngine`` on the same requests (``tests/test_torch_serving.py``);
the restart plans to the reference's ``plan_restart``, run in a fresh
interpreter (``tests/test_torch_elastic.py``); and the 98M model's losses
to the reference's ``run_training`` from the same parameters and tokens.
``campaign_search`` and ``train_100m`` run at a reduced size.
"""
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SPACE_SHARED, TIME_SHARED
from repro.core import Scenario as JaxScenario
from repro.core import scenarios as jscn
from repro.core import search as jsearch
from repro.core import simulate as jax_simulate
from repro.core import stack_scenarios as jax_stack
from repro_torch.convert import params_from_arrays
from repro_torch.core import Outages, search
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
_jax_simulate = jax.jit(jax_simulate)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin(name: str):
    return _load(ROOT / "examples_torch" / f"{name}.py", f"twin_{name}")


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


def test_twins_run_on_the_gpu_by_default():
    """Every twin takes ``--device`` and, without it, asks for the GPU."""
    for name in ("quickstart", "federated_cloud", "campaign_search",
                 "serve_model", "elastic_restart", "train_100m"):
        twin = _twin(name)
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twin.main([])


def test_quickstart_matches_reference(capsys):
    out = _twin("quickstart").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "campaign (batch-major) makespans:" in printed
    hosts = jscn.uniform_hosts(1, 4, cores=2, mips=1000.0)
    vms = jscn.uniform_vms(6)
    cls = jscn.make_cloudlets(vm=np.tile(np.arange(6), 2),
                              length_mi=np.full(12, 1_200_000.0),
                              submit_t=np.repeat([0.0, 600.0], 6))

    def scenario(hp, vp):
        return JaxScenario(hosts=hosts, vms=vms, cloudlets=cls,
                           market=jscn.uniform_market(1),
                           policy=jscn.make_policy(hp, vp))

    pairs = [(hp, vp) for hp in (SPACE_SHARED, TIME_SHARED)
             for vp in (SPACE_SHARED, TIME_SHARED)]
    assert [row[:2] for row in out["combos"]] == [
        [h, v] for h in ("space", "time") for v in ("space", "time")]
    for row, (hp, vp) in zip(out["combos"], pairs):
        res = _jax_simulate(scenario(hp, vp))
        _close(row[2:], [float(res.mean_turnaround), float(res.makespan),
                         float(res.total_cost)])
    # Fig. 4's analytic anchors: 1,500 / 1,800 s turnaround, 2,400 s makespan
    assert [round(r[2]) for r in out["combos"]] == [1500, 1800, 1500, 1800]
    camp = _jax_simulate(jax_stack([scenario(hp, vp) for hp, vp in pairs]))
    _close(out["campaign_makespans"], np.asarray(camp.makespan))


def test_federated_cloud_matches_reference():
    out = _twin("federated_cloud").main(["--device", "cpu"])
    nofed = _jax_simulate(jscn.table1_scenario(False))
    _close(out["no_federation"], [float(nofed.mean_turnaround),
                                  float(nofed.makespan)])
    assert [r[0] for r in out["rows"]] == [3, 5, 7, 9]
    for bg, n_mig, tat, mk, tat_cut, mk_cut in out["rows"]:
        fed = _jax_simulate(jscn.table1_scenario(True, peer_background=bg))
        assert n_mig == int(fed.n_migrations)
        _close([tat, mk], [float(fed.mean_turnaround), float(fed.makespan)])
        _close([tat_cut, mk_cut], [
            100 * (1 - float(fed.mean_turnaround)
                   / float(nofed.mean_turnaround)),
            100 * (1 - float(fed.makespan) / float(nofed.makespan))],
            rtol=1e-4)


def test_campaign_search_matches_reference(monkeypatch):
    """At 4 candidates over two short rungs: the twin's search, with the
    reference's candidate table and outage draws carried across, against
    the reference's rung loop."""
    twin = _twin("campaign_search")
    ref = _load(ROOT / "examples" / "campaign_search.py", "ref_search")
    n0, horizons = 4, (3000.0, 6000.0)
    k_sample, k_inst = jax.random.split(jax.random.PRNGKey(42))
    table = jsearch.sample_params(k_sample, ref.SPACE, n0)
    jtemplate = jscn.reliability_scenario(key=jax.random.PRNGKey(0),
                                          federation=True,
                                          sensor_interval=50.0)

    def port_instantiate(template, extras, n, generator):
        mtbf = jnp.asarray(extras["mtbf_s"].numpy())
        jo = ref.instantiate(jtemplate, {"mtbf_s": mtbf}, n, k_inst)["outages"]
        return {"outages": Outages(
            fail_t=torch.from_numpy(np.array(jo.fail_t)),
            repair_t=torch.from_numpy(np.array(jo.repair_t)))}

    monkeypatch.setattr(search, "sample_params", lambda gen, space, n: {
        k: torch.from_numpy(np.array(v)) for k, v in table.items()})
    monkeypatch.setattr(twin, "instantiate", port_instantiate)
    out = twin.main(["--device", "cpu", "--n0", str(n0), "--horizons",
                     *map(str, horizons)])

    alive = np.arange(n0)
    rungs = []
    for fid in horizons:
        cand = {k: v[alive] for k, v in table.items()}
        cand["horizon"] = jnp.full((alive.shape[0],), fid, jnp.float32)
        batched = jsearch.build_campaign(jtemplate, cand,
                                         instantiate=ref.instantiate,
                                         key=k_inst)
        values = np.asarray(_jax_simulate(batched).total_cost)
        rungs.append((alive, values))
        alive = alive[np.argsort(values, kind="stable")[:max(len(alive)
                                                            // 2, 1)]]
    for (fid, n, best), (cands, values), h in zip(out["rungs"], rungs,
                                                  horizons):
        assert (fid, n) == (h, len(cands))
        _close(best, values.min())
    cands0, values0 = rungs[0]
    order = np.argsort(values0, kind="stable")[: n0 // 2]
    assert [row[0] for row in out["frontier"]] == [int(cands0[j])
                                                   for j in order]
    _close([row[4] for row in out["frontier"]], values0[order])
    best = int(alive[0])
    assert out["winner"]["index"] == best
    assert out["winner"]["mtbf_s"] == float(table["mtbf_s"][best])
    assert out["winner"]["ckpt_interval"] == float(
        table["ckpt_interval"][best])
    _close(out["winner"]["total_cost"], rungs[-1][1].min())


def test_serve_model_matches_reference():
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.serving import ServingEngine as JaxEngine

    out = _twin("serve_model").main(["--device", "cpu"])
    cfg = jget_config("internlm2-1.8b", smoke=True)
    assert out["d_head"] == cfg.d_head == 16      # the reference's own model
    model = jbuild_model(cfg)
    eng = JaxEngine(model, model.init(jax.random.PRNGKey(0)), n_slots=2,
                    max_len=96, replan_every=4)
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(rng.integers(0, cfg.vocab, size=8 + 4 * (i % 3)),
                   max_new_tokens=6 + 2 * (i % 2))
    want = []
    while any(not r.done for r in eng.requests):
        info = eng.step()
        if info["finished"]:
            want.append([info["step"], list(info["finished"]),
                         info["active"],
                         "space" if eng.sched.policy == 0 else "time"])
    assert out["finished"] == want
    tats = [r.finish_time - r.arrival for r in eng.requests]
    assert out["served"] == len(eng.requests) == 6
    assert out["mean_turnaround"] == float(np.mean(tats))
    assert out["makespan"] == eng.steps


def test_elastic_restart_matches_reference():
    """Failures at steps 9 and 20 resume from the checkpoints of steps 6
    and 18 on 3 and 2 workers; each restart plan is the reference's."""
    from repro.configs import get_config as jget_config

    out = _twin("elastic_restart").main(["--device", "cpu"])
    assert out["d_head"] == jget_config("internlm2-1.8b", smoke=True).d_head
    assert out["restarts"] == 2
    assert [f[:2] for f in out["failures"]] == [[6, 3], [18, 2]]
    grid = [(30 - 6, 4, 3, 600.0), (30 - 18, 4, 2, 600.0)]
    code = (
        "import dataclasses, json, sys\n"
        "from repro.launch.elastic import plan_restart\n"
        "grid = json.loads(sys.argv[1])\n"
        "print(json.dumps([dataclasses.asdict(plan_restart(s, 1.0, w, n, r))"
        " for s, w, n, r in grid]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", code, json.dumps(grid)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    for got, want in zip(out["failures"],
                         json.loads(ref.stdout.splitlines()[-1])):
        assert got[2:] == [want["choice"], want["finish_on_survivors_s"],
                           want["wait_for_repair_s"]]
    assert len(out["losses"]) == 30 - 18
    assert math.isfinite(out["final_loss"])


def test_train_100m_matches_reference(monkeypatch):
    """8 steps of 2 x 32 tokens from the reference's initial parameters,
    handed to the twin's step-0 checkpoint (8: the fewest after which the
    loss is below the first, which the example asserts):
    the same config, parameter count and losses as the reference's
    ``run_training``."""
    from repro.launch.train import run_training as jax_run_training
    from repro.models import build_model as jbuild_model
    from repro_torch.models import build_model as port_build_model

    twin = _twin("train_100m")
    ref = _load(ROOT / "examples" / "train_100m.py", "ref_train_100m")
    jcfg = ref.config_100m()
    cfg = twin.config_100m()
    common = {f.name for f in dataclasses.fields(cfg)} & {
        f.name for f in dataclasses.fields(jcfg)}
    assert common and all(getattr(cfg, k) == getattr(jcfg, k)
                          for k in common)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))

    class FromReference:
        """The port's model, initialised with the reference's draw."""

        def __init__(self, c):
            self.model = port_build_model(c)

        def __getattr__(self, name):
            return getattr(self.model, name)

        def init(self, generator):
            return params_from_arrays(jparams, "cpu")

    monkeypatch.setattr(twin, "build_model", FromReference)
    kw = dict(steps=8, global_batch=2, seq_len=32)
    out = twin.main(["--device", "cpu", "--steps", "8", "--global-batch",
                     "2", "--seq-len", "32"])
    assert out["n_params"] == jcfg.param_count()
    with tempfile.TemporaryDirectory() as d:
        want = jax_run_training(jcfg, lr=6e-4, ckpt_dir=d, ckpt_every=50,
                                log_every=10, **kw)
    assert out["steps_run"] == want["steps_run"] == 8
    _close(out["losses"][:1], want["losses"][:1])
    _close(out["losses"], want["losses"], rtol=1e-4)

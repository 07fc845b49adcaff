"""The port's elastic runtime (``launch/elastic.py``) against the JAX
package's, on the CPU.

``plan_restart`` builds the reference's one-DC space-shared scenario with
the port's builders and runs the port's ``simulate``: its makespans and its
choice must equal the reference's over a grid of remaining steps, workers,
survivors and repair times.  The reference's values are computed in a
fresh interpreter (its campaign tests donate JAX buffers, which other files
on an xdist worker may share).  ``ElasticRunner`` runs the reference test's
schedule on internlm2's smoke configuration: failures at steps 10 and 17,
resumed from the checkpoints of steps 6 and 12, each restart planned as the
reference plans it.  Only ``InjectedFailure`` counts as a lost node: any
other ``RuntimeError`` (a CUDA launch fault) propagates on the first try.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import elastic
from repro_torch.launch.elastic import ElasticRunner, plan_restart
from repro_torch.launch.train import InjectedFailure
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
# (steps remaining, workers, survivors, repair s): the reference's tradeoff
# pair, the elastic run's two restarts, a tie, one worker and a near tie;
# the reference compiles its engine afresh at each call (~4-7 s)
GRID = [(100, 8, 2, 5.0), (100, 8, 2, 10_000.0), (18, 4, 3, 600.0),
        (12, 4, 2, 600.0), (7, 4, 4, 0.0), (1, 1, 1, 0.0), (50, 8, 7, 30.0)]


@pytest.fixture(scope="module")
def reference_plans() -> dict:
    code = (
        "import dataclasses, json, sys\n"
        "from repro.launch.elastic import plan_restart\n"
        "grid = json.loads(sys.argv[1])\n"
        "print(json.dumps([dataclasses.asdict(plan_restart(s, 1.0, w, n, r))"
        " for s, w, n, r in grid]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(GRID)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(zip(map(tuple, GRID), json.loads(out.stdout.splitlines()[-1])))


@pytest.mark.parametrize("steps,workers,survivors,repair", GRID)
def test_plan_restart_matches_the_reference(reference_plans, steps, workers,
                                            survivors, repair):
    got = plan_restart(steps, 1.0, workers, survivors, repair, device="cpu")
    want = reference_plans[(steps, workers, survivors, repair)]
    assert got.finish_on_survivors_s == want["finish_on_survivors_s"]
    assert got.wait_for_repair_s == want["wait_for_repair_s"]
    assert got.choice == want["choice"]


def test_restart_plan_tradeoff():
    """The plan flips as the repair time grows (the reference's check)."""
    fast = plan_restart(100, 1.0, 8, 2, 5.0, device="cpu")
    slow = plan_restart(100, 1.0, 8, 2, 10_000.0, device="cpu")
    assert (fast.choice, slow.choice) == ("wait_for_repair", "survivors")


def test_elastic_restart(tmp_path, reference_plans):
    cfg = get_config("internlm2-1.8b", smoke=True)
    runner = ElasticRunner(cfg, str(tmp_path), steps=24, global_batch=4,
                           seq_len=32, ckpt_every=6, n_workers=4,
                           device="cpu")
    out = runner.run(fail_at_steps=[10, 17])
    assert out["restarts"] == 2
    assert [e["kind"] for e in out["events"]] == ["failure", "failure",
                                                  "finished"]
    for event, step, survivors in zip(out["events"], (6, 12), (3, 2)):
        assert event["resume_step"] == step
        assert event["survivors"] == survivors
        assert event["error"] == f"injected failure at step " \
            f"{10 if step == 6 else 17}"
        plan = plan_restart(24 - step, 1.0, 4, survivors, 600.0, device="cpu")
        assert event["plan"] == {
            "finish_on_survivors_s": plan.finish_on_survivors_s,
            "wait_for_repair_s": plan.wait_for_repair_s,
            "choice": plan.choice}
    assert out["result"]["steps_run"] == 12
    assert np.isfinite(out["result"]["final_loss"])
    assert out["events"][-1]["final_loss"] == out["result"]["final_loss"]


def test_elastic_gives_up_after_max_restarts(tmp_path):
    cfg = get_config("mamba2-130m", smoke=True)
    runner = ElasticRunner(cfg, str(tmp_path), steps=6, global_batch=2,
                           seq_len=32, ckpt_every=2, max_restarts=1,
                           device="cpu")
    with pytest.raises(InjectedFailure, match="step 3"):
        runner.run(fail_at_steps=[1, 3])
    assert [e["resume_step"] for e in runner.events] == [None]


def test_a_kernel_fault_is_not_a_node_failure(tmp_path, monkeypatch):
    """A ``RuntimeError`` other than ``InjectedFailure`` (what a CUDA launch
    fault or an out-of-memory error raises) is not retried."""
    calls = []

    def faulty(cfg, **kw):
        calls.append(kw["fail_at_step"])
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(elastic, "run_training", faulty)
    runner = ElasticRunner(get_config("mamba2-130m", smoke=True),
                           str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        runner.run(fail_at_steps=[3])
    assert calls == [3] and runner.events == []
    assert issubclass(InjectedFailure, RuntimeError)

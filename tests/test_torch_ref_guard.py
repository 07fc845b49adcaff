"""The guard of ``tests/torch_ref_guard.py`` against the reference's donated
``INF``.

The reference's chunked ``run_campaign`` donates its inputs, among them the
module constant ``repro.core.entities.INF``, which ``ArgBestReducer``'s
initial carry holds.  The donation runs in a fresh
interpreter, so that no pytest worker is polluted on purpose; the child
reports what it saw as JSON.  There the deleted ``INF`` first breaks a
``jax.jit(simulate)`` of Fig. 4; after the guard, the same call runs and
matches the port's ``simulate`` (integers exactly, floats within rtol 1e-5,
as ``tests/test_torch_engine.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_ref_guard

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, types
import numpy as np
from repro.core import run_campaign, scenarios, simulate, stack_scenarios
from repro.core import entities, reducers
from repro.core.reducers import ArgBestReducer, SumReducer, ValuesReducer
import jax
import torch_ref_guard
from test_torch_engine import assert_results_match
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import simulate as port_simulate

out = {}
# a module holding INF as a test module does: an attribute and a default
probe = types.ModuleType("guard_probe")
probe.INF = entities.INF
exec("def build(ckpt=INF):\n    return ckpt", probe.__dict__)
sys.modules["guard_probe"] = probe
# As tests/test_reducers.py::test_chunk_size_invariance, at 16 rows.
base = [scenarios.fig4_scenario(hp, vp) for hp in (0, 1) for vp in (0, 1)]
rows = [s.replace(cloudlets=s.cloudlets.replace(
            length_mi=s.cloudlets.length_mi * (1.0 + 0.02 * i)))
        for i, s in enumerate(base * 4)]
reduce = {"events": SumReducer("n_events"),
          "best": ArgBestReducer("mean_turnaround"),
          "vals": ValuesReducer("mean_turnaround", n_slots=16)}
try:
    run_campaign(stack_scenarios(rows), chunk_size=8, reduce=reduce)
except Exception as e:  # the reference's own failure is not under test
    out["campaign_error"] = type(e).__name__
out["deleted"] = bool(entities.INF.is_deleted())
out["reducers_deleted"] = bool(reducers.INF.is_deleted())
fig4 = scenarios.fig4_scenario(0, 0)
try:
    jax.jit(simulate)(fig4).finish_t.block_until_ready()
    out["before"] = "ran"
except (RuntimeError, ValueError) as e:
    out["before"] = type(e).__name__
out["rebound"] = torch_ref_guard.revive()
out["deleted_after"] = bool(entities.INF.is_deleted())
out["same_array"] = all(
    getattr(sys.modules[m], "INF") is entities.INF
    for m in ("repro.core.reducers", "repro.core.policies",
              "repro.core.provision", "repro.core.workload",
              "repro.core.kvserve", "guard_probe"))
out["probe_default"] = probe.build() is entities.INF
ref = jax.jit(simulate)(fig4)
port = port_simulate(scenario_from_arrays(fig4, "cpu"), device="cpu")
assert_results_match(ref, port)
out["finish_t"] = np.asarray(ref.finish_t).tolist()
out["parity"] = True
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_chunked_campaign_deletes_reference_inf(child):
    """If a later jax stops donating ``INF``, this says so."""
    assert child["deleted"] and child["reducers_deleted"]
    assert child["before"] != "ran"


def test_guard_rebinds_every_holder(child):
    """The five modules above, ``repro.core``'s export, ``entities`` and a
    module that holds ``INF`` as a test module does (an attribute and a
    default argument)."""
    assert child["rebound"] >= 8
    assert not child["deleted_after"]
    assert child["same_array"] and child["probe_default"]


def test_reference_and_port_agree_after_guard(child):
    assert child["parity"]
    assert child["finish_t"] == [400.0, 400.0, 800.0, 800.0,
                                 1200.0, 1200.0, 1600.0, 1600.0]


def test_guard_is_a_no_op_while_inf_lives():
    from repro.core import entities
    if entities.INF.is_deleted():
        torch_ref_guard.revive()
    before = entities.INF
    assert torch_ref_guard.revive() == 0
    assert entities.INF is before

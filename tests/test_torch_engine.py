"""The port's event engine against the JAX package's, on the CPU.

Each scenario is built by the JAX package, carried across through numpy with
``convert.scenario_from_arrays``, and run by both engines: the reference as
``jax.jit(repro.core.simulate)`` with the plain ``sweep_impl="jnp"`` sweep.
Integer and boolean fields (``n_events`` among them) must match exactly;
float fields within rtol 1e-5, the reference's own engine tolerance (float
sums may add in another order, and XLA may fuse a multiply-add that PyTorch
rounds twice).  Within the port, every row of a campaign must be bitwise the
scenario run alone.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AutoscaleInstrument
from repro.core import Outages as JaxOutages
from repro.core import SPACE_SHARED, TIME_SHARED
from repro.core import scenarios as jscn
from repro.core import simulate as jax_simulate
from repro.core import simulate_instrumented as jax_simulate_instrumented
from repro.core.energy import PowerModel as JaxPowerModel
from repro.core.energy import Topology as JaxTopology
from repro_torch.convert import result_to_numpy, scenario_from_arrays
from repro_torch.core import (
    UtilizationTimelineInstrument, broadcast_campaign, scenarios, simulate,
    simulate_instrumented, stack_scenarios)
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

_jax_simulate = jax.jit(jax_simulate)


def _service_routed():
    """Every row broker-dispatched (``vm == -1``): exercises
    ``dispatch_cloudlets``."""
    scn = jscn.generated_scenario(jax.random.PRNGKey(7))
    vm = jnp.full_like(scn.cloudlets.vm, -1)
    return scn.replace(cloudlets=scn.cloudlets.replace(vm=vm))


def _powered():
    """Fig. 9/10 at 300 hosts under an idle-gated power model."""
    scn = jscn.fig9_10_scenario(TIME_SHARED, n_hosts=300, n_groups=3)
    return scn.replace(power=JaxPowerModel.uniform(1, gate_idle=True))


PARITY = {
    **{f"fig4_{h}{v}": (lambda h=h, v=v: jscn.fig4_scenario(h, v))
       for h in (SPACE_SHARED, TIME_SHARED) for v in (SPACE_SHARED, TIME_SHARED)},
    "table1_federated": lambda: jscn.table1_scenario(True),
    "table1_alone": lambda: jscn.table1_scenario(False),
    "fig9_10_space": lambda: jscn.fig9_10_scenario(
        SPACE_SHARED, n_hosts=300, n_groups=3),
    "fig9_10_time": lambda: jscn.fig9_10_scenario(
        TIME_SHARED, n_hosts=300, n_groups=3),
    **{f"generated_{s}": (lambda s=s: jscn.generated_scenario(
        jax.random.PRNGKey(s))) for s in range(3)},
    "service_routed": _service_routed,
    "powered": _powered,
}


def assert_results_match(jax_res, torch_res):
    a, b = result_to_numpy(jax_res), result_to_numpy(torch_res)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].shape == a[k].shape, k
        if a[k].dtype.kind in "biu":
            assert b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=0,
                                       err_msg=k)


def assert_bitwise(x, y):
    a, b = result_to_numpy(x), result_to_numpy(y)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_outputs_match(jax_out, torch_out):
    """Instrument outputs ``{name: {key: array}}`` of the two engines:
    integers exactly, floats within rtol 1e-5."""
    assert jax_out.keys() == torch_out.keys()
    for name in jax_out:
        assert jax_out[name].keys() == torch_out[name].keys(), name
        for key, want in jax_out[name].items():
            want = np.asarray(want)
            got = torch_out[name][key].cpu().numpy()
            assert got.shape == want.shape, (name, key)
            if want.dtype.kind in "biu":
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                           err_msg=f"{name}.{key}")


@pytest.mark.parametrize("name", sorted(PARITY))
def test_simulate_matches_jax(name):
    jscn_ = PARITY[name]()
    res = simulate(scenario_from_arrays(jscn_, "cpu"), device="cpu")
    assert_results_match(_jax_simulate(jscn_), res)


def test_paper_anchors_from_the_port_constructors():
    """The port's own constructors reproduce the paper's anchors."""
    ss = simulate(scenarios.fig4_scenario(0, 0, device="cpu"), device="cpu")
    assert ss.finish_t.tolist() == [400.0, 400.0, 800.0, 800.0,
                                    1200.0, 1200.0, 1600.0, 1600.0]
    fed = simulate(scenarios.table1_scenario(True, device="cpu"), device="cpu")
    assert int(fed.n_finished) == 25 and int(fed.n_migrations) == 10
    f910 = simulate(scenarios.fig9_10_scenario(
        SPACE_SHARED, n_hosts=300, n_groups=3, device="cpu"), device="cpu")
    # 1200 s each, up to the float32 rounding of clocks in the thousands
    took = (f910.finish_t - f910.start_t).numpy()
    np.testing.assert_allclose(took, 1200.0, rtol=1e-6)
    empty = simulate(scenarios.fig7_8_scenario(1000, device="cpu"), device="cpu")
    assert int(empty.n_finished) == 1


@pytest.mark.parametrize("family", ["fig4", "table1", "fig9_10"])
def test_port_constructors_match_jax_constructors(family):
    """The port's constructors give the arrays the reference's give."""
    pairs = {
        "fig4": (jscn.fig4_scenario(1, 0),
                 scenarios.fig4_scenario(1, 0, device="cpu")),
        "table1": (jscn.table1_scenario(True),
                   scenarios.table1_scenario(True, device="cpu")),
        "fig9_10": (jscn.fig9_10_scenario(TIME_SHARED, n_hosts=40, n_groups=2),
                    scenarios.fig9_10_scenario(TIME_SHARED, n_hosts=40,
                                               n_groups=2, device="cpu")),
    }
    jax_scn, port_scn = pairs[family]
    carried = scenario_from_arrays(jax_scn, "cpu")
    assert carried.max_steps == port_scn.max_steps
    for a, b in zip(carried.leaves(), port_scn.leaves()):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def _campaign_rows():
    return [scenario_from_arrays(PARITY[n](), "cpu")
            for n in ("table1_federated", "table1_alone")]


@pytest.mark.parametrize("family", ["fig4", "table1", "generated"])
def test_batch_rows_are_bitwise_solo_runs(family):
    if family == "fig4":
        rows = [scenarios.fig4_scenario(h, v, device="cpu")
                for h in (0, 1) for v in (0, 1)]
    elif family == "table1":
        rows = _campaign_rows()
    else:
        rows = [scenario_from_arrays(PARITY[f"generated_{s}"](), "cpu")
                for s in range(3)] + [
                    scenario_from_arrays(_service_routed(), "cpu")]
    batch = simulate(stack_scenarios(rows), device="cpu")
    for i, scn in enumerate(rows):
        assert_bitwise(batch.map(lambda x: x[i]), simulate(scn, device="cpu"))


def test_broadcast_campaign_sweeps_a_policy():
    template = scenarios.fig4_scenario(0, 0, device="cpu")
    rows = [scenarios.fig4_scenario(h, v, device="cpu")
            for h in (0, 1) for v in (0, 1)]
    policies = stack_scenarios(rows).policy
    swept = simulate(broadcast_campaign(template, 4, policy=policies),
                     device="cpu")
    assert_bitwise(swept, simulate(stack_scenarios(rows), device="cpu"))
    with pytest.raises(ValueError, match="leading dim 4"):
        broadcast_campaign(template, 4, policy=template.policy)


def test_stack_scenarios_refuses_mixed_static_fields():
    a = scenarios.fig4_scenario(0, 0, device="cpu")
    with pytest.raises(ValueError, match="max_steps"):
        stack_scenarios([a, a.replace(max_steps=7)])
    carried = scenario_from_arrays(_powered(), "cpu")
    with pytest.raises(ValueError, match="power"):
        stack_scenarios([carried, carried.replace(power=None)])


def test_port_never_imports_jax():
    """The port runs end to end without JAX or the JAX package loaded: a
    simulation, a trace, a reliability scenario drawn from a torch seed, a
    streamed staging campaign with a reducer, a random search, a smoke
    prefill and a smoke train step; the dry-run's modules import too."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.kernels.ops\n"
        "from repro_torch.core import PowerModel, scenarios, simulate, "
        "simulate_history, stack_scenarios\n"
        "scn = scenarios.fig4_scenario(1, 1, device='cpu')\n"
        "scn = scn.replace(power=PowerModel.uniform(1, device='cpu'))\n"
        "simulate(scn, device='cpu'); simulate_history(scn, device='cpu')\n"
        "import torch, repro_torch.serving, repro_torch.launch.serve\n"
        "from repro_torch.core import simulate_trace\n"
        "simulate_trace(scn, [100.0, 900.0], device='cpu')\n"
        "rel = scenarios.reliability_scenario(torch.Generator().manual_seed(0),"
        " device='cpu')\n"
        "assert int(simulate(rel, device='cpu').n_finished) == 8\n"
        "from repro_torch.core import reducers, run_campaign, search\n"
        "stg = scenarios.staging_scenario(n_cloudlets=12, device='cpu')\n"
        "out = run_campaign(stack_scenarios([stg, stg]), chunk_size=1,\n"
        "                   reduce=reducers.SumReducer('n_finished'),\n"
        "                   device='cpu')\n"
        "assert int(out) == 24\n"
        "best = search.random_search(scenarios.fig4_scenario(0, 0, "
        "device='cpu'), {'vm_policy': [0, 1]}, generator=torch.Generator()"
        ".manual_seed(0), n=2, device='cpu')\n"
        "assert best['values'].shape == (2,)\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import build_model\n"
        "model = build_model(get_config('internlm2-1.8b', smoke=True))\n"
        "params = model.init(torch.Generator('cpu').manual_seed(0))\n"
        "logits, _ = model.prefill(params, {'tokens': torch.zeros(1, 5, "
        "dtype=torch.long)}, 8)\n"
        "assert logits.shape == (1, 256) and bool(logits.isfinite().all())\n"
        "import repro_torch.launch.train, repro_torch.train, repro_torch.ckpt\n"
        "import repro_torch.data\n"
        "out = repro_torch.launch.train.run_training(\n"
        "    get_config('mamba2-130m', smoke=True), steps=1, global_batch=2,\n"
        "    seq_len=16, log_every=0, device='cpu')\n"
        "assert out['steps_run'] == 1 and out['losses'][0] == out['losses'][0]\n"
        "import repro_torch.analysis, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_the_gpu(monkeypatch):
    """``device=None`` means CUDA; without a GPU it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenarios.fig4_scenario(0, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(scenarios.fig4_scenario(0, 0, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenario_from_arrays(jscn.fig4_scenario(0, 0))


def _with_topology():
    return jscn.table1_scenario(True).replace(topology=JaxTopology.uniform(3))


def _with_outages():
    never = jnp.full((3, 10, 1), 3.0e38, jnp.float32)
    return jscn.table1_scenario(True).replace(
        outages=JaxOutages(fail_t=never, repair_t=never))


@pytest.mark.parametrize("build,piece", [
    (_with_topology, "topology"),
    (_with_outages, "outages"),
    (lambda: jscn.table1_scenario(True).replace(
        instruments=(AutoscaleInstrument(),)), "instruments"),
])
def test_unported_pieces_raise(build, piece):
    """No scenario piece is refused any more: a topology, an outage
    schedule and extra instruments carry across and run as the reference
    runs them (the topology's own families: tests/test_torch_network.py)."""
    jax_scn = build()
    jres, jout = jax.jit(jax_simulate_instrumented)(jax_scn)
    res, out = simulate_instrumented(scenario_from_arrays(jax_scn, "cpu"),
                                     device="cpu")
    assert_results_match(jres, res)
    assert_outputs_match(jout, out)


def test_unported_options_raise():
    """``table1_scenario(live_migration=True)`` builds the reference's
    scenario and runs as it does; extra instruments run, and two of one
    name raise, as in the reference."""
    jax_scn = jscn.table1_scenario(True, live_migration=True)
    port = scenarios.table1_scenario(True, live_migration=True, device="cpu")
    jres, jout = jax.jit(jax_simulate_instrumented)(jax_scn)
    res, out = simulate_instrumented(port, device="cpu")
    assert_results_match(jres, res)
    assert_outputs_match(jout, out)
    scn = scenarios.fig4_scenario(0, 0, device="cpu")
    ts = torch.arange(0.0, 2000.0, 250.0)
    res, out = simulate_instrumented(
        scn, extra_instruments=(UtilizationTimelineInstrument(sample_ts=ts),),
        device="cpu")
    assert out["utilization"]["utilization"].shape == (8, 1)
    with pytest.raises(ValueError, match="duplicate instrument name"):
        simulate_instrumented(
            scn, extra_instruments=(UtilizationTimelineInstrument(sample_ts=ts),
                                    UtilizationTimelineInstrument(sample_ts=ts)),
            device="cpu")

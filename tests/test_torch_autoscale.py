"""The threshold autoscaler and its pool lifecycle in the port against the
JAX package's, on the CPU (DESIGN.md §7).

``autoscale_scenario`` and ``serving_scenario`` workloads are drawn by the
JAX package with ``jax.random``, carried across with
``convert.scenario_from_arrays`` and run by both engines (the reference as
``jax.jit(simulate_instrumented)`` with the plain ``sweep_impl="jnp"``
sweep).  Integer fields, ``n_events`` and the autoscaler's counts match
exactly, floats within rtol 1e-5.  The port's own constructors draw from a
``torch.Generator``: their runs are held to properties and to the port's
own solo runs, not to the reference's numbers for a JAX key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as jscn
from repro.core import simulate_instrumented as jax_simulate_instrumented
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import (
    scenarios, simulate, simulate_history, simulate_instrumented,
    stack_scenarios, step)
from test_torch_engine import (
    assert_bitwise, assert_outputs_match, assert_results_match)
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

_jax_instrumented = jax.jit(jax_simulate_instrumented)


def _off(scn):
    return scn.replace(policy=scn.policy.replace(autoscale=jnp.asarray(False)))


def _key(i):
    return jax.random.PRNGKey(i)


PARITY = {
    "autoscale_on": lambda: jscn.autoscale_scenario(_key(0)),
    "autoscale_off": lambda: _off(jscn.autoscale_scenario(_key(0))),
    "lifecycle": lambda: jscn.autoscale_scenario(_key(3)),
    "scale_down": lambda: jscn.autoscale_scenario(
        _key(1), scale_down_thresh=0.05),
    "pool_row_reactivates": lambda: jscn.autoscale_scenario(
        _key(0), n_pool=1, scale_down_thresh=0.05),
    "pool_invisible": lambda: _off(jscn.autoscale_scenario(_key(5))),
    "serving": lambda: jscn.serving_scenario(_key(0), n_requests=32),
    "serving_autoscaled": lambda: jscn.serving_scenario(
        _key(1), n_requests=32, n_pool=2, autoscale=True,
        scale_up_thresh=0.5, deadline_rel=30.0),
}


def _facts(name, res, out):
    """The reference tests' lifecycle facts, on the port's run: the static
    fleet never touches the pool, scale-down releases, and a single pool row
    cycles activate -> release -> re-activate."""
    ups = int(out["autoscale"]["n_scale_up"])
    downs = int(out["autoscale"]["n_scale_down"])
    if name.startswith("autoscale"):
        assert int(res.n_finished) == 48
        assert (ups > 0) == (name == "autoscale_on")
    if name == "autoscale_off":
        assert int(res.vm_placed.sum()) == 4
    if name == "scale_down":
        assert downs > 0
    if name == "pool_row_reactivates":
        assert ups >= 2 and downs >= 1 and int(res.vm_placed.sum()) == 5
    if name == "pool_invisible":
        assert res.vm_placed[:4].all() and not res.vm_placed[4:].any()
        counts = np.bincount(res.cl_vm.numpy(), minlength=8)
        assert (counts[:4] >= 6).all() and not counts[4:].any()


@pytest.mark.parametrize("name", sorted(PARITY))
def test_simulate_instrumented_matches_jax(name):
    jax_scn = PARITY[name]()
    jres, jout = _jax_instrumented(jax_scn)
    res, out = simulate_instrumented(scenario_from_arrays(jax_scn, "cpu"),
                                     device="cpu")
    assert_results_match(jres, res)
    assert_outputs_match(jout, out)
    _facts(name, res, out)


def test_scale_ticks_are_events():
    """K_SCALE clock stops appear in the log, one sensor interval apart or
    more, on the port's own constructor."""
    scn = scenarios.autoscale_scenario(torch.Generator().manual_seed(3),
                                       device="cpu")
    _, hist = simulate_history(scn, device="cpu")
    valid = hist.valid.numpy()
    kinds = hist.kind.numpy()[valid]
    assert (kinds == step.K_SCALE).any() and (kinds == step.K_COMPLETION).any()
    ts = hist.t.numpy()[valid][kinds == step.K_SCALE]
    assert (np.diff(ts) >= float(scn.policy.sensor_interval) - 1e-3).all()


def test_port_constructor_from_a_torch_seed():
    """One torch seed, autoscale on and off: the same workload, all work
    done both ways, the pool used only when on; the structure is the
    reference constructor's (the draw aside)."""
    def build(autoscale):
        return scenarios.autoscale_scenario(
            torch.Generator().manual_seed(0), autoscale=autoscale,
            device="cpu")

    on, off = build(True), build(False)
    assert all(torch.equal(a, b) for a, b in
               zip(on.cloudlets.leaves(), off.cloudlets.leaves()))
    res_on, out_on = simulate_instrumented(on, device="cpu")
    res_off, out_off = simulate_instrumented(off, device="cpu")
    assert int(res_on.n_finished) == int(res_off.n_finished) == 48
    assert int(out_on["autoscale"]["n_scale_up"]) > 0
    assert int(out_off["autoscale"]["n_scale_up"]) == 0
    ref = scenario_from_arrays(jscn.autoscale_scenario(_key(0)), "cpu")
    assert ref.max_steps == on.max_steps
    for part in ("hosts", "vms", "market", "policy"):
        for a, b in zip(getattr(ref, part).leaves(),
                        getattr(on, part).leaves()):
            assert a.dtype == b.dtype and torch.equal(a, b), part


def test_burst_threshold_seed_campaign_rows_are_solo_runs():
    """Burst rate x scale-up threshold x seed: two rows of the campaign
    bitwise their solo runs, autoscaler counts included."""
    rows = [scenarios.autoscale_scenario(
        torch.Generator().manual_seed(seed), burst_rate=rate,
        scale_up_thresh=up, max_steps=600, device="cpu")
        for rate in (0.05, 0.2) for up in (0.3, 0.9) for seed in (0, 1)]
    res, out = simulate_instrumented(stack_scenarios(rows), device="cpu")
    assert (res.n_finished == 48).all()
    for i in (0, 5):
        res_i, out_i = simulate_instrumented(rows[i], device="cpu")
        assert_bitwise(res.map(lambda x: x[i]), res_i)
        for k, v in out_i["autoscale"].items():
            assert torch.equal(out["autoscale"][k][i], v)


def test_serving_scenario_from_a_torch_seed():
    scn = scenarios.serving_scenario(torch.Generator().manual_seed(0),
                                     n_requests=32, device="cpu")
    res = simulate(scn, device="cpu")
    assert int(res.n_finished) == 32
    assert np.isfinite(float(res.ttft_p99)) and float(res.tpot_p50) > 0

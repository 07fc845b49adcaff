"""Runtime (live) VM migration in the port against the JAX package's, on the
CPU (DESIGN.md §8): consolidation, load balancing with progress kept, the
improvement rule that rules out ping-pong, and the Table 1 knob.

Each scenario is built by the JAX package, carried across with
``convert.scenario_from_arrays`` and run by both engines (the reference as
``jax.jit(simulate_instrumented)`` with the plain ``sweep_impl="jnp"``
sweep).  Integer fields, ``n_events`` and the coordinator's move counts
match exactly, floats within rtol 1e-5.  These scenarios draw nothing, so
the port's constructors must build the reference's arrays exactly; within
the port a threshold campaign's rows are bitwise their solo runs.
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
    broadcast_campaign, scenarios, simulate, simulate_instrumented,
    stack_scenarios)
from test_torch_engine import (
    assert_bitwise, assert_outputs_match, assert_results_match)
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

_jax_instrumented = jax.jit(jax_simulate_instrumented)


def _policy(scn, **flags):
    return scn.replace(policy=scn.policy.replace(
        **{k: jnp.asarray(v) for k, v in flags.items()}))


def _one_worker():
    """A lone busy VM: moving it cannot shrink the spread, so the
    improvement rule vetoes every move (no ping-pong)."""
    scn = jscn.balance_scenario(balance_thresh=0.5, bg_mi=1.0)
    return scn.replace(cloudlets=scn.cloudlets.replace(
        exists=jnp.asarray(np.array([True, True, False]))))


PARITY = {
    "consolidation": lambda: jscn.consolidation_scenario(),
    "consolidation_off": lambda: _policy(jscn.consolidation_scenario(),
                                         live_migration=False),
    "consolidation_without_federation": lambda: _policy(
        jscn.consolidation_scenario(), federation=False),
    "balance": lambda: jscn.balance_scenario(),
    "balance_off": lambda: _policy(jscn.balance_scenario(),
                                   live_migration=False),
    "no_ping_pong": _one_worker,
    "table1_live": lambda: jscn.table1_scenario(
        True, live_migration=True, migrate_balance_thresh=0.8,
        migrate_consolidate_thresh=0.2),
    "table1_knob_off": lambda: _policy(
        jscn.table1_scenario(True, live_migration=True),
        live_migration=False),
}


def _facts(name, res, out):
    """The reference tests' facts, on the port's run."""
    n_mig, moves = int(res.n_migrations), out["migration"]
    if name == "consolidation":
        assert n_mig == 4 and int(moves["n_consolidate"]) == 4
        assert (res.vm_dc == 0).all()
    if name in ("consolidation_off", "consolidation_without_federation",
                "no_ping_pong"):
        assert n_mig == 0
    if name == "balance":
        assert n_mig == 1 and int(moves["n_balance"]) == 1
        transfer = 30.0 + 1024.0 / 100.0
        np.testing.assert_allclose(res.finish_t[1:].numpy(),
                                   [1050.0 + transfer, 1050.0], atol=1.0)
    if name == "table1_knob_off":
        assert n_mig == 10 and int(res.n_finished) == 25


@pytest.mark.parametrize("name", sorted(PARITY))
def test_simulate_instrumented_matches_jax(name):
    jax_scn = PARITY[name]()
    jres, jout = _jax_instrumented(jax_scn)
    res, out = simulate_instrumented(scenario_from_arrays(jax_scn, "cpu"),
                                     device="cpu")
    assert_results_match(jres, res)
    assert_outputs_match(jout, out)
    _facts(name, res, out)


@pytest.mark.parametrize("family", ["consolidation", "balance", "table1"])
def test_port_constructors_match_jax_constructors(family):
    pairs = {
        "consolidation": (jscn.consolidation_scenario(),
                          scenarios.consolidation_scenario(device="cpu")),
        "balance": (jscn.balance_scenario(balance_thresh=0.7),
                    scenarios.balance_scenario(balance_thresh=0.7,
                                               device="cpu")),
        "table1": (jscn.table1_scenario(True, live_migration=True),
                   scenarios.table1_scenario(True, live_migration=True,
                                             device="cpu")),
    }
    jax_scn, port = pairs[family]
    carried = scenario_from_arrays(jax_scn, "cpu")
    assert carried.max_steps == port.max_steps
    assert [type(i) for i in carried.instruments] == [
        type(i) for i in port.instruments]
    for a, b in zip(carried.leaves(), port.leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_migration_anchors_from_the_port_constructors():
    """Consolidation saves energy at the same end time; balancing halves
    the makespan of the static control."""
    on = simulate(scenarios.consolidation_scenario(device="cpu"), device="cpu")
    off = simulate(scenarios.consolidation_scenario(
        live_migration=False, device="cpu"), device="cpu")
    assert float(on.end_t) == float(off.end_t)
    assert float(on.energy_j.sum()) < 0.5 * float(off.energy_j.sum())
    assert float(on.bw_cost[0]) > float(off.bw_cost[0])
    bal = simulate(scenarios.balance_scenario(device="cpu"), device="cpu")
    ctrl = simulate(scenarios.balance_scenario(live_migration=False,
                                               device="cpu"), device="cpu")
    assert float(bal.makespan) < 0.6 * float(ctrl.makespan)


def test_threshold_campaign_rows_are_solo_runs():
    """A consolidate x balance threshold grid through broadcast_campaign:
    every row bitwise its solo run; threshold 0 disables consolidation,
    positive ones drain the spare DC."""
    template = scenarios.consolidation_scenario(device="cpu")
    grid = [(c, b) for c in (0.0, 0.3, 0.9) for b in (1e9, 0.5)]
    rows = [template.replace(policy=template.policy.replace(
        migrate_consolidate_thresh=torch.tensor(c),
        migrate_balance_thresh=torch.tensor(b))) for c, b in grid]
    batch = broadcast_campaign(template, len(rows),
                               policy=stack_scenarios(rows).policy)
    res, out = simulate_instrumented(batch, device="cpu")
    for i, scn in enumerate(rows):
        res_i, out_i = simulate_instrumented(scn, device="cpu")
        assert_bitwise(res.map(lambda x: x[i]), res_i)
        for k, v in out_i["migration"].items():
            assert torch.equal(out["migration"][k][i], v)
    n_mig = res.n_migrations.numpy()
    assert (n_mig[:2] == 0).all() and (n_mig[2:] == 4).all()

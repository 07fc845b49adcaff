"""Host failures, checkpoint rollback, SLA accounting and proactive
evacuation of the port against the JAX package's, on the CPU (DESIGN.md §9).

Scenarios are built by the JAX package (outage schedules drawn with
``jax.random``), carried across with ``convert.scenario_from_arrays`` and run
by both engines, the reference as ``jax.jit(simulate)`` with the plain
``sweep_impl="jnp"`` sweep.  Integer fields and ``n_events`` match exactly,
floats within rtol 1e-5.  Within the port: the port's constructors build
the reference's arrays (the drawn schedule aside), the MTBF = INF control is
bitwise the scenario without outages, and an MTBF x policy campaign's rows
are bitwise their solo runs.

The drawn cases run cloudlets of 123,457 MI, off the 50 s sensor-tick grid.
With the default 100,000 MI a completion falls on a tick to the last bit of
float32, and XLA's CPU backend contracts the sweep's ``rem - rate * dt``
into one fused multiply-add where the port (and its CUDA kernel) rounds
twice: then the reference may finish a cloudlet at 99.99999 s, one event
before the tick at 100 s, where the port finishes it in the tick's event
(``PRNGKey(19)`` at MTBF 150 s with evacuation: 31 events against 29, every
finish time within rtol 1e-5).  Off the grid no two events tie, and event
counts are comparable exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import INF
from repro.core import scenarios as jscn
from repro.core import simulate as jax_simulate
from repro.core import workload as jworkload
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import (
    broadcast_campaign, scenarios, simulate, stack_scenarios, workload)
from test_torch_engine import assert_bitwise, assert_results_match
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

_jax_simulate = jax.jit(jax_simulate)


def _one_host_outage(ckpt=INF, fail_at=100.0, repair_after=400.0,
                     task_mi=300_000.0, federation=False, n_dc=1,
                     deadline=3.0e38, horizon=50_000.0):
    """The reference tests' one 1-core host (+ an empty peer DC), one VM,
    one cloudlet, and one outage."""
    hosts = jscn.uniform_hosts(n_dc, 1, cores=1, mips=1000.0, ram_mb=1024.0,
                               storage_mb=2_000_000.0)
    vms = jscn.uniform_vms(1, dc=0, ram_mb=512.0, storage_mb=1024.0,
                           image_mb=1024.0)
    cls = jscn.make_cloudlets(np.array([0]), np.array([task_mi]), np.zeros(1),
                              input_mb=0.0, output_mb=0.0, deadline=deadline)
    out = jworkload.no_outages(n_dc, 1, 1)
    out = out.replace(fail_t=out.fail_t.at[0, 0, 0].set(fail_at),
                      repair_t=out.repair_t.at[0, 0, 0].set(
                          fail_at + repair_after))
    pol = jscn.make_policy(core_reserving=True, federation=federation,
                           ckpt_interval=ckpt, migration_fixed_s=30.0,
                           interdc_bw_mbps=100.0, horizon=horizon)
    return jscn.Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                         market=jscn.uniform_market(n_dc), policy=pol,
                         outages=out, max_steps=200)


def _terminal_vs_evicted():
    """A creation rejected outright stays failed across a repair; a
    failure-evicted VM comes back."""
    hosts = jscn.uniform_hosts(1, 1, cores=1, mips=1000.0, ram_mb=1024.0,
                               storage_mb=2_000_000.0)
    vms = jscn.uniform_vms(2, dc=0, ram_mb=512.0, storage_mb=1024.0,
                           request_t=np.array([0.0, 50.0]))
    cls = jscn.make_cloudlets(np.array([0, 1]), np.array([100_000.0] * 2),
                              np.zeros(2), input_mb=0.0, output_mb=0.0)
    out = jworkload.no_outages(1, 1, 1)
    out = out.replace(fail_t=out.fail_t.at[0, 0, 0].set(10.0),
                      repair_t=out.repair_t.at[0, 0, 0].set(100.0))
    return jscn.Scenario(
        hosts=hosts, vms=vms, cloudlets=cls, market=jscn.uniform_market(1),
        policy=jscn.make_policy(core_reserving=True, ckpt_interval=INF,
                                horizon=50_000.0),
        outages=out, max_steps=200)


def _no_federation(scn):
    return scn.replace(policy=scn.policy.replace(federation=jnp.asarray(False)))


OFF_GRID_MI = 123_457.0


def _key(i):
    return jax.random.PRNGKey(17 + i)


PARITY = {
    "restart_from_zero": lambda: _one_host_outage(ckpt=INF),
    "checkpoint_rollback": lambda: _one_host_outage(ckpt=30_000.0),
    "requeue_prefers_federation_peer": lambda: _one_host_outage(
        federation=True, n_dc=2),
    "sla_hit": lambda: _one_host_outage(deadline=900.0),
    "sla_miss": lambda: _one_host_outage(deadline=700.0),
    "sla_never_finished": lambda: _one_host_outage(
        deadline=700.0, repair_after=1e9, horizon=2000.0),
    "vm_failed_terminal": _terminal_vs_evicted,
    "evacuation": lambda: jscn.evacuation_scenario(),
    "restart_control": lambda: jscn.evacuation_scenario(
        evacuation=False, ckpt_interval=INF),
    "evacuation_without_federation": lambda: _no_federation(
        jscn.evacuation_scenario(ckpt_interval=INF)),
    "mtbf_inf": lambda: jscn.reliability_scenario(None),
    **{f"drawn_{i}": (lambda i=i: jscn.reliability_scenario(
        _key(i), mtbf_s=150.0, mttr_s=150.0, task_mi=OFF_GRID_MI))
       for i in range(3)},
    **{f"drawn_evacuating_{i}": (lambda i=i: jscn.reliability_scenario(
        _key(i), mtbf_s=150.0, mttr_s=150.0, evacuation=True,
        ckpt_interval=25_000.0, task_mi=OFF_GRID_MI)) for i in range(3)},
    "drawn_default": lambda: jscn.reliability_scenario(
        _key(0), task_mi=OFF_GRID_MI),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_simulate_matches_jax(name):
    jax_scn = PARITY[name]()
    res = simulate(scenario_from_arrays(jax_scn, "cpu"), device="cpu")
    assert_results_match(_jax_simulate(jax_scn), res)


def test_failure_semantics_anchors():
    """The reference tests' arithmetic, on the port: restart from zero,
    checkpoint rollback, re-queue on a peer, SLA violations, and the
    terminal-vs-evicted contract."""
    def run(name):
        return simulate(scenario_from_arrays(PARITY[name](), "cpu"),
                        device="cpu")

    res = run("restart_from_zero")
    assert float(res.finish_t[0]) == pytest.approx(800.0, abs=0.5)
    assert float(res.downtime) == pytest.approx(400.0, abs=0.5)
    assert not bool(res.vm_failed[0])
    # kept floor(100k / 30k) * 30k = 90k MI: resumes at 500 with 210k left
    assert float(run("checkpoint_rollback").finish_t[0]) == pytest.approx(
        710.0, abs=0.5)
    res = run("requeue_prefers_federation_peer")
    transfer = 30.0 + 1024.0 / 100.0
    assert float(res.downtime) == pytest.approx(transfer, abs=0.5)
    assert int(res.vm_dc[0]) == 1 and int(res.n_migrations) == 1
    assert int(run("sla_hit").sla_violations) == 0
    assert int(run("sla_miss").sla_violations) == 1
    res = run("sla_never_finished")
    assert int(res.n_finished) == 0 and int(res.sla_violations) == 1
    res = run("vm_failed_terminal")
    assert res.vm_failed.tolist() == [False, True]
    assert float(res.finish_t[0]) < 1e30 <= float(res.finish_t[1])


def test_evacuation_anchors_from_the_port_constructors():
    evac = simulate(scenarios.evacuation_scenario(device="cpu"), device="cpu")
    ctrl = simulate(scenarios.evacuation_scenario(
        evacuation=False, ckpt_interval=INF, device="cpu"), device="cpu")
    assert int(evac.n_finished) == int(ctrl.n_finished) == 2
    assert int(evac.n_evacuations) == 2 and int(evac.sla_violations) == 0
    assert int(ctrl.n_evacuations) == 0 and int(ctrl.sla_violations) == 2
    assert float(evac.downtime) == 0.0 < float(ctrl.downtime)
    np.testing.assert_allclose(evac.finish_t.numpy(), 640.24, atol=0.5)
    np.testing.assert_allclose(ctrl.finish_t.numpy(), 940.24, atol=0.5)
    ratio = float(evac.energy_j.sum()) / float(ctrl.energy_j.sum())
    assert 0.1 < ratio < 10.0


@pytest.mark.parametrize("family", ["evacuation", "reliability"])
def test_port_constructors_match_jax_constructors(family):
    """The port's constructors give the reference's arrays; a drawn outage
    schedule aside, so the reliability control (no draw) is compared."""
    if family == "evacuation":
        jax_scn = jscn.evacuation_scenario(evacuation=False)
        port = scenarios.evacuation_scenario(evacuation=False, device="cpu")
    else:
        jax_scn = jscn.reliability_scenario(None, n_outages=3)
        port = scenarios.reliability_scenario(None, n_outages=3, device="cpu")
    carried = scenario_from_arrays(jax_scn, "cpu")
    assert carried.max_steps == port.max_steps
    assert [i.name for i in carried.instruments] == ["reliability"]
    assert type(port.instruments[0]) is type(carried.instruments[0])
    for a, b in zip(carried.leaves(), port.leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_mtbf_inf_is_the_scenario_without_outages():
    """An all-INF schedule is bitwise the scenario with no outages at all."""
    scn = scenarios.reliability_scenario(None, device="cpu")
    ctrl = simulate(scn, device="cpu")
    assert_bitwise(ctrl, simulate(scn.replace(outages=None, instruments=()),
                                  device="cpu"))
    assert int(ctrl.n_evacuations) == 0 and float(ctrl.downtime) == 0.0
    gen = torch.Generator().manual_seed(3)
    never = scenarios.reliability_scenario(gen, mtbf_s=INF, device="cpu")
    assert_bitwise(simulate(never, device="cpu"), ctrl)


def test_mtbf_policy_campaign_rows_are_solo_runs():
    """MTBF x (evacuation, ckpt) grid: every row bitwise its solo run,
    failures bite in the short-MTBF rows, and the INF rows are clean."""
    template = scenarios.reliability_scenario(None, device="cpu")
    mtbfs = [150.0, 150.0, 900.0, 900.0, INF, INF]
    rows = []
    for i, m in enumerate(mtbfs):
        gen = torch.Generator().manual_seed(100 + i)
        out = workload.host_outages(gen, 2, 3, 2, m, 300.0, device="cpu")
        pol = template.policy.replace(
            evacuation=torch.tensor(i % 2 == 0),
            ckpt_interval=torch.tensor(25_000.0 if i % 2 == 0 else INF))
        rows.append(template.replace(outages=out, policy=pol))
    batch = stack_scenarios(rows)
    res = simulate(batch, device="cpu")
    for i, scn in enumerate(rows):
        assert_bitwise(res.map(lambda x: x[i]), simulate(scn, device="cpu"))
    assert float(res.downtime[:2].sum()) + int(res.n_evacuations[:2].sum()) > 0
    assert int(res.n_evacuations[4]) == 0 and float(res.downtime[4]) == 0.0
    # broadcast_campaign stacks the same outage and policy subtrees
    swept = broadcast_campaign(template, len(rows), outages=batch.outages,
                               policy=batch.policy)
    assert_bitwise(simulate(swept, device="cpu"), res)

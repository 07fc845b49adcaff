"""The contention-aware network layer of the port (inter-DC topology, the
transfer ledger, DESIGN.md §13) against the JAX package's, on the CPU.

Each family of the reference's ``tests/test_network.py``, the topology
cases of ``tests/test_energy.py`` and the neutral-topology lock of
``tests/test_invariants.py``: the scenario is built by the JAX package,
carried across with ``convert.scenario_from_arrays`` and run by both
engines (the reference as ``jax.jit(repro.core.simulate)`` with the plain
sweep).  Integer fields and ``n_events`` match exactly, float fields within
rtol 1e-5; the hand-computed numbers of the reference's tests hold in the
port too.  Within the port a campaign row is bitwise its solo run, and a
neutral topology is bitwise the flat run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SPACE_SHARED, TIME_SHARED
from repro.core import energy as jenergy
from repro.core import scenarios as jscn
from repro.core import simulate as jax_simulate
from repro.core import simulate_history as jax_simulate_history
from repro.core.energy import PowerModel as JaxPowerModel
from repro.core.energy import Topology as JaxTopology
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import (
    Topology, energy, scenarios, simulate, simulate_history, simulate_trace,
    stack_scenarios, step)
from test_torch_engine import assert_bitwise, assert_results_match
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

INF = 3.0e38
_jax_simulate = jax.jit(jax_simulate)
_jax_history = jax.jit(jax_simulate_history)


def _both(jax_scn):
    """(reference result, port result, port scenario)."""
    scn = scenario_from_arrays(jax_scn, "cpu")
    res = simulate(scn, device="cpu")
    jres = _jax_simulate(jax_scn)
    assert_results_match(jres, res)
    return jres, res, scn


def _overflow(topo, n_overflow=1, image_mb=1024.0, length_mi=500.0,
              mips=100.0, core_reserving=True):
    """The reference's overflow case: DC0 has one slot, ``n_overflow``
    more VMs must federate out, one cloudlet each."""
    n_dc = topo.latency_s.shape[0]
    n_vms = 1 + n_overflow
    hosts = jscn.uniform_hosts(n_dc, n_overflow, cores=1, mips=mips,
                               ram_mb=4096.0)
    ex = np.ones((n_dc, n_overflow), bool)
    ex[0, 1:] = False
    hosts = hosts.replace(exists=jnp.asarray(ex))
    vms = jscn.uniform_vms(n_vms, dc=0, cores=1, mips=mips, ram_mb=256.0,
                           image_mb=image_mb)
    cls = jscn.make_cloudlets(
        np.arange(n_vms), np.full(n_vms, length_mi), np.zeros(n_vms),
        input_mb=0.0, output_mb=0.0)
    pol = jscn.make_policy(federation=True, core_reserving=core_reserving,
                           horizon=1e6)
    return jscn.Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                         market=jscn.uniform_market(n_dc), policy=pol,
                         topology=topo)


def _staging(k, input_mb=1000.0, bw=100.0, lat=0.0, submit=None,
             length_mi=100.0, mips=100.0):
    """k fixed-binding cloudlets staging ``input_mb`` from DC1 to their own
    VM in DC0: every transfer shares the (1, 0) link."""
    hosts = jscn.uniform_hosts(2, k, cores=1, mips=mips, ram_mb=4096.0)
    vms = jscn.uniform_vms(k, dc=0, cores=1, mips=mips, ram_mb=256.0)
    sub = np.zeros(k) if submit is None else np.asarray(submit, np.float64)
    cls = jscn.make_cloudlets(
        np.arange(k), np.full(k, length_mi), sub, input_mb=input_mb,
        output_mb=0.0, input_dc=1)
    pol = jscn.make_policy(horizon=1e6, interdc_bw_mbps=bw)
    return jscn.Scenario(
        hosts=hosts, vms=vms, cloudlets=cls, market=jscn.uniform_market(2),
        policy=pol, topology=JaxTopology.uniform(2, latency_s=lat,
                                                 bw_mbps=bw))


def _disconnected(n_dc, reachable):
    lat = np.full((n_dc, n_dc), np.inf, np.float32)
    np.fill_diagonal(lat, 0.0)
    for a, b in reachable:
        lat[a, b] = lat[b, a] = 0.05
    return JaxTopology(latency_s=jnp.asarray(lat),
                       bw_mbps=jnp.full((n_dc, n_dc), 100.0, jnp.float32))


# --- disconnected peers -----------------------------------------------------

def test_disconnected_peer_does_not_poison_selection():
    """DC0 full, DC1 reachable, DC2 behind an INF-latency link: the
    overflow VM lands on DC1 (INF/INF would have made the peer key NaN)."""
    _, r, _ = _both(_overflow(_disconnected(3, [(0, 1)])))
    assert not bool(r.vm_failed[1]) and int(r.vm_dc[1]) == 1
    assert int(r.n_migrations) == 1 and int(r.n_finished) == 2


def test_disconnected_peer_is_last_resort():
    """With no reachable peer the disconnected one still takes the VM,
    whose image never arrives."""
    _, r, _ = _both(_overflow(_disconnected(2, [])))
    assert not bool(r.vm_failed[1]) and int(r.vm_dc[1]) == 1
    assert float(r.finish_t[1]) >= INF / 2


# --- the delay matrix ---------------------------------------------------------

def test_migration_delay_matrix_matches_jax():
    """The port's matrix equals the reference's, fixed term included, and
    an explicit policy overrides the scenario's."""
    jax_scn = _overflow(JaxTopology.uniform(3, latency_s=2.0, bw_mbps=50.0))
    scn = scenario_from_arrays(jax_scn, "cpu")
    m = energy.migration_delay_matrix(scn, 1024.0)
    want = np.asarray(jenergy.migration_delay_matrix(jax_scn, 1024.0))
    np.testing.assert_allclose(m.numpy(), want, rtol=1e-6)
    fixed = float(scn.policy.migration_fixed_s)
    assert float(m.min()) >= fixed
    pol2 = scn.policy.replace(migration_fixed_s=torch.tensor(7.5))
    m2 = energy.migration_delay_matrix(scn, 1024.0, policy=pol2)
    np.testing.assert_allclose(m2.numpy(), want - fixed + 7.5, rtol=1e-6)
    # batch-major: a [B, D, D] matrix, one row per campaign row
    mb = energy.migration_delay_matrix(stack_scenarios([scn, scn]),
                                       torch.tensor([1024.0, 1024.0]))
    assert torch.equal(mb[1], m)


def test_migration_delay_matrix_agrees_with_engine():
    """An uncontended federation migration is usable exactly when the
    matrix says: finish = matrix[origin, dst] + length / mips."""
    jax_scn = _overflow(JaxTopology.uniform(2, latency_s=3.0, bw_mbps=40.0))
    _, r, scn = _both(jax_scn)
    assert int(r.n_migrations) == 1
    delay = float(energy.migration_delay_matrix(
        scn, scn.vms.image_mb[1])[0, 1])
    np.testing.assert_allclose(float(r.finish_t[1]), delay + 5.0, rtol=1e-5)


# --- fair sharing -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_k_concurrent_stagings_share_the_link(k):
    """k stage-ins opened together on one link each take k times the lone
    byte time, all priced in one recompute (bitwise-equal starts)."""
    _, r, _ = _both(_staging(k, input_mb=1000.0, bw=100.0, lat=0.5))
    start = r.start_t.numpy()
    np.testing.assert_allclose(start, np.full(k, 0.5 + k * 10.0), rtol=1e-6)
    assert (start == start[0]).all() and int(r.n_finished) == k


def test_concurrent_migrations_fair_share():
    """k federation migrations committed in one provisioning pass settle
    to fixed + latency + k * image / bw each."""
    k = 3
    jax_scn = _overflow(JaxTopology.uniform(2, latency_s=1.0, bw_mbps=50.0),
                        n_overflow=k)
    _, r, scn = _both(jax_scn)
    assert int(r.n_migrations) == k
    want = float(scn.policy.migration_fixed_s) + 1.0 + k * 1024.0 / 50.0 + 5.0
    np.testing.assert_allclose(r.finish_t[1:].numpy(), np.full(k, want),
                               rtol=1e-5)


def test_staggered_join_hand_computed():
    """A opens at 0, B joins at 2 and both get bw / 2: A finishes at 18, B
    gets the link back and finishes at 20 (lat 0, bw 100, 1000 MB)."""
    _, r, _ = _both(_staging(2, submit=[0.0, 2.0]))
    np.testing.assert_allclose(r.start_t.numpy(), [18.0, 20.0], rtol=1e-6)


def test_flat_path_bills_interdc_divisor():
    """Without a topology a remote input bills the flat ``interdc_bw_mbps``
    divisor, blind to concurrency; a local one the VM's bandwidth."""
    jax_scn = dataclasses.replace(_staging(3, bw=50.0), topology=None)
    _, r, _ = _both(jax_scn)
    np.testing.assert_allclose(r.start_t.numpy(), np.full(3, 20.0), rtol=1e-6)
    local = dataclasses.replace(jax_scn, cloudlets=jax_scn.cloudlets.replace(
        input_dc=jnp.zeros_like(jax_scn.cloudlets.input_dc)))
    _, r2, _ = _both(local)
    np.testing.assert_allclose(r2.start_t.numpy(), np.full(3, 10.0),
                               rtol=1e-6)


# --- drivers ------------------------------------------------------------------

def test_drivers_bitwise_with_staging_firing():
    """``simulate``, ``simulate_trace`` and ``simulate_history`` of a
    staging run are bitwise one another, and equal the reference's."""
    _, res, scn = _both(jscn.staging_scenario(n_cloudlets=24))
    assert int(res.n_finished) == 24
    ts = torch.arange(0.0, 300.0, 17.0)
    res_t, prog = simulate_trace(scn, ts, device="cpu")
    assert_bitwise(res, res_t)
    assert (np.diff(prog.numpy(), axis=0) >= -1e-5).all()
    assert_bitwise(res, simulate_history(scn, device="cpu")[0])


def test_stage_event_wakes_loop_for_prebound_rows():
    """A fixed-binding row submitted later has no dispatch to open its
    transfer: the K_STAGE clock stop wakes the loop at its submit time,
    on the reference's events."""
    jax_scn = _staging(2, submit=[0.0, 2.0])
    jres, jhist = _jax_history(jax_scn)
    res, hist = simulate_history(scenario_from_arrays(jax_scn, "cpu"),
                                 device="cpu")
    assert_results_match(jres, res)
    np.testing.assert_array_equal(hist.kind.numpy(), np.asarray(jhist.kind))
    valid = hist.valid.numpy()
    kinds, t = hist.kind.numpy()[valid], hist.t.numpy()[valid]
    assert (kinds == step.K_STAGE).sum() == 1
    np.testing.assert_allclose(t[kinds == step.K_STAGE], [2.0])


@pytest.mark.parametrize("locality,want_vm", [(False, 0), (True, 1)])
def test_locality_dispatch_prefers_data_gravity(locality, want_vm):
    """Slow inter-DC links, fast intra-DC ones: under locality dispatch the
    VM beside the input wins over the least-loaded rank."""
    hosts = jscn.uniform_hosts(2, 1, cores=1, mips=100.0, ram_mb=4096.0)
    vms = jscn.uniform_vms(2, dc=np.array([0, 1]), cores=1, mips=100.0,
                           ram_mb=256.0)
    cls = jscn.make_cloudlets(np.array([-1]), np.array([100.0]),
                              np.array([0.0]), input_mb=1000.0,
                              output_mb=0.0, input_dc=1)
    bw = np.full((2, 2), 10.0, np.float32)
    np.fill_diagonal(bw, 1000.0)
    topo = JaxTopology(latency_s=jnp.zeros((2, 2), jnp.float32),
                       bw_mbps=jnp.asarray(bw))
    jax_scn = jscn.Scenario(
        hosts=hosts, vms=vms, cloudlets=cls, market=jscn.uniform_market(2),
        policy=jscn.make_policy(horizon=1e6, locality_dispatch=locality),
        topology=topo)
    _, r, _ = _both(jax_scn)
    assert int(r.cl_vm[0]) == want_vm and int(r.n_finished) == 1


def _random_staging(seed):
    """A random staging scenario, its sizes and rates drawn off the tick
    grid (no completion ties a clock stop to the last float32 bit, where
    XLA's fused multiply-add and the port's two roundings may coalesce
    events differently)."""
    rng = np.random.default_rng(seed)
    return jscn.staging_scenario(
        n_dc=int(rng.integers(2, 5)), hosts_per_dc=2,
        vms_per_dc=int(rng.integers(1, 4)),
        n_cloudlets=int(rng.integers(12, 40)), wave=int(rng.integers(3, 9)),
        wave_dt=float(rng.uniform(0.3, 7.0)),
        input_mb=float(rng.uniform(50.0, 900.0)),
        task_mi=float(rng.uniform(3_000.0, 40_000.0)) + 0.123,
        bw_mbps=float(rng.uniform(40.0, 400.0)),
        latency_s=float(rng.uniform(0.0, 0.3)),
        locality_dispatch=bool(seed % 2))


@pytest.mark.parametrize("seed", range(4))
def test_random_staging_matches_jax(seed):
    _both(_random_staging(seed))


def test_staging_campaign_rows_are_solo_runs():
    """Locality on and off, several link rates in one campaign: every row
    bitwise its solo run; the transfer phase applies per row, so a row
    that needs nothing is left as its solo run leaves it."""
    rows = [scenarios.staging_scenario(
        n_cloudlets=24, wave_dt=dt, bw_mbps=bw, locality_dispatch=loc,
        device="cpu")
        for dt, bw, loc in ((2.0, 100.0, False), (0.7, 50.0, True),
                            (5.0, 400.0, True))]
    rows.append(scenarios.staging_scenario(n_cloudlets=24, wave_dt=1e5,
                                           device="cpu"))
    batch = simulate(stack_scenarios(rows), device="cpu")
    for i, scn in enumerate(rows):
        assert_bitwise(batch.map(lambda x: x[i]), simulate(scn, device="cpu"))


def test_staging_constructor_matches_jax():
    """The port's ``staging_scenario`` gives the reference's arrays."""
    kw = dict(n_dc=4, n_cloudlets=20, wave=5, wave_dt=1.5, bw_mbps=80.0,
              latency_s=0.1, locality_dispatch=True)
    carried = scenario_from_arrays(jscn.staging_scenario(**kw), "cpu")
    port = scenarios.staging_scenario(**kw, device="cpu")
    assert carried.max_steps == port.max_steps
    for a, b in zip(carried.leaves(), port.leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --- tests/test_energy.py's topology cases -------------------------------------

def _with_models(lat=5.0, bw=50.0):
    return jscn.table1_scenario(True).replace(
        power=JaxPowerModel.uniform(3),
        topology=JaxTopology.uniform(3, latency_s=lat, bw_mbps=bw))


def test_topology_migration_delay():
    """A slower, farther federation delays the migrated VMs' work."""
    _, fast, _ = _both(_with_models(lat=1.0, bw=1000.0))
    _, slow, _ = _both(_with_models(lat=300.0, bw=5.0))
    assert int(fast.n_migrations) == int(slow.n_migrations) == 10
    assert float(slow.mean_turnaround) > float(fast.mean_turnaround) + 50


def test_energy_bounded_by_power_envelope():
    _, res, scn = _both(_with_models())
    n_hosts = int(scn.hosts.exists.sum())
    total = float(res.energy_j.sum())
    assert n_hosts * 93.0 * float(res.end_t) * 0.99 <= total
    assert total <= n_hosts * 135.0 * float(res.end_t) * 1.01


def test_locality_aware_coordinator():
    """With one near and one far peer, overflow prefers the near one."""
    lat = np.array([[0.0, 1.0, 500.0], [1.0, 0.0, 500.0],
                    [500.0, 500.0, 0.0]], np.float32)
    topo = JaxTopology(latency_s=jnp.asarray(lat),
                       bw_mbps=jnp.full((3, 3), 100.0, jnp.float32))
    _, res, _ = _both(jscn.table1_scenario(True).replace(topology=topo))
    counts = np.bincount(res.vm_dc.numpy()[res.vm_placed.numpy()],
                         minlength=3)
    assert counts[1] >= counts[2] and int(res.n_migrations) == 10


def test_from_coordinates_matches_jax():
    """Latency from coordinates, computed on the host as the reference
    computes it, and a Table 1 run over it."""
    coords = np.array([[0.0, 0.0], [1800.0, 0.0], [0.0, 3600.0]])
    topo = Topology.from_coordinates(coords, device="cpu")
    jtopo = JaxTopology.from_coordinates(coords)
    assert torch.equal(topo.latency_s,
                       torch.from_numpy(np.array(jtopo.latency_s)))
    assert float(topo.latency_s[0, 0]) == 0.0
    np.testing.assert_allclose(float(topo.latency_s[0, 1]), 0.01, rtol=1e-5)
    _both(jscn.table1_scenario(True).replace(topology=jtopo))


def test_uniform_matches_jax():
    topo = Topology.uniform(4, latency_s=0.07, bw_mbps=123.0, device="cpu")
    jtopo = JaxTopology.uniform(4, latency_s=0.07, bw_mbps=123.0)
    for a, b in ((topo.latency_s, jtopo.latency_s),
                 (topo.bw_mbps, jtopo.bw_mbps)):
        assert torch.equal(a, torch.from_numpy(np.array(b)))


# --- the neutral-topology lock (tests/test_invariants.py) ---------------------

NEUTRAL = {
    "fig4_ss": lambda: jscn.fig4_scenario(SPACE_SHARED, SPACE_SHARED),
    "fig4_tt": lambda: jscn.fig4_scenario(TIME_SHARED, TIME_SHARED),
    "fig7_8": lambda: jscn.fig7_8_scenario(16),
    "generated": lambda: jscn.generated_scenario(
        jax.random.PRNGKey(0), kind="poisson", n_cloudlets=16, n_vms=4,
        n_hosts=4, rate=0.2, median_mi=10_000.0),
    "single_overflow": lambda: jscn.table1_scenario(True, n_vms=8),
    "balance": lambda: jscn.balance_scenario(),
}


@pytest.mark.parametrize("name", sorted(NEUTRAL))
def test_neutral_topology_is_bitwise_flat(name):
    """A uniform topology with ``bw == interdc_bw_mbps`` and zero latency
    gives a result bitwise the flat run's, through ``simulate``,
    ``simulate_trace`` and a campaign, and the reference's with it."""
    jax_scn = NEUTRAL[name]()
    jtopo = JaxTopology.uniform(
        jax_scn.hosts.n_dc, latency_s=0.0,
        bw_mbps=float(jax_scn.policy.interdc_bw_mbps))
    flat = simulate(scenario_from_arrays(jax_scn, "cpu"), device="cpu")
    _, res, scn = _both(jax_scn.replace(topology=jtopo))
    assert_bitwise(flat, res)
    ts = torch.arange(0.0, 3000.0, 401.0)
    assert_bitwise(flat, simulate_trace(scn, ts, device="cpu")[0])
    batch = simulate(stack_scenarios([scn, scn]), device="cpu")
    assert_bitwise(flat, batch.map(lambda x: x[1]))


def _stale_share(in1, req_t=38.84362):
    """Two stage-ins share link (1, 0) and close together, leaving the
    row's ``link_share`` at half the link; a VM requested at ``req_t``
    then overflows from DC1 to DC0 over the same link.  ``in1`` sizes the
    second stage-in: a huge one keeps a transfer in flight."""
    hosts = jscn.uniform_hosts(2, 3, cores=1, mips=100.0, ram_mb=4096.0)
    ex = np.ones((2, 3), bool)
    ex[1, 1:] = False
    hosts = hosts.replace(exists=jnp.asarray(ex))
    vms = jscn.uniform_vms(4, dc=np.array([0, 0, 1, 1]), cores=1, mips=100.0,
                           ram_mb=256.0, image_mb=768.8624,
                           request_t=np.array([0.0, 0.0, 0.0, req_t]))
    cls = jscn.make_cloudlets(
        np.arange(4), np.array([100.0, 100.0, 1e6, 777.0]), np.zeros(4),
        input_mb=np.array([1000.0, in1, 0.0, 0.0]), output_mb=0.0,
        input_dc=np.array([1, 1, -1, -1]))
    pol = jscn.make_policy(federation=True, core_reserving=True, horizon=1e6,
                           migration_fixed_s=8.363694)
    return jscn.Scenario(
        hosts=hosts, vms=vms, cloudlets=cls, market=jscn.uniform_market(2),
        policy=pol, topology=JaxTopology.uniform(2, latency_s=0.4503394,
                                                 bw_mbps=242.9708))


def test_transfer_phase_applies_per_row():
    """A row that needs no transfer phase keeps its stale ``link_share``
    in a campaign as it does alone, so the later migration on that link is
    re-timed as in its solo run.  (The reference's batch step runs the
    phase on every row once any row needs it: its row 0 of this campaign
    finishes cloudlet 3 at 58.592075 s against 58.592079 s alone.)"""
    solo_j = _stale_share(1000.0)
    jres, res, scn = _both(solo_j)
    busy = scenario_from_arrays(_stale_share(1e7), "cpu")
    batch = simulate(stack_scenarios([scn, busy]), device="cpu")
    assert_bitwise(batch.map(lambda x: x[0]), res)
    np.testing.assert_array_equal(res.finish_t.numpy(),
                                  np.asarray(jres.finish_t))

"""``simulate_trace`` and extra instruments of the port against the JAX
package's, on the CPU.

Each scenario of the reference's ``tests/test_trace_equivalence.py`` is built
by the JAX package, carried across with ``convert.scenario_from_arrays`` and
traced by both engines (the reference jitted once per module, with the plain
``sweep_impl="jnp"`` sweep).  Integer fields and ``n_events`` match exactly;
float fields and the progress matrix within rtol 1e-5.  Within the port the
trace is a pure observer: a traced run's ``SimResult`` is bitwise the
untraced run's and the history run's, and a traced campaign's rows are
bitwise their solo traces.
"""
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SPACE_SHARED, TIME_SHARED
from repro.core import Instrument as JaxInstrument
from repro.core import UtilizationTimelineInstrument as JaxUtilization
from repro.core import scenarios as jscn
from repro.core import simulate_history as jax_simulate_history
from repro.core import simulate_instrumented as jax_simulate_instrumented
from repro.core import simulate_trace as jax_simulate_trace
from repro.core.energy import PowerModel as JaxPowerModel
from repro.core.energy import Topology as JaxTopology
from repro.core.pytree import pytree_dataclass
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import (
    TensorTree, engine, simulate, simulate_history, simulate_instrumented,
    simulate_trace, stack_scenarios, step)
from test_torch_engine import (
    assert_bitwise, assert_outputs_match, assert_results_match)
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

_jax_trace = jax.jit(jax_simulate_trace)
_jax_history = jax.jit(jax_simulate_history)
_jax_instrumented = jax.jit(jax_simulate_instrumented)


def _randomized(seed):
    """The reference's randomized trace case: a random one-DC workload."""
    rng = np.random.default_rng(seed)
    n_vms = int(rng.integers(1, 5))
    n_cl = n_vms + int(rng.integers(0, 6))
    hosts = jscn.uniform_hosts(
        1, int(rng.integers(1, 4)), cores=int(rng.integers(1, 3)),
        mips=float(rng.uniform(10, 200)), ram_mb=4096.0)
    vms = jscn.uniform_vms(
        n_vms, cores=1, mips=float(rng.uniform(10, 200)), ram_mb=256.0)
    cl_vm = np.concatenate(
        [np.arange(n_vms), rng.integers(0, n_vms, n_cl - n_vms)])
    cls = jscn.make_cloudlets(
        cl_vm, rng.uniform(100, 5000, n_cl), rng.uniform(0, 50, n_cl))
    scn = jscn.Scenario(
        hosts=hosts, vms=vms, cloudlets=cls, market=jscn.uniform_market(1),
        policy=jscn.make_policy(host_policy=int(rng.integers(0, 2)),
                                vm_policy=int(rng.integers(0, 2)),
                                horizon=1e6))
    return scn, np.sort(rng.uniform(0, 1000, 7)).astype(np.float32)


def _grid(stop, step_s):
    return np.arange(0.0, stop, step_s, dtype=np.float32)


TRACED = {
    **{f"fig4_{h}{v}": (lambda h=h, v=v: (jscn.fig4_scenario(h, v),
                                          _grid(2000.0, 123.0)))
       for h in (SPACE_SHARED, TIME_SHARED) for v in (SPACE_SHARED, TIME_SHARED)},
    **{f"fig9_10_{v}": (lambda v=v: (jscn.fig9_10_scenario(
        v, n_hosts=60, n_vms=6, n_groups=3), _grid(4000.0, 250.0)))
       for v in (SPACE_SHARED, TIME_SHARED)},
    "federated_energy": lambda: (jscn.table1_scenario(True).replace(
        power=JaxPowerModel.uniform(3),
        topology=JaxTopology.uniform(3, latency_s=5.0, bw_mbps=50.0)),
        _grid(9000.0, 500.0)),
    "live_migration": lambda: (jscn.consolidation_scenario(),
                               _grid(2500.0, 111.0)),
    "evacuation": lambda: (jscn.evacuation_scenario(), _grid(1200.0, 77.0)),
    "restart_control": lambda: (jscn.evacuation_scenario(
        evacuation=False, ckpt_interval=3.0e38), _grid(1200.0, 77.0)),
    **{f"randomized_{s}": (lambda s=s: _randomized(s)) for s in range(4)},
}


@pytest.mark.parametrize("name", sorted(TRACED))
def test_trace_matches_jax(name):
    jax_scn, ts = TRACED[name]()
    jres, jprog = _jax_trace(jax_scn, jnp.asarray(ts))
    scn = scenario_from_arrays(jax_scn, "cpu")
    res, prog = simulate_trace(scn, torch.from_numpy(ts), device="cpu")
    assert_results_match(jres, res)
    assert prog.shape == (len(ts), scn.cloudlets.n_cloudlets)
    np.testing.assert_allclose(prog.numpy(), np.asarray(jprog), rtol=1e-5,
                               atol=0)
    # a pure observer: bitwise the untraced run and the history run
    assert_bitwise(res, simulate(scn, device="cpu"))
    assert_bitwise(res, simulate_history(scn, device="cpu")[0])


@pytest.mark.parametrize("name", ["evacuation", "live_migration"])
def test_history_with_extensions_matches_jax(name):
    """The per-event log of an extension scenario: failure edges and live
    moves land on the same events as the reference's."""
    jax_scn, _ = TRACED[name]()
    jres, jhist = _jax_history(jax_scn)
    res, hist = simulate_history(scenario_from_arrays(jax_scn, "cpu"),
                                 device="cpu")
    assert_results_match(jres, res)
    np.testing.assert_array_equal(hist.kind.numpy(), np.asarray(jhist.kind))
    np.testing.assert_array_equal(hist.valid.numpy(), np.asarray(jhist.valid))
    if name == "evacuation":
        kinds = hist.kind.numpy()[hist.valid.numpy()]
        assert (kinds == step.K_FAILURE).sum() == 1


def test_trace_progress_shows_rollback_and_preservation():
    """Stop-and-copy keeps progress monotone; restart from zero drops it."""
    for name, monotone in (("evacuation", True), ("restart_control", False)):
        jax_scn, ts = TRACED[name]()
        _, prog = simulate_trace(scenario_from_arrays(jax_scn, "cpu"), ts,
                                 device="cpu")
        dprog = np.diff(prog.numpy(), axis=0)
        assert (dprog >= -1e-5).all() if monotone else dprog.min() < -0.1


def test_utilization_timeline_matches_jax():
    ts = _grid(2000.0, 100.0)
    jax_scn = jscn.fig4_scenario(SPACE_SHARED, SPACE_SHARED).replace(
        instruments=(JaxUtilization(sample_ts=jnp.asarray(ts)),))
    jres, jout = _jax_instrumented(jax_scn)
    scn = scenario_from_arrays(jax_scn, "cpu")
    res, out = simulate_instrumented(scn, device="cpu")
    assert_results_match(jres, res)
    assert_outputs_match(jout, out)
    util = out["utilization"]["utilization"].numpy()
    assert np.allclose(util[ts < 1600.0, 0], 1.0, atol=1e-6)
    assert np.allclose(util[ts > 1600.0, 0], 0.0, atol=1e-6)
    assert_bitwise(res, simulate(scn.replace(instruments=()), device="cpu"))


def test_traced_campaign_rows_are_solo_traces():
    """A traced campaign: every row's result and progress bitwise its solo
    trace, and the results bitwise the untraced campaign's."""
    rows = [scenario_from_arrays(TRACED[n]()[0], "cpu")
            for n in ("fig4_00", "fig4_01", "fig4_10", "fig4_11")]
    ts = _grid(2000.0, 123.0)
    batch = stack_scenarios(rows)
    res, prog = simulate_trace(batch, ts, device="cpu")
    assert prog.shape == (4, len(ts), 8)
    assert_bitwise(res, simulate(batch, device="cpu"))
    for i, scn in enumerate(rows):
        res_i, prog_i = simulate_trace(scn, ts, device="cpu")
        assert_bitwise(res.map(lambda x: x[i]), res_i)
        assert torch.equal(prog[i], prog_i)


def test_duplicate_instrument_names_raise():
    ts = torch.arange(4.0)
    scn = scenario_from_arrays(jscn.fig4_scenario(0, 0), "cpu").replace(
        instruments=(step.UtilizationTimelineInstrument(sample_ts=ts),))
    with pytest.raises(ValueError, match="duplicate instrument name"):
        simulate_instrumented(
            scn, (step.UtilizationTimelineInstrument(sample_ts=ts * 2),),
            device="cpu")


@pytree_dataclass
class _JaxClockStop(JaxInstrument):
    name = "clock_stop"
    stop_every: jax.Array

    def bound(self, scn, st, aux):
        return (jnp.floor(st.t / self.stop_every) + 1) * self.stop_every

    def extra_steps(self, scn):
        return 64


@dataclass(frozen=True)
class _ClockStop(TensorTree, step.Instrument):
    name = "clock_stop"
    stop_every: torch.Tensor

    def bound(self, scn, st, aux):
        return (torch.floor(st.t / self.stop_every) + 1) * self.stop_every

    def extra_steps(self, scn):
        return 64


def test_instrument_bound_is_a_clock_stop():
    """An instrument's bound splits intervals: more events, of kind
    K_INSTRUMENT, at the same times as the reference's, with the same
    physics and accrual."""
    jax_scn = jscn.fig4_scenario(SPACE_SHARED, SPACE_SHARED)
    jax_stop = jax_scn.replace(instruments=(
        _JaxClockStop(stop_every=jnp.asarray(150.0, jnp.float32)),))
    scn = scenario_from_arrays(jax_scn, "cpu")
    stop = scn.replace(instruments=(_ClockStop(stop_every=torch.tensor(150.0)),))
    jres, jhist = _jax_history(jax_stop)
    res, hist = simulate_history(stop, device="cpu")
    assert_results_match(jres, res)
    np.testing.assert_array_equal(hist.kind.numpy(), np.asarray(jhist.kind))
    np.testing.assert_allclose(hist.t.numpy(), np.asarray(jhist.t), rtol=1e-6)
    assert (hist.kind.numpy() == step.K_INSTRUMENT).sum() > 0
    plain = simulate(scn, device="cpu")
    assert int(res.n_events) > int(plain.n_events)
    np.testing.assert_allclose(res.finish_t.numpy(), plain.finish_t.numpy(),
                               rtol=1e-5)
    assert step.resolve_max_steps(stop, (stop.instruments[0],)) == (
        step.default_max_steps(stop) + 64)
    # an instrument the port has no class for does not carry across
    with pytest.raises(NotImplementedError, match="clock_stop"):
        scenario_from_arrays(jax_stop, "cpu")


def test_entry_points():
    assert engine.entry_points() == {
        "simulate": simulate, "simulate_trace": simulate_trace,
        "simulate_history": simulate_history}

"""The port's seeded workload generators (``core/workload.py``) and the
scenarios built on them, on the CPU.

Torch cannot reproduce ``jax.random``'s bits, so the generators are held to
what they promise: the same ``torch.Generator`` seed gives the same arrays
and different seeds different ones, rows are valid, and the arrival
processes have their moments over many seeds (not one draw).  Parity with
the reference runs JAX-drawn workloads of every generated kind through both
engines (``convert.scenario_from_arrays``; the reference jitted once per
module with the plain ``sweep_impl="jnp"`` sweep): integer fields and
``n_events`` exactly, floats within rtol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import scenarios as jscn
from repro.core import simulate as jax_simulate
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import INF, scenarios, simulate, stack_scenarios
from repro_torch.core import workload
from test_torch_engine import assert_bitwise, assert_results_match
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

KINDS = ("poisson", "diurnal", "bursty")

_jax_simulate = jax.jit(jax_simulate)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cloudlets(seed, kind, n=48, **kw):
    return workload.generate_cloudlets(_gen(seed), n, kind=kind, rate=0.1,
                                       n_bursts=4, device="cpu", **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_same_seed_same_arrays_other_seed_other_arrays(kind):
    a, b, c = (_cloudlets(s, kind, io_mb=0.5) for s in (3, 3, 4))
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)
    assert not torch.allclose(a.submit_t, c.submit_t)
    assert not torch.allclose(a.length_mi, c.length_mi)
    srv = [workload.generate_serving_requests(_gen(s), 32, kind=kind,
                                              device="cpu") for s in (3, 3, 4)]
    for x, y in zip(srv[0].leaves(), srv[1].leaves()):
        assert torch.equal(x, y)
    assert not torch.equal(srv[0].prompt_tokens, srv[2].prompt_tokens)


@pytest.mark.parametrize("kind", KINDS)
def test_generated_rows_valid(kind):
    cls = _cloudlets(5, kind, io_mb=0.5, deadline_rel=100.0)
    sub = cls.submit_t.numpy()
    assert (np.diff(sub) >= 0).all() and (sub >= 0).all()
    assert np.isfinite(sub).all()
    assert (cls.length_mi > 0).all() and (cls.input_mb > 0).all()
    assert (cls.output_mb > 0).all() and cls.exists.all()
    np.testing.assert_allclose(cls.deadline.numpy(), sub + 100.0, rtol=1e-6)
    assert (cls.vm == -1).all()
    assert set(_cloudlets(5, kind, n_vms=4).vm.tolist()) <= {0, 1, 2, 3}
    srv = workload.generate_serving_requests(_gen(5), 64, kind=kind,
                                             max_new_cap=80.0, device="cpu")
    assert (srv.prompt_tokens >= 1).all() and (srv.max_new_tokens >= 1).all()
    assert (srv.max_new_tokens <= 80).all()
    assert torch.equal(srv.prompt_tokens, torch.ceil(srv.prompt_tokens))
    assert (np.diff(srv.submit_t.numpy()) >= 0).all()


def test_poisson_mean_rate_over_seeds():
    """n arrivals at rate r span n / r on average: over 64 seeds the mean
    span is within 3% (the standard error is 1.1%)."""
    spans = [float(workload.poisson_arrivals(_gen(s), 128, 0.5)[-1])
             for s in range(64)]
    assert abs(np.mean(spans) / (128 / 0.5) - 1.0) < 0.03


def test_diurnal_modulation_over_seeds():
    """Arrivals cluster where the sinusoid is high: pooled over seeds and
    over whole periods, the half period where sin > 0 holds (1 + 2 amp / pi)
    / (1 - 2 amp / pi) = 3.7x the other half's arrivals at amp 0.9."""
    period, peak, trough = 200.0, 0, 0
    for s in range(16):
        t = workload.diurnal_arrivals(_gen(s), 512, 1.0, amp=0.9,
                                      period=period).numpy()
        t = t[t < (t[-1] // period) * period]   # whole periods only
        phase = (t % period) / period
        peak += ((phase > 0.0) & (phase < 0.5)).sum()
        trough += ((phase > 0.5) & (phase < 1.0)).sum()
    assert 3.0 < peak / trough < 4.5


def test_bursty_off_gaps_dominate_within_burst_gaps():
    """Over many seeds the gaps between bursts (mean 500 s) dwarf the gaps
    inside a burst (mean 1 s): the median off-gap is more than 50 times the
    median in-burst gap, and both means are near their parameters."""
    off, within = [], []
    for s in range(32):
        t = workload.bursty_arrivals(_gen(s), 4, 16, 1.0, 500.0).numpy()
        gaps = np.diff(t).reshape(-1)
        starts = np.arange(16, 64, 16) - 1      # the gap before each burst
        off.extend(gaps[starts])
        within.extend(np.delete(gaps, starts))
    assert np.median(off) > 50 * np.median(within)
    assert 350.0 < np.mean(off) < 650.0 and 0.85 < np.mean(within) < 1.15


def test_host_outages_sorted_disjoint_and_padding():
    a = workload.host_outages(_gen(17), 2, 3, 4, 500.0, 200.0, device="cpu")
    b = workload.host_outages(_gen(17), 2, 3, 4, 500.0, 200.0, device="cpu")
    assert torch.equal(a.fail_t, b.fail_t) and torch.equal(a.repair_t,
                                                           b.repair_t)
    fail, repair = a.fail_t.numpy(), a.repair_t.numpy()
    assert (repair > fail).all()
    assert (fail[..., 1:] >= repair[..., :-1]).all()
    never = workload.host_outages(_gen(17), 2, 2, 3, INF, 200.0, device="cpu")
    assert (never.fail_t >= INF).all() and (never.repair_t >= INF).all()
    assert not never.down_at(1e30).any()
    # the same draws scaled by MTBF: a later first failure
    firsts = [float(workload.host_outages(_gen(1), 1, 2, 2, m, 50.0,
                                          device="cpu").fail_t[0, 0, 0])
              for m in (100.0, 1000.0)]
    assert firsts[0] < firsts[1]
    # down_at / next_*_after agree with the windows
    t = float(fail[0, 0, 0]) + 1e-3
    assert bool(a.down_at(t)[0, 0])
    assert float(a.next_repair_after(t)[0, 0]) == float(repair[0, 0, 0])


@pytest.mark.parametrize("kind", KINDS)
def test_generated_scenario_matches_jax(kind):
    """JAX-drawn workloads of each kind through both engines."""
    for seed in range(2):
        jax_scn = jscn.generated_scenario(
            jax.random.PRNGKey(seed), kind=kind, n_cloudlets=32, n_vms=4,
            n_hosts=4, rate=0.2, n_bursts=4, median_mi=10_000.0)
        res = simulate(scenario_from_arrays(jax_scn, "cpu"), device="cpu")
        assert_results_match(_jax_simulate(jax_scn), res)


@pytest.mark.parametrize("kind", KINDS)
def test_generated_scenario_from_a_torch_seed(kind):
    """The port's constructor: the reference's fleet and policy, a valid
    workload that runs to the end, and a seed campaign whose rows are
    bitwise their solo runs."""
    rows = [scenarios.generated_scenario(
        _gen(s), kind=kind, n_cloudlets=24, n_vms=4, n_hosts=4, rate=0.2,
        n_bursts=3, median_mi=20_000.0, device="cpu") for s in range(3)]
    ref = scenario_from_arrays(jscn.generated_scenario(
        jax.random.PRNGKey(0), kind=kind, n_cloudlets=24, n_vms=4, n_hosts=4,
        rate=0.2, n_bursts=3, median_mi=20_000.0), "cpu")
    assert ref.max_steps == rows[0].max_steps
    for part in ("hosts", "vms", "market", "policy"):
        for a, b in zip(getattr(ref, part).leaves(),
                        getattr(rows[0], part).leaves()):
            assert a.dtype == b.dtype and torch.equal(a, b), part
    res = simulate(stack_scenarios(rows), device="cpu")
    assert (res.n_finished == 24).all()
    assert_bitwise(res.map(lambda x: x[1]), simulate(rows[1], device="cpu"))

"""The port's chunked ``run_campaign`` on the CPU.

Chunking must be invisible in the results: every chunk size, a ragged
trailing chunk (padded by repeating the last row, then trimmed) and a chunk
larger than the campaign give a result bitwise the unchunked run's, whose
rows match the reference's ``jax.jit(repro.core.simulate)`` of the same
stacked campaign (integers exactly, floats within rtol 1e-5).  The
reference's own chunked runner is not called: it donates buffers, and its
tests fail in parallel runs (ROADMAP Queue C).
"""
import jax
import pytest
import torch

from repro.core import scenarios as jscn
from repro.core import simulate as jax_simulate
from repro.core import stack_scenarios as jax_stack
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import (
    SumReducer, run_campaign, scenarios, simulate, stack_scenarios)
from repro_torch.core.campaign import _chunk
from test_torch_engine import assert_bitwise, assert_results_match
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

N = 11


def _fig4_rows():
    """Policy pairs x a workload scale: ``N`` rows, none alike."""
    base = [jscn.fig4_scenario(h, v) for h in (0, 1) for v in (0, 1)]
    return [s.replace(cloudlets=s.cloudlets.replace(
        length_mi=s.cloudlets.length_mi * (1.0 + 0.05 * i)))
        for i, s in enumerate((base * N)[:N])]


@pytest.fixture(scope="module")
def fig4():
    rows = _fig4_rows()
    batched = stack_scenarios([scenario_from_arrays(r, "cpu") for r in rows])
    whole = simulate(batched, device="cpu")
    assert_results_match(jax.jit(jax_simulate)(jax_stack(rows)), whole)
    return batched, whole


@pytest.mark.parametrize("chunk", [1, 3, 4, 11, 32])
def test_chunked_matches_unchunked(fig4, chunk):
    """Divides, ragged, whole and larger than the campaign."""
    batched, whole = fig4
    assert_bitwise(run_campaign(batched, chunk_size=chunk, device="cpu"),
                   whole)


def test_unchunked_is_simulate(fig4):
    batched, whole = fig4
    assert_bitwise(run_campaign(batched, device="cpu"), whole)


def test_padded_tail_repeats_the_last_row(fig4):
    """The trailing chunk's padding rows are copies of the last row, and
    trimmed: a streamed count over 3-row chunks sees each row once."""
    batched, whole = fig4
    tail = _chunk(batched, 9, 3)
    assert tail.policy.horizon.shape[0] == 3
    for a, b in zip(tail.map(lambda x: x[2]).leaves(),
                    batched.map(lambda x: x[-1]).leaves()):
        assert torch.equal(a, b)
    out = run_campaign(batched, chunk_size=3, device="cpu",
                       reduce=SumReducer("n_events"))
    assert int(out) == int(whole.n_events.sum())


def test_topology_campaign_chunked_matches_jax():
    """A staging campaign (topology, locality on and off) chunked with a
    ragged tail: rows bitwise the unchunked run, each row matching the
    reference's run of that scenario."""
    rows = [jscn.staging_scenario(n_cloudlets=16, wave_dt=dt,
                                  locality_dispatch=loc)
            for dt, loc in ((2.0, False), (0.5, True), (9.0, True))]
    batched = stack_scenarios([scenario_from_arrays(r, "cpu") for r in rows])
    whole = simulate(batched, device="cpu")
    for i, r in enumerate(rows):
        assert_results_match(jax.jit(jax_simulate)(r),
                             whole.map(lambda x: x[i]))
    assert_bitwise(run_campaign(batched, chunk_size=2, device="cpu"), whole)


@pytest.mark.parametrize("chunk", [0, -3])
def test_bad_chunk_sizes_raise(fig4, chunk):
    batched, _ = fig4
    with pytest.raises(ValueError, match="chunk_size"):
        run_campaign(batched, chunk_size=chunk, device="cpu")


def test_bad_reduce_raises(fig4):
    batched, _ = fig4
    with pytest.raises(TypeError, match="CampaignReducer"):
        run_campaign(batched, reduce="n_events", device="cpu")
    with pytest.raises(TypeError, match="reduce\\['x'\\]"):
        run_campaign(batched, reduce={"x": 3}, device="cpu")


def test_stack_scenarios_refuses_mixed_topology():
    """A topology on every row or on none, as the reference asks."""
    a = scenarios.staging_scenario(n_cloudlets=8, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        stack_scenarios([a, a.replace(topology=None)])
    b = stack_scenarios([a, a])
    assert b.topology.bw_mbps.shape == (2, 3, 3)


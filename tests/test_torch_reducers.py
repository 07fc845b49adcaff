"""The port's campaign reducers against the JAX package's, on the CPU.

The reference's result comes from ``jax.jit(repro.core.simulate)`` of the
whole stacked campaign, and each reference reducer's ``init``, ``fold`` and
``finalize`` are applied to it directly, in one fold (its chunked runner
donates buffers and its tests fail in parallel runs, ROADMAP Queue C).  The
port's reducers run through ``run_campaign(reduce=...)`` on the same
campaign.  Integer folds, ``ArgBestReducer`` and ``ValuesReducer`` match
exactly; float sums and means within rtol 1e-5, standard deviations within
the reference's own rtol 1e-3 (a difference of two sums of squares).
Within the port, integer folds, ``ArgBest`` and ``Values`` are bitwise the
same for every chunk size.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reducers as jred
from repro.core import scenarios as jscn
from repro.core import simulate as jax_simulate
from repro.core import stack_scenarios as jax_stack
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import reducers as pred
from repro_torch.core import run_campaign, stack_scenarios
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

N = 24
_jax_simulate = jax.jit(jax_simulate)


def _reducers(mod):
    """The same reducer dict from either package's ``reducers`` module."""
    return {
        "events": mod.SumReducer("n_events"),
        "cost": mod.SumReducer("total_cost"),
        "mt": mod.MeanReducer("mean_turnaround"),
        "hist": mod.HistogramReducer("makespan", 0.0, 8000.0, bins=16),
        "best": mod.ArgBestReducer("mean_turnaround"),
        "worst": mod.ArgBestReducer("total_cost", mode="max"),
        "vals": mod.ValuesReducer("mean_turnaround", n_slots=N),
    }


def _jax_fold(reducer, batched, res, n):
    """One reference fold over the whole result."""
    def run(batched, res):
        carry = reducer.init(batched, res)
        carry = reducer.fold(carry, batched, res,
                             jnp.arange(n, dtype=jnp.int32),
                             jnp.ones(n, bool))
        return reducer.finalize(carry)
    return jax.jit(run)(batched, res)


def _match(want, got, key=""):
    """A reference summary against the port's: dicts and policy rows by
    field, integers and booleans exactly, floats within rtol 1e-5 (1e-3
    for a standard deviation)."""
    if isinstance(want, dict):
        assert set(want) == set(got), key
        for k in want:
            _match(want[k], got[k], f"{key}.{k}")
        return
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _match(getattr(want, f.name), getattr(got, f.name),
                   f"{key}.{f.name}")
        return
    w, g = np.asarray(want), got.cpu().numpy()
    assert g.shape == w.shape, key
    if w.dtype.kind in "biu":
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    else:
        rtol = 1e-3 if key.endswith("std") else 1e-5
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=key)


def _fig4_rows():
    """Policy pairs x workload scale; every eighth row's horizon ends
    before anything finishes (its makespan is -INF)."""
    base = [jscn.fig4_scenario(h, v) for h in (0, 1) for v in (0, 1)]
    rows = []
    for i, s in enumerate((base * N)[:N]):
        s = s.replace(cloudlets=s.cloudlets.replace(
            length_mi=s.cloudlets.length_mi * (1.0 + 0.02 * (i % 7))))
        if i % 8 == 7:
            s = s.replace(policy=s.policy.replace(
                horizon=jnp.asarray(300.0, jnp.float32)))
        rows.append(s)
    return rows


@pytest.fixture(scope="module")
def grid():
    rows = _fig4_rows()
    jbatch = jax_stack(rows)
    jres = _jax_simulate(jbatch)
    batched = stack_scenarios([scenario_from_arrays(r, "cpu") for r in rows])
    return jbatch, jres, batched


@pytest.mark.parametrize("name", sorted(_reducers(pred)))
def test_reducer_matches_jax(grid, name):
    jbatch, jres, batched = grid
    want = _jax_fold(_reducers(jred)[name], jbatch, jres, N)
    got = run_campaign(batched, reduce=_reducers(pred)[name], device="cpu")
    _match(want, got, name)


def _leaves(x) -> list:
    """The tensors of a summary, dicts and policy rows flattened."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if dataclasses.is_dataclass(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [x]


@pytest.mark.parametrize("chunk", [5, 8, 13])
def test_chunk_size_invariance(grid, chunk):
    """Integer folds, ArgBest and Values bitwise across chunkings (a
    ragged tail included); float sums and means within rtol 1e-5."""
    _, _, batched = grid
    whole = run_campaign(batched, reduce=_reducers(pred), device="cpu")
    part = run_campaign(batched, chunk_size=chunk, reduce=_reducers(pred),
                        device="cpu")
    for name in ("events", "hist", "best", "worst", "vals"):
        for a, b in zip(_leaves(whole[name]), _leaves(part[name])):
            assert torch.equal(a, b), name
    for a, b in zip(_leaves(whole["mt"]) + [whole["cost"]],
                    _leaves(part["mt"]) + [part["cost"]]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5)


def test_histogram_bins_of_inf_and_nan():
    """+INF goes to the last bin, -INF and NaN to bin 0, as XLA's
    saturating cast puts them (torch's own cast would give -2**31 for all
    three, which the clip would send to bin 0)."""
    v = np.array([np.inf, -np.inf, np.nan, 5.0, 1e10, -3.0, 7999.9, 8000.0,
                  499.99, 500.0], np.float32)
    n = v.shape[0]
    jr = jred.HistogramReducer("makespan", 0.0, 8000.0, bins=16)
    want = jax.jit(lambda c, x: jr.fold(
        c, None, SimpleNamespace(makespan=x), jnp.arange(n),
        jnp.ones(n, bool)))(jnp.zeros(16, jnp.int32), jnp.asarray(v))
    got = pred.HistogramReducer("makespan", 0.0, 8000.0, bins=16).fold(
        torch.zeros(16, dtype=torch.int32), None,
        SimpleNamespace(makespan=torch.from_numpy(v)),
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bins = pred._bins(torch.from_numpy(v[:3]), 0.0, 8000.0, 16)
    assert bins.tolist() == [15, 0, 0]


def test_latency_histogram_matches_jax():
    """Per-request TTFT and TPOT of a serving campaign pooled into one
    histogram each."""
    rows = [jscn.serving_scenario(jax.random.PRNGKey(s), n_requests=12,
                                  n_replicas=2) for s in range(3)]
    jbatch = jax_stack(rows)
    jres = _jax_simulate(jbatch)
    batched = stack_scenarios([scenario_from_arrays(r, "cpu") for r in rows])
    for metric, hi in (("ttft", 200.0), ("tpot", 2.0)):
        want = _jax_fold(jred.LatencyHistogramReducer(metric, 0.0, hi,
                                                      bins=32),
                         jbatch, jres, 3)
        got = run_campaign(batched, chunk_size=2, device="cpu",
                           reduce=pred.LatencyHistogramReducer(
                               metric, 0.0, hi, bins=32))
        _match(want, got, metric)
        assert int(got["counts"].sum()) > 0


def test_single_reducer_form(grid):
    _, jres, batched = grid
    out = run_campaign(batched, reduce=pred.SumReducer("n_finished"),
                       device="cpu")
    assert out.dtype == torch.int32
    assert int(out) == int(np.asarray(jres.n_finished).sum())


def test_reducer_validation(grid):
    _, _, batched = grid
    with pytest.raises(ValueError, match="unknown SimResult field"):
        run_campaign(batched, reduce=pred.SumReducer("not_a_field"),
                     device="cpu")
    with pytest.raises(ValueError, match="one scalar per scenario row"):
        run_campaign(batched, reduce=pred.SumReducer(lambda r: r.turnaround),
                     device="cpu")
    with pytest.raises(TypeError, match="field name or callable"):
        run_campaign(batched, reduce=pred.SumReducer(3), device="cpu")
    with pytest.raises(ValueError, match="empty histogram range"):
        pred.HistogramReducer("makespan", 1.0, 1.0)
    with pytest.raises(ValueError, match="bins"):
        pred.HistogramReducer("makespan", 0.0, 1.0, bins=0)
    with pytest.raises(ValueError, match="mode"):
        pred.ArgBestReducer("makespan", mode="best")
    with pytest.raises(ValueError, match="ttft"):
        pred.LatencyHistogramReducer("makespan", 0.0, 1.0)

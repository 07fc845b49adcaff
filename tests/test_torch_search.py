"""The port's policy search against the JAX package's, on the CPU.

``jax.random`` and ``torch.Generator`` draw different candidate tables, so
the reference's drawn table comes across through numpy: ``build_campaign``
is held against the reference's on the same table, and ``random_search`` /
``successive_halving`` run with the port's ``search.sample_params``
patched to hand out that table.  The reference side is scored by
``jax.jit(repro.core.simulate)`` of the whole campaign (its streamed runner
donates buffers, ROADMAP Queue C), with its rung loop written out here.
Scores match within rtol 1e-5, and the winners, ranks and survivors
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as jscn
from repro.core import search as jsearch
from repro.core import simulate as jax_simulate
from repro_torch.convert import scenario_from_arrays
from repro_torch.core import run_campaign, search
from test_torch_engine import assert_bitwise
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

SPACE = {"host_policy": [0, 1], "vm_policy": [0, 1],
         "migration_fixed_s": [10.0, 30.0]}
_jax_simulate = jax.jit(jax_simulate)


def _template():
    return jscn.fig4_scenario(0, 0)


def _to_torch(params: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def test_grid_params_matches_jax():
    space = {"a": [1.0, 2.0], "b": [10, 20, 30], "c": [True, False]}
    want = jsearch.grid_params(space)
    got = search.grid_params(space)
    assert list(got) == list(want)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="empty"):
        search.grid_params({})


def test_sample_params_support_and_determinism():
    space = {"x": [1.0, 2.0, 4.0], "y": [0, 1]}
    a = search.sample_params(torch.Generator().manual_seed(3), space, 64)
    b = search.sample_params(torch.Generator().manual_seed(3), space, 64)
    assert set(a["x"].tolist()) <= {1.0, 2.0, 4.0}
    assert set(a["y"].tolist()) == {0, 1}
    assert a["x"].dtype == torch.float32 and a["y"].dtype == torch.int32
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    with pytest.raises(ValueError, match="empty"):
        search.sample_params(torch.Generator(), {}, 4)


def test_build_campaign_matches_jax():
    """Policy knobs replace the template's; the rest broadcast."""
    params = jsearch.sample_params(jax.random.PRNGKey(0), SPACE, 6)
    want = scenario_from_arrays(
        jsearch.build_campaign(_template(), params), "cpu")
    got = search.build_campaign(scenario_from_arrays(_template(), "cpu"),
                                _to_torch(params))
    for a, b in zip(want.leaves(), got.leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_build_campaign_extras_need_instantiate():
    """A knob that is no ``Policy`` field goes to ``instantiate``: here a
    per-row cloudlet length scale, which doubles fig4's turnaround."""
    port_t = scenario_from_arrays(_template(), "cpu")
    scale = np.array([1.0, 2.0], np.float32)
    with pytest.raises(ValueError, match="instantiate"):
        search.build_campaign(port_t, {"length_scale": torch.from_numpy(scale)})

    def jax_inst(t, extras, n, key):
        cls = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape),
                           t.cloudlets)
        return {"cloudlets": cls.replace(
            length_mi=cls.length_mi * extras["length_scale"][:, None])}

    def port_inst(t, extras, n, gen):
        cls = t.cloudlets.map(lambda x: x.expand((n,) + tuple(x.shape)))
        return {"cloudlets": cls.replace(
            length_mi=cls.length_mi * extras["length_scale"][:, None])}

    want = jsearch.build_campaign(
        _template(), {"length_scale": jnp.asarray(scale)},
        instantiate=jax_inst)
    got = search.build_campaign(
        port_t, {"length_scale": torch.from_numpy(scale)},
        instantiate=port_inst)
    res = run_campaign(got, device="cpu")
    np.testing.assert_allclose(res.mean_turnaround[1].item(),
                               2 * res.mean_turnaround[0].item(), rtol=1e-6)
    assert_bitwise(res, run_campaign(scenario_from_arrays(want, "cpu"),
                                     device="cpu"))


def _patched(monkeypatch, table):
    """The port's ``sample_params`` hands out the reference's table."""
    monkeypatch.setattr(search, "sample_params",
                        lambda gen, space, n: _to_torch(table))


def test_random_search_matches_jax(monkeypatch):
    table = jsearch.sample_params(jax.random.PRNGKey(0), SPACE, 16)
    want = np.asarray(_jax_simulate(
        jsearch.build_campaign(_template(), table)).mean_turnaround)
    _patched(monkeypatch, table)
    out = search.random_search(
        scenario_from_arrays(_template(), "cpu"), SPACE,
        generator=torch.Generator().manual_seed(0), n=16,
        metric="mean_turnaround", chunk_size=6, device="cpu")
    np.testing.assert_allclose(out["values"].numpy(), want, rtol=1e-5)
    assert out["best_index"] == int(np.argmin(want))
    assert float(out["best_value"]) == out["values"].min().item()
    # fig4: space / space dominates
    assert int(out["best_params"]["host_policy"]) == 0
    assert int(out["best_params"]["vm_policy"]) == 0


def _jax_halving(table, n0, fidelities, eta, metric, sign):
    """The reference's rung loop over whole-campaign reference runs."""
    alive = np.arange(n0)
    rungs = []
    for fid in fidelities:
        cand = {k: v[alive] for k, v in table.items()}
        cand["horizon"] = jnp.full((alive.shape[0],), fid, jnp.float32)
        res = _jax_simulate(jsearch.build_campaign(_template(), cand))
        values = np.asarray(getattr(res, metric))
        rungs.append((alive, values))
        order = np.argsort(sign * values, kind="stable")
        alive = alive[order[:max(alive.shape[0] // eta, 1)]]
    return rungs, int(alive[0])


@pytest.mark.parametrize("mode", ["min", "max"])
def test_successive_halving_matches_jax(monkeypatch, mode):
    """Each rung's candidates and scores, and the winner, as the
    reference's rung loop gives them on the same table; the chunk size
    stays fixed while the population halves."""
    n0, fidelities = 8, (700.0, 1300.0, 4000.0)
    table = jsearch.sample_params(jax.random.PRNGKey(1), SPACE, n0)
    sign = 1.0 if mode == "min" else -1.0
    rungs, best = _jax_halving(table, n0, fidelities, 2, "total_cost", sign)
    _patched(monkeypatch, table)
    out = search.successive_halving(
        scenario_from_arrays(_template(), "cpu"), SPACE,
        generator=torch.Generator().manual_seed(1), n0=n0,
        fidelities=fidelities, eta=2, metric="total_cost", mode=mode,
        chunk_size=3, device="cpu")
    assert [r["fidelity"] for r in out["rungs"]] == list(fidelities)
    for (alive, values), rung in zip(rungs, out["rungs"]):
        np.testing.assert_array_equal(rung["candidates"].numpy(), alive)
        np.testing.assert_allclose(rung["values"].numpy(), values, rtol=1e-5)
    assert out["best_index"] == best
    for k, v in out["best_params"].items():
        assert v.item() == np.asarray(table[k])[best].item(), k


def test_successive_halving_validation():
    port_t = scenario_from_arrays(_template(), "cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="not a Policy field"):
        search.successive_halving(port_t, {"host_policy": [0, 1]},
                                  generator=gen, n0=4, fidelities=(1.0,),
                                  fidelity_knob="mtbf")
    with pytest.raises(ValueError, match="cannot also be"):
        search.successive_halving(port_t, {"horizon": [1.0]}, generator=gen,
                                  n0=4, fidelities=(1.0,))
    with pytest.raises(ValueError, match="cannot halve"):
        search.successive_halving(port_t, {"host_policy": [0, 1]},
                                  generator=gen, n0=2,
                                  fidelities=(1.0, 2.0, 3.0))

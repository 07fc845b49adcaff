"""The network layer and streamed campaigns on a card against the port's own
CPU run.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_network_cuda.py

``staging_scenario`` (least-loaded and locality dispatch) and Table 1 under
a topology must match the CPU with integer fields exact and floats within
rtol 1e-5; a staging campaign on the card is bitwise its rows' solo card
runs; the reducers' integer folds, ``ArgBest`` and ``Values`` are bitwise
the same for two chunk sizes on the card and equal the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import result_to_numpy
from repro_torch.core import (
    ArgBestReducer, HistogramReducer, MeanReducer, SumReducer, Topology,
    ValuesReducer, run_campaign, scenarios, simulate, stack_scenarios)

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")


def _same(card, cpu, what):
    a, b = result_to_numpy(card), result_to_numpy(cpu)
    for k in a:
        if a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=0,
                                       err_msg=f"{what} {k}")


BUILDERS = {
    "staging": lambda dev: scenarios.staging_scenario(
        n_cloudlets=64, wave=16, device=dev),
    "staging_locality": lambda dev: scenarios.staging_scenario(
        n_cloudlets=64, wave=16, bw_mbps=50.0, locality_dispatch=True,
        device=dev),
    "table1_topology": lambda dev: scenarios.table1_scenario(
        True, device=dev).replace(topology=Topology.uniform(
            3, latency_s=5.0, bw_mbps=50.0, device=dev)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_card_matches_cpu(name):
    _card()
    res = simulate(BUILDERS[name]("cuda"))
    _same(res, simulate(BUILDERS[name]("cpu"), device="cpu"), name)
    assert int(res.n_finished) > 0


def test_staging_campaign_is_its_solo_runs():
    _card()
    rows = [scenarios.staging_scenario(
        n_cloudlets=64, wave=16, wave_dt=dt, locality_dispatch=loc,
        device="cuda") for dt, loc in ((2.0, False), (0.5, True))]
    batch = simulate(stack_scenarios(rows))
    for i, scn in enumerate(rows):
        a = result_to_numpy(batch.map(lambda x: x[i]))
        b = result_to_numpy(simulate(scn))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"row {i} {k}")


def _reducers(n):
    return {
        "finished": SumReducer("n_finished"),
        "mt": MeanReducer("mean_turnaround"),
        "hist": HistogramReducer("makespan", 0.0, 4000.0, bins=32),
        "best": ArgBestReducer("total_cost"),
        "vals": ValuesReducer("total_cost", n_slots=n),
    }


def _campaign(dev):
    rows = [scenarios.fig4_scenario(h, v, device=dev)
            for h in (0, 1) for v in (0, 1)] * 5
    return stack_scenarios(rows)


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if hasattr(x, "leaves"):
        return x.leaves()
    return [x]


def test_reducers_chunk_size_invariance_on_the_card():
    _card()
    batch = _campaign("cuda")
    n = batch.policy.horizon.shape[0]
    a = run_campaign(batch, chunk_size=3, reduce=_reducers(n))
    b = run_campaign(batch, chunk_size=8, reduce=_reducers(n))
    cpu = run_campaign(_campaign("cpu"), chunk_size=3, reduce=_reducers(n),
                       device="cpu")
    for name in ("finished", "hist", "best", "vals"):
        for x, y, z in zip(_leaves(a[name]), _leaves(b[name]),
                           _leaves(cpu[name])):
            assert torch.equal(x, y), name
            np.testing.assert_allclose(x.cpu().numpy(), z.numpy(),
                                       rtol=1e-5, err_msg=name)
    for k in ("n", "mean"):
        np.testing.assert_allclose(a["mt"][k].cpu().numpy(),
                                   b["mt"][k].cpu().numpy(), rtol=1e-5)

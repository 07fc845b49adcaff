"""The event loop's extensions on a card against the port's own CPU run.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports neither JAX nor the JAX package, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_extensions_cuda.py

Each constructor of the slice (trace, outages and evacuation, autoscaling,
live migration, the generated workloads) is built from the same seed for
the card and for the CPU; the card's result must match the CPU's with
integer fields exact and floats within rtol 1e-5 (segment sums on the card
add in another fixed order), and a two-row campaign on the card must be
bitwise its rows' solo card runs.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import result_to_numpy
from repro_torch.core import (
    INF, scenarios, simulate, simulate_instrumented, simulate_trace,
    stack_scenarios)

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


BUILDERS = {
    "evacuation": lambda dev: scenarios.evacuation_scenario(device=dev),
    "restart_control": lambda dev: scenarios.evacuation_scenario(
        evacuation=False, ckpt_interval=INF, device=dev),
    "reliability": lambda dev: scenarios.reliability_scenario(
        _gen(0), mtbf_s=300.0, evacuation=True, ckpt_interval=25_000.0,
        device=dev),
    "reliability_never": lambda dev: scenarios.reliability_scenario(
        None, device=dev),
    "autoscale": lambda dev: scenarios.autoscale_scenario(
        _gen(0), scale_down_thresh=0.05, device=dev),
    "consolidation": lambda dev: scenarios.consolidation_scenario(device=dev),
    "balance": lambda dev: scenarios.balance_scenario(device=dev),
    "table1_live": lambda dev: scenarios.table1_scenario(
        True, live_migration=True, migrate_balance_thresh=0.8, device=dev),
    **{f"generated_{k}": (lambda dev, k=k: scenarios.generated_scenario(
        _gen(1), kind=k, device=dev)) for k in ("poisson", "diurnal", "bursty")},
    "serving": lambda dev: scenarios.serving_scenario(
        _gen(2), n_requests=32, n_pool=2, autoscale=True, device=dev),
}


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


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_card_matches_cpu(name):
    _card()
    scn = BUILDERS[name]("cuda")
    res, out = simulate_instrumented(scn)
    res_cpu, out_cpu = simulate_instrumented(BUILDERS[name]("cpu"),
                                             device="cpu")
    _same(res, res_cpu, name)
    for key, outputs in out_cpu.items():      # the instruments' counts
        for k, v in outputs.items():
            assert torch.equal(out[key][k].cpu(), v), (key, k)


def test_trace_on_the_card():
    _card()
    scn = BUILDERS["evacuation"]("cuda")
    ts = torch.arange(0.0, 1200.0, 77.0)
    res, prog = simulate_trace(scn, ts)
    plain = result_to_numpy(simulate(scn))
    for k, v in result_to_numpy(res).items():
        np.testing.assert_array_equal(v, plain[k], err_msg=k)
    _, prog_cpu = simulate_trace(BUILDERS["evacuation"]("cpu"), ts,
                                 device="cpu")
    np.testing.assert_allclose(prog.cpu().numpy(), prog_cpu.numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["reliability", "autoscale",
                                  "consolidation"])
def test_two_row_campaign_is_its_solo_runs(name):
    _card()
    if name == "reliability":
        rows = [scenarios.reliability_scenario(
            _gen(s), mtbf_s=300.0, evacuation=bool(s), device="cuda")
            for s in (0, 1)]
    elif name == "autoscale":
        rows = [scenarios.autoscale_scenario(_gen(s), max_steps=600,
                                             device="cuda") for s in (0, 1)]
    else:
        rows = [scenarios.consolidation_scenario(
            consolidate_thresh=c, device="cuda") for c in (0.0, 0.5)]
    batch = simulate(stack_scenarios(rows))
    for i, scn in enumerate(rows):
        a = result_to_numpy(batch.map(lambda x: x[i]))
        b = result_to_numpy(simulate(scn))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"row {i} {k}")

"""``simulate_history`` of the port against the JAX package's, on the CPU.

The parity scenarios of ``test_torch_engine.py`` (built by the JAX package,
carried across through numpy) go through
``jax.jit(repro.core.simulate_history)`` and the port.  The
per-event log has the reference's fixed length ``max_steps``; integer and
boolean columns match exactly, float columns within rtol 1e-5.  ``dt`` is
a difference of clock readings, so it is held to that plus two float32 ulps
of the clock ``t``.  Within the port, a campaign's log rows are bitwise the
solo logs.
"""
import jax
import numpy as np
import pytest

from repro.core import scenarios as jscn
from repro.core import simulate_history as jax_simulate_history
from repro_torch.convert import result_to_numpy, scenario_from_arrays
from repro_torch.core import simulate, simulate_history, stack_scenarios
from test_torch_engine import PARITY
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

_jax_history = jax.jit(jax_simulate_history)


def _assert_match(jax_tree, torch_tree):
    a, b = result_to_numpy(jax_tree), result_to_numpy(torch_tree)
    for k in a:
        assert b[k].shape == a[k].shape, k
        if k == "dt":
            limit = 1e-5 * np.abs(a[k]) + 2 * np.spacing(np.abs(a["t"]))
            assert np.all(np.abs(b[k] - a[k]) <= limit), k
        elif a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_history_matches_jax(name):
    jax_scn = PARITY[name]()
    jres, jhist = _jax_history(jax_scn)
    res, hist = simulate_history(scenario_from_arrays(jax_scn, "cpu"),
                                 device="cpu")
    _assert_match(jres, res)
    _assert_match(jhist, hist)


def test_history_result_is_simulate():
    scn = scenario_from_arrays(PARITY["table1_federated"](), "cpu")
    res, hist = simulate_history(scn, device="cpu")
    a, b = result_to_numpy(res), result_to_numpy(simulate(scn, device="cpu"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(hist.valid.sum()) == int(res.n_events)


def test_batch_history_rows_are_solo_histories():
    rows = [scenario_from_arrays(jscn.table1_scenario(fed), "cpu")
            for fed in (True, False)]
    _, hist = simulate_history(stack_scenarios(rows), device="cpu")
    for i, scn in enumerate(rows):
        _, solo = simulate_history(scn, device="cpu")
        a = result_to_numpy(hist.map(lambda x: x[:, i]))
        b = result_to_numpy(solo)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

"""simlint's card-only checks (``repro_torch.analysis.simlint``).

Every test is marked ``cuda`` and skips without an NVIDIA GPU; the file
imports torch, numpy and ``repro_torch`` only (the card's host has no JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_simlint_cuda.py

R3: every instrument hook runs under ``set_sync_debug_mode("error")``
without a synchronisation, and a hook that calls ``.item()`` raises there.
R6: every audited plan's threads and shared memory equal what the built
libraries report.  R2: the peak memory above the held baseline of 8 chunks
equals 2 chunks' within 1 MiB, and a chunk runner that keeps its results
moves it by more.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import simlint
from repro_torch.core import campaign, step

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


@pytest.fixture(scope="module")
def ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    with simlint.LintContext(device="cuda") as c:
        yield c


class _ItemPost(step.Instrument):
    name = "noisy"

    def post(self, scn, st, ev, aux):
        float(ev.dt.sum().item())
        return st, aux


def test_r3_hooks_do_not_synchronise(ctx):
    for _, scn, extras in simlint._hook_subjects(ctx):
        for label, ops, written, err in simlint.probe_hooks(scn, extras,
                                                            on_card=True):
            assert err is None, (label, err)
            assert simlint.check_hook(label, ops, written, err) == [], label


def test_r3_item_in_a_hook_synchronises(ctx):
    scn = ctx.scenario().replace(instruments=(_ItemPost(),))
    hooks = simlint.probe_hooks(scn, (), on_card=True)
    found = [f for label, ops, written, err in hooks
             for f in simlint.check_hook(label, ops, written, err)]
    assert {f.entry_point for f in found} == {"instrument:noisy.post"}
    assert any("synchronised" in f.message for f in found)
    assert any("host read" in f.message for f in found)


def test_r6_plans_equal_the_built_libraries(ctx):
    plans = simlint._plans(ctx)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    geometry = simlint.probe_geometry(plans, n_sm)
    assert len(geometry) > 40
    for what, planned, built in geometry:
        assert simlint.check_geometry(what, planned, built, "t") == [], what
    assert simlint.run_lint(rules=["R6"], ctx=ctx) == []


def test_r2_peak_memory_is_one_chunk(ctx):
    peaks = simlint.probe_chunk_memory(ctx, simlint.R2_CHUNK["cuda"])
    assert min(peaks.values()) > 1 << 20
    assert simlint.check_chunk_memory(peaks, "t") == []


def test_r2_kept_chunks_grow_the_peak(ctx, monkeypatch):
    kept = []
    orig = campaign._simulate

    def keeping(chunk, dev, mesh, axis):
        res = orig(chunk, dev, mesh, axis)
        kept.append((chunk, res))
        return res

    monkeypatch.setattr(campaign, "_simulate", keeping)
    peaks = simlint.probe_chunk_memory(ctx, simlint.R2_CHUNK["cuda"])
    errs = simlint.check_chunk_memory(peaks, "t")
    assert len(errs) == 1 and "grew" in errs[0].message
    assert np.diff([peaks[n] for n in sorted(peaks)])[0] > 1 << 20


def test_whole_lint_on_the_card(ctx):
    findings = simlint.run_lint(ctx=ctx)
    assert [f for f in findings if f.severity == "error"] == [], \
        simlint.format_report(findings)

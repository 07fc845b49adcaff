"""simlint for the PyTorch engine (``repro_torch.analysis.simlint``): every
rule must pass on the current tree and FIRE on a doctored artifact — a
linter whose rules never trip is a slow no-op:

  R1  a phase entered though its gate read False; a gate read without
      ``host_any``
  R2  a chunk runner that keeps its chunk results
  R3  an instrument whose ``post`` calls ``.item()`` or writes into ``st``;
      a driver that reads the host outside ``host_any``
  R4  a step variant that calls ``nonzero``; boolean-mask indexing; a
      state leaf that changes shape
  R5  a knob turned into a Python branch; a library loaded twice
  R6  plans doctored past each Hopper limit

The plumbing (``Finding``, the rule IDs and slugs, ``summarize``,
``format_report``, the CLI's JSON keys and exit codes) is held against the
reference's ``repro.analysis.simlint`` on the same findings.  The whole
lint, ``campaign_sharded`` included (a gloo group of one rank), runs in a
subprocess through the CLI; in this process the entries stay local.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import simlint as jlint
from repro_torch.analysis import simlint
from repro_torch.core import (
    SPACE_SHARED, campaign, engine, policies, scenarios, step)
from repro_torch.kernels import flash_attention, ssd_scan, vm_update
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
LOCAL = ("simulate", "simulate_trace", "simulate_history", "batch",
         "campaign_chunk", "advance")
PHASES = tuple(label for label, _ in simlint.PHASES)


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


@pytest.fixture(scope="module")
def ctx():
    with simlint.LintContext(entries=LOCAL, device="cpu") as c:
        yield c


# ---------------------------------------------------------------------------
# the current tree is clean
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule_id", ["R1", "R2", "R3", "R4", "R5", "R6"])
def test_rule_passes_on_current_tree(ctx, rule_id):
    assert simlint.run_lint(rules=[rule_id], ctx=ctx) == []


def test_runs_record_gated_phases(ctx):
    """The probes see real work: Fig. 4's first step provisions, later
    steps skip every phase, each step reads three counted gates."""
    run = ctx.run("simulate")
    assert len(run.steps) >= 2
    first, later = run.steps[0], run.steps[1:]
    assert first.key() == (True, False, False)
    assert first.entered == ["provision"] and first.phase_ops["provision"] > 0
    assert all(s.key() == (False, False, False) and not s.entered
               for s in later)
    assert all(s.syncs == s.host_reads == 3 for s in run.steps)
    assert run.syncs == run.host_reads
    stats = simlint.step_stats(ctx)
    assert stats["simulate"]["syncs_per_step"] == 3.0
    assert stats["simulate"]["ops_max"] == len(first.ops)


# ---------------------------------------------------------------------------
# R1 phase skips
# ---------------------------------------------------------------------------


def _record(scn=None):
    scn = scn if scn is not None else simlint.LintContext(
        device="cpu").scenario()
    return simlint.record_run(engine.simulate, scn, device="cpu")[1]


def test_r1_phase_run_without_its_gate_trips(monkeypatch):
    """A gate that is read and counted, then ignored: the phases run at
    every event."""
    orig = step.host_any

    def ignored(x):
        orig(x)
        return True

    ignored.syncs = orig.syncs
    monkeypatch.setattr(step, "host_any", ignored)
    run = _record()
    errs = _errors(simlint.check_phase_skips(run.steps, PHASES, "t"))
    assert errs and all(e.rule == "R1" for e in errs)
    assert any("ran though its gate read False" in e.message for e in errs)


def test_r1_uncounted_gate_trips(monkeypatch):
    def uncounted(x):
        return bool(x.any())

    uncounted.syncs = step.host_any.syncs
    monkeypatch.setattr(step, "host_any", uncounted)
    run = _record()
    errs = _errors(simlint.check_phase_skips(run.steps, PHASES, "t"))
    assert any("host_any.syncs moved by 0" in e.message for e in errs)


def test_r1_doctored_records():
    ok = simlint.StepRecord(gates=[True, False, False],
                            entered=["provision"], syncs=3, host_reads=3)
    assert simlint.check_phase_skips([ok], PHASES, "t") == []
    skipped = simlint.StepRecord(gates=[True, False, False],
                                 entered=[], syncs=3, host_reads=3)
    noisy = simlint.StepRecord(gates=[False, False, False], entered=[],
                               phase_ops={"dispatch": 4}, syncs=3,
                               host_reads=3)
    short = simlint.StepRecord(gates=[True], syncs=1, host_reads=1)
    for rec, words in ((skipped, "was not entered"),
                       (noisy, "enqueued 4 operator"),
                       (short, "per gated phase")):
        errs = _errors(simlint.check_phase_skips([rec], PHASES, "t"))
        assert len(errs) == 1 and words in errs[0].message
    assert _errors(simlint.check_phase_skips([], PHASES, "t"))


# ---------------------------------------------------------------------------
# R2 chunk lifetimes
# ---------------------------------------------------------------------------


def _small_campaign(rows):
    one = scenarios.fig4_scenario(SPACE_SHARED, SPACE_SHARED, device="cpu")
    return campaign.broadcast_campaign(one, rows)


def test_r2_streamed_chunks_die():
    records = simlint.probe_chunk_lifetimes(
        _small_campaign(8), 2, simlint._r2_reducers(8), "cpu")
    assert len(records) == 4        # 3 chunk starts + after the campaign
    assert simlint.check_chunk_lifetimes(records, "t") == []


def test_r2_chunk_runner_keeping_results_trips(monkeypatch):
    kept = []
    orig = campaign._simulate

    def keeping(chunk, dev, mesh, axis):
        res = orig(chunk, dev, mesh, axis)
        kept.append(res)
        return res

    monkeypatch.setattr(campaign, "_simulate", keeping)
    records = simlint.probe_chunk_lifetimes(
        _small_campaign(8), 2, simlint._r2_reducers(8), "cpu")
    errs = _errors(simlint.check_chunk_lifetimes(records, "t"))
    assert len(errs) == 4 and all(e.rule == "R2" for e in errs)
    assert "finish_t" in errs[0].evidence


def test_r2_memory_growth_trips():
    assert simlint.check_chunk_memory({2: 5 << 20, 8: (5 << 20) + 4096},
                                      "t") == []
    errs = simlint.check_chunk_memory({2: 5 << 20, 8: 9 << 20}, "t")
    assert len(errs) == 1 and "grew" in errs[0].message
    assert _errors(simlint.check_chunk_lifetimes([], "t"))


# ---------------------------------------------------------------------------
# R3 pure observers
# ---------------------------------------------------------------------------


class _ItemPost(step.Instrument):
    name = "noisy"

    def post(self, scn, st, ev, aux):
        float(ev.dt.sum().item())
        return st, aux


class _WritingPost(step.Instrument):
    name = "writer"

    def post(self, scn, st, ev, aux):
        st.t.add_(0.0)
        return st, aux


@pytest.mark.parametrize("ins,words", [(_ItemPost(), "host read"),
                                       (_WritingPost(), "wrote into")])
def test_r3_doctored_instrument_trips(ctx, ins, words):
    scn = ctx.scenario().replace(instruments=(ins,))
    hooks = simlint.probe_hooks(scn, (), on_card=False)
    found = [f for label, ops, written, err in hooks
             for f in simlint.check_hook(label, ops, written, err)]
    assert len(found) == 1 and found[0].rule == "R3"
    assert found[0].entry_point == f"instrument:{ins.name}.post"
    assert words in found[0].message
    if words == "wrote into":
        assert "st.t" in found[0].evidence


def test_r3_hooks_of_every_instrument_are_pure(ctx):
    subjects = simlint._hook_subjects(ctx)
    names = set()
    for _, scn, extras in subjects:
        for label, ops, written, err in simlint.probe_hooks(scn, extras,
                                                            False):
            names.add(label.split(".")[0])
            assert simlint.check_hook(label, ops, written, err) == [], label
    assert names == {f"instrument:{n}" for n in (
        "sensor", "market", "energy", "trace", "utilization", "autoscale",
        "migration", "reliability")}


def test_r3_driver_reading_the_host_trips(monkeypatch):
    orig = engine.step_cond

    def reading(scn, st, max_steps):
        live = orig(scn, st, max_steps)
        int(live.sum())
        return live

    monkeypatch.setattr(engine, "step_cond", reading)
    run = _record()
    errs = simlint.check_host_reads(run.host_reads, run.syncs, "t")
    assert len(errs) == 1 and "outside its counted gates" in errs[0].message
    assert simlint.check_hook("h", [], [], "sync") != []


# ---------------------------------------------------------------------------
# R4 shapes
# ---------------------------------------------------------------------------


def test_r4_nonzero_step_trips(monkeypatch):
    orig = policies.cloudlet_rates

    def with_nonzero(scn, st):
        rate, vm_mips = orig(scn, st)
        torch.nonzero(rate)
        return rate, vm_mips

    monkeypatch.setattr(policies, "cloudlet_rates", with_nonzero)
    run = _record()
    errs = _errors(simlint.check_shape_stability(
        [op for s in run.steps for op in s.ops], "t"))
    assert len(errs) == 1 and "nonzero" in errs[0].message
    assert errs[0].rule == "R4"


@pytest.mark.parametrize("fn,dynamic", [
    (lambda x, m, i: x[m], True),
    (lambda x, m, i: x.masked_select(m), True),
    (lambda x, m, i: torch.unique(x), True),
    (lambda x, m, i: torch.repeat_interleave(x, i), True),
    (lambda x, m, i: x.nonzero(), True),
    (lambda x, m, i: torch.repeat_interleave(x, i, output_size=3), False),
    (lambda x, m, i: x[i], False),
    (lambda x, m, i: torch.where(m, x, 0.0), False),
])
def test_r4_dynamic_ops_are_named(fn, dynamic):
    x = torch.arange(3.0)
    m = torch.tensor([True, False, True])
    i = torch.tensor([0, 2, 1])
    rec = simlint.OpRecorder()
    with rec:
        fn(x, m, i)
    assert bool(simlint.check_shape_stability(rec.ops, "t")) == dynamic


def test_r4_state_and_rank_drift_trip():
    steps = [simlint.StepRecord(state_shapes={"t": (4,), "rem_mi": (4, 8)}),
             simlint.StepRecord(state_shapes={"t": (4,), "rem_mi": (4, 7)})]
    errs = simlint.check_state_shapes({"t": (4,), "rem_mi": (4, 8)}, steps,
                                      "t")
    assert len(errs) == 1 and "rem_mi changed shape at batch step 1" in \
        errs[0].message


@pytest.mark.parametrize("single,batch", [
    ({"a": (8,), "b": ()}, {"a": (4, 8), "b": (4,)}),
    ({"a": (8,), "b": ()}, {"a": (4, 8), "b": (2,)}),
    ({"a": (8,), "gone": ()}, {"a": (4, 8), "new": (4,)}),
])
def test_r4_rank_consistency_matches_reference(single, batch):
    got = simlint.check_rank_consistency(single, batch, 4, "t")
    want = jlint.check_rank_consistency(single, batch, 4, "t")
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]


# ---------------------------------------------------------------------------
# R5 one program
# ---------------------------------------------------------------------------


def test_r5_knob_as_python_branch_trips(ctx, monkeypatch):
    """A knob read on the host and branched on: the time-shared variant's
    steps enqueue an extra operator."""
    orig = policies.cloudlet_rates

    def branching(scn, st):
        rate, vm_mips = orig(scn, st)
        if bool((scn.policy.vm_policy == 1).any()):
            rate = rate * 1.0
        return rate, vm_mips

    monkeypatch.setattr(policies, "cloudlet_rates", branching)
    a = _record(scn=ctx.scenario())
    b = _record(scn=ctx.scenario_variant())
    errs = _errors(simlint.check_one_program(
        [("fig4", s) for s in a.steps] + [("variant", s) for s in b.steps],
        "t"))
    assert len(errs) == 1 and "Python branch" in errs[0].message
    assert "aten.mul" in errs[0].evidence or "lengths" in errs[0].evidence


def test_r5_search_probe_sees_folds(ctx):
    misses, folds = ctx.cached("search", lambda: simlint.probe_search(ctx))
    assert set(misses) == {"vm_update", "flash_attention",
                           "flash_attention_bwd", "ssd_scan"}
    # two runs x (2 chunks in rung 0 + 1 chunk in rung 1), each of 2 rows
    assert [rows for rows, _ in folds] == [2] * 6
    assert simlint.check_fold_traces(folds, "t") == []
    bad = folds[:1] + [(2, folds[0][1][:-1])]
    assert _errors(simlint.check_fold_traces(bad, "t"))


def test_r5_doctored_artifacts_trip():
    assert _errors(simlint.check_library_loads({"ssd_scan": 2}, "t"))
    assert simlint.check_library_loads({"ssd_scan": 1, "vm": 0}, "t") == []
    op = simlint.OpRecord("aten.add.Tensor", ((4,),), ("torch.float32",),
                          ("cpu",))
    a = simlint.StepRecord(gates=[False], ops=[op])
    b = simlint.StepRecord(gates=[False], ops=[op, op])
    assert _errors(simlint.check_one_program([("x", a), ("y", b)], "t"))
    only = simlint.check_one_program([("x", a)], "t")
    assert [f.severity for f in only] == ["info"]


# ---------------------------------------------------------------------------
# R6 launch plans
# ---------------------------------------------------------------------------


def _sweep_errs(plan, b, c):
    return _errors(simlint.check_sweep_plan(
        plan, b, c, "t", vm_update.FUSED_CAP, vm_update.SPLIT_TILE,
        vm_update.N_SM, vm_update.FUSED_THREADS))


def test_r6_sweep_doctored_plans_trip():
    plan = vm_update.kernel_plan(1024, 500)
    assert _sweep_errs(plan, 1024, 500) == []
    too_wide = dict(plan, threads=1024)
    assert any("limit 512" in e.message for e in _sweep_errs(too_wide, 1024,
                                                             500))
    split = dict(plan, variant="split", nb=1, grid=(1, 1024))
    assert any("fits FUSED_CAP" in e.message
               for e in _sweep_errs(split, 1024, 500))
    # past 65,535 rows the split grid's blocks step through the rows: an
    # unfolded grid trips
    big = vm_update.kernel_plan(70_000, 1 << 20)
    assert _sweep_errs(big, 70_000, 1 << 20) == []
    unfolded = dict(big, grid=(big["nb"], 70_000))
    assert any("grid.y 70000" in e.message
               for e in _sweep_errs(unfolded, 70_000, 1 << 20))
    short = dict(plan, items=1)
    assert any("covers" in e.message for e in _sweep_errs(short, 1024, 500))


@pytest.mark.parametrize("field,value,words", [
    ("threads", 96, "whole warpgroups"),
    ("threads", 2048, "limit 1024"),
    ("smem", 232_449, "dynamic shared memory"),
    ("grid", (2**31, 16, 1), "grid.x"),
    ("grid", (4, 65_536, 1), "grid.y"),
    ("grid", (4, 16, 65_536), "grid.z"),
])
def test_r6_flash_doctored_plans_trip(field, value, words):
    shape = (1, 16, 8, 512, 512, 128)
    plan = flash_attention.kernel_plan(*shape, torch.bfloat16)
    assert simlint.check_flash_plan(plan, shape, "t") == []
    errs = _errors(simlint.check_flash_plan(dict(plan, **{field: value}),
                                            shape, "t"))
    assert any(words in e.message for e in errs), errs


def test_r6_flash_bwd_and_ssd_doctored_plans_trip():
    shape = (8, 16, 8, 2048, 2048, 128)
    plan = flash_attention.kernel_plan_bwd(*shape, torch.bfloat16)
    assert simlint.check_flash_bwd_plan(plan, shape, "t") == []
    bad = dict(plan, dq=dict(plan["dq"], smem=300_000))
    assert any("dq" in e.message and "shared memory" in e.message
               for e in simlint.check_flash_bwd_plan(bad, shape, "t"))
    bad = dict(plan, grids=dict(plan["grids"], delta=(0,)))
    assert any("delta" in e.message
               for e in simlint.check_flash_bwd_plan(bad, shape, "t"))
    _wide_and_folded_flash_plans_pass_and_trip()
    sshape = (8, 2048, 24, 64, 1, 128)
    splan = ssd_scan.kernel_plan(*sshape, 128, torch.bfloat16)
    assert simlint.check_ssd_plan(splan, sshape, "t") == []
    phases = [dict(splan["phases"][0], threads=100)] + splan["phases"][1:]
    errs = simlint.check_ssd_plan(dict(splan, phases=phases), sshape, "t")
    assert any("whole warps" in e.message for e in errs)


def _wide_and_folded_flash_plans_pass_and_trip():
    """Wide heads (column slices on x) and (batch, head) pairs past the
    grid's y and z (folded) or past one launch's (several launches) pass
    R6; a grid without the slices, an unfolded one, or one launch for 2^31
    pairs, trips."""
    for shape in ((1, 16, 2, 4096, 4096, 256), (2, 4, 2, 300, 300, 520),
                  (70_000, 2, 1, 64, 64, 20), (1, 70_000, 70_000, 64, 64, 16),
                  (65_536, 32_768, 1, 1, 1, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            plan = flash_attention.kernel_plan(*shape, dtype)
            bwd = flash_attention.kernel_plan_bwd(*shape, dtype)
            assert simlint.check_flash_plan(plan, shape, "t") == [], shape
            assert simlint.check_flash_bwd_plan(bwd, shape, "t") == [], shape
    shape = (1, 16, 2, 4096, 4096, 512)   # bf16 slices past 256 columns
    plan = flash_attention.kernel_plan(*shape, torch.bfloat16)
    no_slices = dict(plan, grid=(64, 16, 1))
    assert any("does not cover" in e.message for e in _errors(
        simlint.check_flash_plan(no_slices, shape, "t")))
    shape = (70_000, 2, 1, 64, 64, 20)
    plan = flash_attention.kernel_plan(*shape, torch.float32)
    unfolded = dict(plan, grid=(plan["grid"][0], 2, 70_000))
    assert any("grid.z 70000" in e.message for e in _errors(
        simlint.check_flash_plan(unfolded, shape, "t")))
    shape = (65_536, 32_768, 1, 1, 1, 8)
    plan = flash_attention.kernel_plan(*shape, torch.bfloat16)
    assert any("does not cover" in e.message for e in _errors(
        simlint.check_flash_plan(dict(plan, pair_chunks=1), shape, "t")))


def test_r6_geometry_mismatch_trips():
    assert simlint.check_geometry("x", (1, 2), (1, 2), "t") == []
    assert "built library (1, 3)" in simlint.check_geometry(
        "x", (1, 2), (1, 3), "t")[0].message
    assert _errors(simlint.check_geometry("x", (1, 2), None, "t"))


def test_r6_audits_every_kernel(ctx):
    plans = ctx.cached("plans", lambda: simlint._plans(ctx))
    assert {k: len(v) > 10 for k, v in plans.items()} == {
        "sweep": True, "flash": True, "flash_bwd": True, "ssd": True}
    assert {p["variant"] for _, _, p in plans["sweep"]} == {"fused", "split"}
    assert {p["variant"] for _, _, p in plans["flash"]} == {
        "wgmma", "wgmma_256", "cuda_cores", "cuda_cores_256"}


# ---------------------------------------------------------------------------
# plumbing against the reference
# ---------------------------------------------------------------------------

_SAME = [("R5", "recompile-hazard", "error", "e", "m", "ev"),
         ("R2", "donation-aliases", "warning", "e2", "m2", ""),
         ("R1", "cond-not-select", "info", "e3", "m3", "x" * 200)]


def test_registry_matches_reference():
    assert simlint.SEVERITIES == jlint.SEVERITIES
    assert {k: r.name for k, r in simlint.RULES.items()} == \
        {k: r.name for k, r in jlint.RULES.items()}
    assert [f.name for f in dataclasses.fields(simlint.Finding)] == \
        [f.name for f in dataclasses.fields(jlint.Finding)]
    for spec in simlint.RULES.values():
        assert spec.entries and spec.doc
        assert set(spec.entries) <= set(simlint.ENTRY_NAMES)


def _strip_docs(report: str) -> list:
    """A report without the rule docs (which speak of each engine)."""
    return [ln.split(":")[0] if ln.startswith("[") else ln
            for ln in report.splitlines()]


def test_findings_report_like_reference():
    ours = [simlint.Finding(*t) for t in _SAME]
    theirs = [jlint.Finding(*t) for t in _SAME]
    assert [f.to_dict() for f in ours] == [f.to_dict() for f in theirs]
    assert simlint.summarize(ours) == jlint.summarize(theirs)
    for rules in (None, ["R2", "R5"]):
        assert _strip_docs(simlint.format_report(ours, rules)) == \
            _strip_docs(jlint.format_report(theirs, rules))


def test_r6_report_like_reference():
    theirs = jlint.run_lint(rules=["R6"])
    ours = simlint.run_lint(rules=["R6"], device="cpu")
    assert ours == [] and theirs == []
    assert simlint.summarize(ours) == jlint.summarize(theirs)
    assert _strip_docs(simlint.format_report(ours, ["R6"])) == \
        _strip_docs(jlint.format_report(theirs, ["R6"]))


def test_unknown_rule_and_entry_raise():
    with pytest.raises(ValueError, match="R99"):
        simlint.run_lint(rules=["R99"], device="cpu")
    with pytest.raises(ValueError, match="warp_drive"):
        simlint.LintContext(entries=["warp_drive"], device="cpu")


def test_no_device_means_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simlint.LintContext()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable,
                           str(ROOT / "scripts" / "simlint_torch.py"), *args],
                          capture_output=True, text=True, env=env,
                          timeout=600)


def test_cli_whole_lint_on_cpu():
    """Every rule over every entry (``campaign_sharded`` on a gloo group of
    one rank) exits 0 with the reference's JSON keys."""
    out = _cli("--device", "cpu", "--json", "-")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    payload = _json_out(out.stdout)
    assert list(payload) == ["findings", "summary", "rules_run", "entries"]
    assert payload["summary"] == {"error": 0, "warning": 0, "info": 0}
    assert payload["rules_run"] == ["R1", "R2", "R3", "R4", "R5", "R6"]
    assert payload["entries"] == list(simlint.ENTRY_NAMES)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", "_cli"), ROOT / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_out(text: str) -> dict:
    return json.loads(text[text.index("{"):])


def test_cli_usage_and_keys_like_reference(capsys):
    ours, theirs = _script("simlint_torch.py"), _script("simlint.py")
    assert ours.main(["--device", "cpu", "--rule", "R6", "--json", "-"]) == 0
    mine = _json_out(capsys.readouterr().out)
    assert theirs.main(["--rule", "R6", "--json", "-"]) == 0
    ref = _json_out(capsys.readouterr().out)
    assert list(mine) == list(ref)
    assert mine["summary"] == ref["summary"]
    assert mine["rules_run"] == ref["rules_run"]
    assert ours.main(["--device", "cpu", "--rule", "R99"]) == \
        theirs.main(["--rule", "R99"]) == 2
    assert "R99" in capsys.readouterr().err
    assert ours.main(["--list"]) == 0
    assert "entry points: simulate" in capsys.readouterr().out


def test_cli_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a GPU")
    out = _cli("--rule", "R6")
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_cli_exits_1_on_an_error(monkeypatch, capsys):
    cli = _script("simlint_torch.py")
    bad = simlint.Finding("R6", "kernel-budget", "error", "advance", "m")
    monkeypatch.setattr(simlint.RULES["R6"], "fn", lambda ctx: [bad])
    assert cli.main(["--device", "cpu", "--rule", "R6"]) == 1
    assert "[FAIL] R6 kernel-budget" in capsys.readouterr().out

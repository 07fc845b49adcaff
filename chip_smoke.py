"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the JAX package ``repro``) through
its main path on the card and fails with a non-zero exit code if any phase
fails:

1. build     compile every kernel of the path from ``src/repro_torch/csrc``
2. kernels   each kernel against its plain PyTorch version on the card at the
             main path's shapes (``dt`` bitwise, ``rem'`` within rtol 1e-6 /
             atol 1e-5), with its device time (CUDA-graph replay), the
             plain version's, its time per call with the enqueue, and its
             bound
3. anchors   the paper's experiments through ``simulate`` on the card: Fig. 4
             (four policy pairs), Table 1, Fig. 9/10 at 10,000 hosts and
             Fig. 7/8 at 100,000 hosts, each against the port's own CPU run
             (integer fields exact, float fields rtol 1e-5)
4. campaign  1024 Fig. 9/10 rows at 10,000 hosts as one batch-major run;
             rows 0 and 1 bitwise their solo runs
5. proof     the advance-sweep kernel's launch count over phases 3-4

Every line of numbers carries the card's name and power limit.  The line
before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with an error before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.convert import result_to_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SPACE_SHARED, TIME_SHARED, scenarios, simulate, stack_scenarios, step)
from repro_torch.kernels import ref, vm_update  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNEL_SHAPES = [(1024, 500), (1, 500), (1, 131072), (1, 3 * 2**17),
                 (8192, 4096)]
MAIN_SHAPE = (1024, 500)    # the advance sweep of the Fig. 9/10 campaign
CAMPAIGN_ROWS = 1024


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


CARD = card()


def say(phase: str, text: str) -> None:
    torch.cuda.synchronize()
    print(f"[{CARD}] {phase}: {text}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# --------------------------------------------------------------- 1. build
def phase_build() -> None:
    built = vm_update.build()
    took = ("reused an existing build" if built["seconds"] is None
            else f"nvcc {built['seconds']:.3f} s")
    say("build", f"advance_sweep {built['path'].name}: {took}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"    {line.strip()}")


# ------------------------------------------------------------- 2. kernels
def sweep_inputs(b: int, c: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rem = torch.rand(b, c, device="cuda", generator=g) * 100 + 0.1
    rate = torch.rand(b, c, device="cuda", generator=g) * 5
    rate = torch.where(torch.rand(b, c, device="cuda", generator=g) < 0.1,
                       0.0, rate)
    active = torch.rand(b, c, device="cuda", generator=g) > 0.3
    bound = torch.rand(b, device="cuda", generator=g) * 50 + 0.1
    return rem, rate, active, bound


def call_ms(fn, args, reps: int) -> float:
    """Wall time per call of a loop of calls, enqueue cost included (CUDA
    events around the loop; warm-up excluded)."""
    for _ in range(10):
        fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, args, reps: int) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's enqueue cost drops out.  Inputs stay the same
    across calls and may sit in the 50 MB L2, as the engine's just-computed
    rates do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_bound_ms(b: int, c: int) -> tuple[float, str]:
    """Least time for the sweep: each input read once and each output
    written once (rem, rate f32, active bool, bound f32 in; rem' and dt f32
    out), or its float32 operations (compare, divide, multiply, subtract,
    max per element), whichever is larger."""
    nbytes = b * c * (4 + 4 + 1 + 4) + b * (4 + 4)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 5 * b * c / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_kernels() -> dict:
    record = {}
    for i, (b, c) in enumerate(KERNEL_SHAPES):
        args = sweep_inputs(b, c, seed=i)
        dt, new_rem = vm_update.advance_sweep_cuda(*args)
        dt0, rem0 = ref.advance_sweep_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(dt, dt0), f"advance_sweep dt bitwise at {(b, c)}")
        check(torch.allclose(new_rem, rem0, rtol=1e-6, atol=1e-5),
              f"advance_sweep rem' within rtol 1e-6/atol 1e-5 at {(b, c)}")
        err = float((new_rem - rem0).abs().max())
        reps = 200 if b * c <= 2**22 else 10
        # in turns: plain, kernel, kernel, plain
        times = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = ref.advance_sweep_ref if name == "plain" else vm_update.advance_sweep_cuda
            times[name].append(device_ms(fn, args, reps))
        ms, plain_ms = (sum(times[k]) / 2 for k in ("kernel", "plain"))
        per_call = call_ms(vm_update.advance_sweep_cuda, args, reps)
        bound_ms, bound_by = sweep_bound_ms(b, c)
        plan = vm_update.kernel_plan(b, c)
        say("kernels", (
            f"advance_sweep [{b}, {c}] {plan['variant']} "
            f"(threads {plan['threads']}, items {plan['items']}, "
            f"tiles {plan['nb']}): dt bitwise, max|rem' err| {err!r}; "
            f"device time: kernel {ms!r} ms, plain {plain_ms!r} ms; "
            f"kernel per call with its enqueue {per_call!r} ms; "
            f"bytes {b * c * 13 + b * 8}, bound {bound_ms!r} ms ({bound_by}), "
            f"{bound_ms / ms:.3f} of bound"))
        if (b, c) == MAIN_SHAPE:
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return record


# ------------------------------------------------------------- 3. anchors
def same_as_cpu(gpu_res, scn, name: str) -> None:
    """The card's result against the port's own CPU run of the scenario."""
    a = result_to_numpy(gpu_res)
    b = result_to_numpy(simulate(scn, device="cpu"))
    for k in a:
        if a[k].dtype.kind in "biu":
            same = (a[k] == b[k]).all()
        else:
            same = (abs(a[k] - b[k]) <= 1e-5 * abs(b[k])).all()
        check(bool(same), f"{name}: field {k} on the card vs the CPU")


def run(scn):
    t0 = time.perf_counter()
    res = simulate(scn)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_anchors() -> tuple[dict, int]:
    """Returns the solo Fig. 9/10 runs (for phase 4) and the batch steps
    (= advance-sweep launches) the phase made."""
    steps = 0
    expected = {
        (SPACE_SHARED, SPACE_SHARED): [400, 400, 800, 800, 1200, 1200, 1600, 1600],
        (SPACE_SHARED, TIME_SHARED): [800] * 4 + [1600] * 4,
        (TIME_SHARED, SPACE_SHARED): [800, 800, 1600, 1600] * 2,
        (TIME_SHARED, TIME_SHARED): [1600] * 8,
    }
    for (hp, vp), finish in expected.items():
        scn = scenarios.fig4_scenario(hp, vp)
        res, secs = run(scn)
        check(res.finish_t.tolist() == [float(x) for x in finish],
              f"fig4 {hp}/{vp} finish times {res.finish_t.tolist()}")
        same_as_cpu(res, scn, f"fig4 {hp}/{vp}")
        steps += int(res.n_events)
        say("anchors", f"fig4 host {hp} / vm {vp}: finish {finish}, "
            f"{int(res.n_events)} events, {secs!r} s")

    scn = scenarios.table1_scenario(True)
    res, secs = run(scn)
    check(int(res.n_finished) == 25 and int(res.n_migrations) == 10,
          f"table1: {int(res.n_finished)} finished, "
          f"{int(res.n_migrations)} migrations")
    same_as_cpu(res, scn, "table1")
    steps += int(res.n_events)
    say("anchors", f"table1 federated: 25 finished, 10 migrations, "
        f"{int(res.n_events)} events, {secs!r} s")

    solo = {}
    for vp in (SPACE_SHARED, TIME_SHARED):
        scn = scenarios.fig9_10_scenario(vp)
        res, secs = run(scn)
        check(int(res.n_finished) == 500, f"fig9_10 vm {vp} finished all")
        if vp == SPACE_SHARED:
            took = res.finish_t - res.start_t
            check(bool(((took - 1200.0).abs() <= 1200.0 * 1e-6).all()),
                  "fig9_10 space-shared tasks take 1200 s")
        same_as_cpu(res, scn, f"fig9_10 vm {vp}")
        steps += int(res.n_events)
        solo[vp] = (scn, res)
        say("anchors", f"fig9_10 10000 hosts, 50 VMs, 500 cloudlets, vm "
            f"policy {vp}: makespan {float(res.makespan)!r} s, mean "
            f"turnaround {float(res.mean_turnaround)!r} s, "
            f"{int(res.n_events)} events, {secs!r} s")

    scn = scenarios.fig7_8_scenario(100_000)
    res, secs = run(scn)
    check(int(res.n_finished) == 1 and bool(res.vm_placed.all()),
          "fig7_8 at 100000 hosts")
    same_as_cpu(res, scn, "fig7_8")
    steps += int(res.n_events)
    say("anchors", f"fig7_8 100000 hosts: {int(res.n_events)} events, "
        f"{secs!r} s")
    return solo, steps


# ------------------------------------------------------------ 4. campaign
def phase_campaign(solo: dict) -> int:
    rows = [solo[SPACE_SHARED][0], solo[TIME_SHARED][0]] * (CAMPAIGN_ROWS // 2)
    batch = stack_scenarios(rows)
    mib = sum(x.numel() * x.element_size() for x in batch.leaves()) / 2**20
    syncs0 = step.host_any.syncs
    res, secs = run(batch)
    syncs = step.host_any.syncs - syncs0
    events = res.n_events
    batch_steps = int(events.max())
    check(bool((res.n_finished == 500).all()), "campaign rows finish all")
    for i, vp in enumerate((SPACE_SHARED, TIME_SHARED)):
        a = result_to_numpy(res.map(lambda x: x[i]))
        b = result_to_numpy(solo[vp][1])
        for k in a:
            check(a[k].shape == b[k].shape and (a[k] == b[k]).all(),
                  f"campaign row {i} field {k} bitwise its solo run")
    say("campaign", (
        f"{CAMPAIGN_ROWS} x fig9_10 (10000 hosts, vm policy alternating), "
        f"scenario {mib:.1f} MiB on the card: wall {secs!r} s, "
        f"{batch_steps} batch steps, {int(events.sum())} row events, "
        f"{batch_steps / secs!r} batch steps/s, "
        f"{int(events.sum()) / secs!r} row events/s, "
        f"{syncs} host syncs = {syncs / batch_steps!r} per batch step; "
        "rows 0 and 1 bitwise their solo runs"))
    return batch_steps


def main() -> None:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    phase_build()
    record = phase_kernels()

    vm_update.advance_sweep_cuda.launches = 0
    solo, steps = phase_anchors()
    steps += phase_campaign(solo)
    launches = vm_update.advance_sweep_cuda.launches
    check(launches > 0, "the main path launched the advance-sweep kernel")
    check(launches == steps,
          f"one advance-sweep launch per batch step ({launches} vs {steps})")
    say("proof", f"advance_sweep kernel launched {launches} times over "
        f"phases 3-4, one per batch step")

    kernels = [{
        "name": "advance_sweep",
        "route": "cuda",
        "source": "src/repro_torch/csrc/vm_update.cu",
        "replaces": "src/repro/kernels/vm_update.py:123",
        "launches": launches,
        **record,
        "library_ms": None,
    }]
    print(CARD)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

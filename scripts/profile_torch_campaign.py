"""Where the time goes in the port's batch-major engine on one NVIDIA GPU.

    python3 scripts/profile_torch_campaign.py

Runs the Fig. 9/10 experiment at the paper's 10,000 hosts, 50 VMs and 500
cloudlets through ``repro_torch.core.simulate``, alone (B = 1) and as a
1024-row campaign, each once to warm up and once under ``torch.profiler``.
Prints, per run: the wall time, batch steps, host syncs, CUDA kernel
launches per batch step, the summed device time of all kernels, the device's
idle share (1 - kernel time / wall time; one stream, so kernels do not
overlap), and the ops that took the most device time.  Every line carries
the card's name and power limit.  Needs a CUDA device; imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("profile_torch_campaign: no CUDA device is available")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    SPACE_SHARED, TIME_SHARED, scenarios, simulate, stack_scenarios, step)
from repro_torch.kernels import vm_update  # noqa: E402

CARD = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True, timeout=60,
).stdout.strip().splitlines()[0]


def profile(name: str, scn) -> dict:
    simulate(scn)                       # warm-up: build, allocator, caches
    torch.cuda.synchronize()
    syncs0 = step.host_any.syncs
    launches0 = vm_update.advance_sweep_cuda.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = simulate(scn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = vm_update.advance_sweep_cuda.launches - launches0
    avgs = prof.key_averages()
    kernels = [a for a in avgs if a.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(a.self_device_time_total for a in kernels)
    n_kernels = sum(a.count for a in kernels)
    top = sorted(kernels, key=lambda a: a.self_device_time_total, reverse=True)
    out = {
        "run": name,
        "wall_s": wall,
        "batch_steps": steps,
        "row_events": int(res.n_events.sum()),
        "host_syncs": step.host_any.syncs - syncs0,
        "kernel_launches": n_kernels,
        "launches_per_batch_step": n_kernels / max(steps, 1),
        "device_kernel_s": device_us / 1e6,
        "idle_share": 1.0 - device_us / 1e6 / wall,
        "top_kernels_ms": [[a.self_device_time_total / 1e3, a.count, a.key]
                           for a in top[:8]],
    }
    print(f"[{CARD}] {name}: wall {wall!r} s, {steps} batch steps, "
          f"{out['row_events']} row events, {out['host_syncs']} host syncs, "
          f"{n_kernels} kernel launches ({out['launches_per_batch_step']!r} "
          f"per batch step), device kernel time {device_us / 1e6!r} s, "
          f"idle share {out['idle_share']!r}", flush=True)
    for ms, count, key in out["top_kernels_ms"]:
        print(f"    {ms:10.3f} ms  {count:6d} launches  {key[:100]}")
    return out


def main() -> None:
    space = scenarios.fig9_10_scenario(SPACE_SHARED)
    time_ = scenarios.fig9_10_scenario(TIME_SHARED)
    runs = [profile("fig9_10 solo, space-shared", space),
            profile("fig9_10 campaign of 1024 rows",
                    stack_scenarios([space, time_] * 512))]
    print(json.dumps({"card": CARD, "runs": runs}))


if __name__ == "__main__":
    main()

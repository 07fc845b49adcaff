"""PyTorch operators the port's event engine dispatches per batch step, on
the CPU.

    PYTHONPATH=src python scripts/count_engine_ops.py

Steps a two-row campaign of each engine path (Fig. 9/10; reliability at
Fig. 9/10's VMs and cloudlets over a small fleet; autoscale; consolidation;
staging over an 8-DC topology with locality dispatch) through ``step.batch_event_step`` for up to 60 batch steps and counts the
aten operators each step dispatches (``TorchDispatchMode``): minimum,
median and maximum.  A step that runs the provisioning loop dispatches the
maximum.  These are counts, not times: on a card most operators are one
kernel launch, and the host's enqueue of them is what a batch step costs.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    engine, scenarios, stack_scenarios, step)


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def per_step(scn, steps: int = 60) -> list[int]:
    batch = stack_scenarios([scn, scn])
    ctx, aux = step.make_context(batch)
    max_steps = step.resolve_max_steps(batch, ctx.instruments)
    carry = (engine.init_state(batch), aux)
    counts = []
    for _ in range(steps):
        live = step.step_cond(batch, carry[0], max_steps)
        if not step.host_any(live):
            break
        with Count() as count:
            carry, _, _ = step.batch_event_step(batch, carry, ctx, live)
        counts.append(count.n)
    return counts


def main() -> None:
    gen = torch.Generator().manual_seed(0)
    runs = {
        "fig9_10": scenarios.fig9_10_scenario(0, n_hosts=100, device="cpu"),
        "reliability": scenarios.reliability_scenario(
            gen, n_dc=2, hosts_per_dc=50, n_vms=50, cl_per_vm=10,
            task_mi=1_200_000.0, mtbf_s=3e3, device="cpu"),
        "autoscale": scenarios.autoscale_scenario(
            torch.Generator().manual_seed(0), device="cpu"),
        "consolidation": scenarios.consolidation_scenario(device="cpu"),
        "staging": scenarios.staging_scenario(
            n_dc=8, hosts_per_dc=10, vms_per_dc=16, n_cloudlets=512, wave=64,
            input_mb=4096.0, locality_dispatch=True, wave_dt=1.0,
            device="cpu"),
    }
    for name, scn in runs.items():
        c = sorted(per_step(scn))
        print(f"{name}: {len(c)} batch steps, aten operators per step: min "
              f"{c[0]}, median {c[len(c) // 2]}, max {c[-1]}")


if __name__ == "__main__":
    main()

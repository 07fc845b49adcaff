"""Quickstart: build a cloud, schedule work, compare policies — the PyTorch
port's twin of ``examples/quickstart.py``.

    python examples_torch/quickstart.py [--device cpu]

The four host x VM policy pairs run one at a time, then all four as one
batch-major campaign (one ``[4, ...]`` run of the event loop, each row
bitwise its solo run).  ``--device`` defaults to the GPU; without one, pass
``--device cpu``.  ``--json PATH`` also writes the printed numbers.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    SPACE_SHARED, TIME_SHARED, Scenario, resolve_device, run_campaign,
    scenarios, simulate, stack_scenarios)
from repro_torch.kernels import vm_update  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a datacenter: 4 hosts x 2 cores x 1000 MIPS
    hosts = scenarios.uniform_hosts(1, 4, cores=2, mips=1000.0, device=dev)
    # 6 single-core VMs, 2 tasks each (20 simulated minutes per task)
    vms = scenarios.uniform_vms(6, device=dev)
    cls = scenarios.make_cloudlets(
        vm=np.tile(np.arange(6), 2),
        length_mi=np.full(12, 1_200_000.0),
        submit_t=np.repeat([0.0, 600.0], 6),
        device=dev,
    )

    def scenario(hp, vp):
        return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                        market=scenarios.uniform_market(1, device=dev),
                        policy=scenarios.make_policy(hp, vp, device=dev))

    out = {"combos": []}
    print("policy combo -> mean turnaround / makespan (seconds)")
    for hp, hname in ((SPACE_SHARED, "space"), (TIME_SHARED, "time")):
        for vp, vname in ((SPACE_SHARED, "space"), (TIME_SHARED, "time")):
            res = simulate(scenario(hp, vp), device=dev)
            row = [float(res.mean_turnaround), float(res.makespan),
                   float(res.total_cost)]
            out["combos"].append([hname, vname] + row)
            print(f"  host={hname:5s} vm={vname:5s} -> "
                  f"{row[0]:7.1f} / {row[1]:7.1f}   (cost ${row[2]:,.0f})")

    # a campaign: every combo evaluated in ONE batch-major run
    combos = [scenario(hp, vp) for hp in (0, 1) for vp in (0, 1)]
    res = run_campaign(stack_scenarios(combos), device=dev)
    makespans = res.makespan.cpu().numpy()
    out["campaign_makespans"] = makespans.tolist()
    print("campaign (batch-major) makespans:", makespans)
    out["launches"] = {"sweep": vm_update.advance_sweep_cuda.launches}
    if args.json:
        Path(args.json).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

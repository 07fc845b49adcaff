"""The paper's federation experiment as a playground — the PyTorch port's
twin of ``examples/federated_cloud.py``: sweep the peer background load and
watch the coordinator's migration decisions and the Table 1 metrics
respond.

    python examples_torch/federated_cloud.py [--device cpu]

``--device`` defaults to the GPU; without one, pass ``--device cpu``.
``--json PATH`` also writes the printed numbers.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import resolve_device, scenarios, simulate  # noqa: E402
from repro_torch.kernels import vm_update  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("peer_bg  migrations  meanTAT(fed)  makespan(fed)  TATcut%  MKcut%")
    nofed = simulate(scenarios.table1_scenario(False, device=dev), device=dev)
    out = {"no_federation": [float(nofed.mean_turnaround),
                             float(nofed.makespan)], "rows": []}
    for bg in (3, 5, 7, 9):
        fed = simulate(scenarios.table1_scenario(True, peer_background=bg,
                                                 device=dev), device=dev)
        tat_cut = 100 * (1 - float(fed.mean_turnaround)
                         / float(nofed.mean_turnaround))
        mk_cut = 100 * (1 - float(fed.makespan) / float(nofed.makespan))
        out["rows"].append([bg, int(fed.n_migrations),
                            float(fed.mean_turnaround), float(fed.makespan),
                            tat_cut, mk_cut])
        print(f"  {bg:2d}      {int(fed.n_migrations):3d}        "
              f"{float(fed.mean_turnaround):7.1f}      "
              f"{float(fed.makespan):7.1f}     {tat_cut:5.1f}   {mk_cut:5.1f}")
    print("(paper Table 1: TAT cut 52.7%, makespan cut 21.3%)")
    out["launches"] = {"sweep": vm_update.advance_sweep_cuda.launches}
    if args.json:
        Path(args.json).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

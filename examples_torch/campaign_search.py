"""Successive-halving policy search over an MTBF x ckpt x migration grid —
the PyTorch port's twin of ``examples/campaign_search.py``.

The search loop end to end: sample candidate reliability configurations,
simulate each as one row of a streamed campaign (the ``[n, ...]`` results
are never assembled: each chunk's scores fold into one ``ValuesReducer``
table and the chunk is dropped), promote the top half to a longer horizon,
and print the frontier — which checkpoint interval and migration posture
survive which failure regimes, and the single best row.

The MTBF knob is a *workload* dimension, not a ``Policy`` field: the
``instantiate`` hook turns the sampled ``mtbf_s`` column into per-candidate
``workload.host_outages`` schedules drawn from a CPU ``torch.Generator``.
Every knob (outage draws, checkpoint interval, migration threshold, the
rung's horizon) is data, so every rung runs the same operators on the same
chunk shape (simlint R5 probes exactly this loop).  The draws are not the
reference's ``jax.random`` draws, so the table and the winner are the
port's own; the same seed gives the same table on every device.

    python examples_torch/campaign_search.py [--device cpu]

``--n0`` and ``--horizons`` shrink the search; ``--json PATH`` also writes
the printed numbers.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    Outages, resolve_device, scenarios, workload)
from repro_torch.core.search import successive_halving  # noqa: E402
from repro_torch.kernels import vm_update  # noqa: E402

N0 = 16              # initial candidate population
RUNG_HORIZONS = (10_000.0, 20_000.0)   # cheap screen, then full fidelity

SPACE = {
    # Policy knobs (fields of template.policy, one value per campaign row)
    "ckpt_interval": (50.0, 200.0, 800.0, 3.0e38),     # INF = no checkpoints
    "migrate_balance_thresh": (0.75, 1e9),             # on / off
    # workload knob (routed to `instantiate` below); short MTBFs so every
    # candidate's run actually sees failures inside the horizon
    "mtbf_s": (120.0, 300.0, 700.0),
}


def instantiate(template, extras, n, generator):
    """mtbf_s column -> per-candidate seeded outage schedules."""
    d, h, k = template.outages.fail_t.shape
    dev = template.outages.fail_t.device
    rows = [workload.host_outages(generator, d, h, k, float(m), 400.0,
                                  device=dev)
            for m in extras["mtbf_s"].tolist()]
    return {"outages": Outages(
        fail_t=torch.stack([o.fail_t for o in rows]),
        repair_t=torch.stack([o.repair_t for o in rows]))}


def _fmt_thresh(v):
    return "off" if float(v) > 1e6 else f"{float(v):.2f}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--n0", type=int, default=N0)
    ap.add_argument("--horizons", type=float, nargs="+",
                    default=list(RUNG_HORIZONS))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n0 = args.n0

    template = scenarios.reliability_scenario(
        torch.Generator().manual_seed(0), federation=True,
        sensor_interval=50.0, device=dev)
    out = successive_halving(
        template, SPACE, generator=torch.Generator().manual_seed(42), n0=n0,
        fidelities=tuple(args.horizons), metric="total_cost",
        chunk_size=n0 // 2, instantiate=instantiate, device=dev,
    )

    rec = {"rungs": [], "frontier": []}
    print("rung  horizon   n   best-so-far (total_cost)")
    for i, rung in enumerate(out["rungs"]):
        v = rung["values"].cpu().numpy()
        rec["rungs"].append([float(rung["fidelity"]), len(v),
                             float(v.min())])
        print(f"{i:>4}  {rung['fidelity']:>7.0f}  {len(v):>2}   {v.min():.2f}")

    print("\nfrontier after rung 0 (survivors, cheapest first):")
    print("   id    mtbf_s  ckpt_interval  balance_thresh  total_cost")
    r0 = out["rungs"][0]
    params = {k: v.cpu().numpy() for k, v in out["params"].items()}
    values0 = r0["values"].cpu().numpy()
    order = np.argsort(values0, kind="stable")
    for j in order[: n0 // 2]:
        i = int(r0["candidates"][j])
        ckpt = params["ckpt_interval"][i]
        rec["frontier"].append([i, float(params["mtbf_s"][i]), float(ckpt),
                                float(params["migrate_balance_thresh"][i]),
                                float(values0[j])])
        print(f"  #{i:>3}  {params['mtbf_s'][i]:>8.0f}  "
              f"{'off (INF)' if ckpt > 1e30 else f'{ckpt:.0f}':>13}  "
              f"{_fmt_thresh(params['migrate_balance_thresh'][i]):>14}  "
              f"{float(values0[j]):>10.2f}")

    best = out["best_params"]
    ckpt = float(best["ckpt_interval"])
    rec["winner"] = {"index": int(out["best_index"]),
                     "mtbf_s": float(best["mtbf_s"]), "ckpt_interval": ckpt,
                     "migrate_balance_thresh":
                         float(best["migrate_balance_thresh"]),
                     "total_cost": float(out["best_value"])}
    print("\nwinner:")
    print(f"  mtbf_s                 = {float(best['mtbf_s']):.0f}")
    print(f"  ckpt_interval          = "
          f"{'off (INF)' if ckpt > 1e30 else f'{ckpt:.0f}'}")
    print(f"  migrate_balance_thresh = "
          f"{_fmt_thresh(best['migrate_balance_thresh'])}")
    print(f"  total_cost             = {float(out['best_value']):.2f}")
    rec["launches"] = {"sweep": vm_update.advance_sweep_cuda.launches}
    if args.json:
        Path(args.json).write_text(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()

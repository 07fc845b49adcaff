"""Serving demo: continuous batching with the CloudSim predictive scheduler
re-planning the admission policy from live queue simulations — the PyTorch
port's twin of ``examples/serve_model.py``.

    python examples_torch/serve_model.py [--device cpu]

The smoke internlm2 model, the reference's own (16-wide heads), gets
random weights from a seeded ``torch.Generator`` (not the reference's ``jax.random`` draw, so the
generated tokens are the port's own; the finishes depend only on the
requests' lengths).  On the card every prefill runs the hand-written flash
kernel and every re-plan simulates the queue with the advance-sweep kernel.
``--device`` defaults to the GPU; without one, pass ``--device cpu``.
``--json PATH`` also writes the printed numbers.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import resolve_device  # noqa: E402
from repro_torch.kernels import flash_attention, vm_update  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("internlm2-1.8b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))

    eng = ServingEngine(model, params, n_slots=2, max_len=96, replan_every=4,
                        device=dev)
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(rng.integers(0, cfg.vocab, size=8 + 4 * (i % 3)),
                   max_new_tokens=6 + 2 * (i % 2))

    out = {"finished": [], "d_head": cfg.d_head}
    while any(not r.done for r in eng.requests):
        info = eng.step()
        if info["finished"]:
            policy = "space" if eng.sched.policy == 0 else "time"
            out["finished"].append([info["step"], info["finished"],
                                    info["active"], policy])
            print(f"step {info['step']:3d}: finished {info['finished']} "
                  f"(active={info['active']}, policy={policy})")

    tats = [r.finish_time - r.arrival for r in eng.requests]
    out.update(served=len(eng.requests), mean_turnaround=float(np.mean(tats)),
               makespan=eng.steps,
               launches={"flash": flash_attention.flash_attention_cuda.launches,
                         "sweep": vm_update.advance_sweep_cuda.launches})
    print(f"all {len(eng.requests)} requests served; "
          f"mean turnaround {np.mean(tats):.1f} engine steps, "
          f"makespan {eng.steps} steps")
    if args.json:
        Path(args.json).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

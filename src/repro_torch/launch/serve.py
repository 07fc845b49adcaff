"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> [--smoke]
[--device cpu]``.

The port of ``repro.launch.serve``: boots the continuous-batching engine
(serving/engine.py) with the CloudSim predictive scheduler, feeds it a
synthetic request trace, and reports per-request turnaround + makespan in
engine steps.  Weights are random, drawn from a seeded generator.  It runs
on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine


def run_serving(
    cfg,
    *,
    n_requests: int = 8,
    n_slots: int = 2,
    max_len: int = 96,
    prompt_len: int = 16,
    max_new_tokens: int = 16,
    policy: int = 0,
    replan_every: int = 0,
    seed: int = 0,
    device=None,
) -> dict:
    dev = resolve_device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    eng = ServingEngine(model, params, n_slots=n_slots, max_len=max_len,
                        policy=policy, replan_every=replan_every, device=dev)
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        eng.submit(rng.integers(0, cfg.vocab, size=prompt_len),
                   max_new_tokens=max_new_tokens)
    reqs = eng.run_until_drained()
    tats = [r.finish_time - r.arrival for r in reqs if r.done]
    return {
        "all_done": all(r.done for r in reqs),
        "mean_turnaround_steps": float(np.mean(tats)) if tats else float("nan"),
        "makespan_steps": eng.steps,
        "final_policy": eng.sched.policy,
        "requests": reqs,
        "stats": dict(eng.stats),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--policy", type=int, default=0,
                    help="0=space-shared 1=time-shared")
    ap.add_argument("--replan-every", type=int, default=0,
                    help=">0: re-simulate the queue every N steps and switch "
                         "policy to the predicted-better one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    out = run_serving(cfg, n_requests=args.requests, n_slots=args.slots,
                      max_len=args.max_len, policy=args.policy,
                      replan_every=args.replan_every,
                      device=args.device)
    print(f"[serve] done={out['all_done']} "
          f"meanTAT={out['mean_turnaround_steps']:.1f} steps "
          f"makespan={out['makespan_steps']} steps "
          f"policy={out['final_policy']}")


if __name__ == "__main__":
    main()

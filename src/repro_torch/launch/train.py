"""Training entry point: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu] [options]``.

The port of ``repro.launch.train``: random parameters from a seeded
generator, the Markov-chain token pipeline, microbatched AdamW steps,
periodic async checkpoints and resume from the latest one.  It runs on the
GPU unless ``device="cpu"`` (``--device cpu``) is given; without a GPU it
raises.  On the card a Mamba2 layer's SSD scan is the hand-written CUDA
kernel (``kernels/ssd_scan.py``), and attention runs the flash forward and
backward kernels (``kernels/flash_attention.py``, through
``FlashAttention``); with ``cfg.remat`` (every full config) each period is
checkpointed, so the forward runs twice per attention layer per step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt import AsyncSaver, latest_step, restore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import resolve_device
from repro_torch.data import ShardedLoader
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.models import build_model
from repro_torch.train import OptConfig, adamw_init, make_train_step


class InjectedFailure(RuntimeError):
    """The failure ``run_training(fail_at_step=...)`` raises: the one error
    ``launch.elastic.ElasticRunner`` treats as a lost node.  A CUDA launch
    fault or an out-of-memory error is a ``RuntimeError`` too, and must
    not be retried as one."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(
    cfg,
    *,
    steps: int = 200,
    global_batch: int = 8,
    seq_len: int = 128,
    lr: float = 3e-4,
    microbatches: int = 1,
    ckpt_dir: str | None = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    seed: int = 0,
    fail_at_step: int | None = None,   # fault-injection hook (elastic)
    device=None,
) -> dict:
    """Train ``cfg`` for ``steps`` steps.  Returns the reference's
    ``losses``, ``final_loss``, ``params`` and ``steps_run``, and also
    ``grad_norms``, ``step_seconds`` (host clock per step, each ending when
    its loss is read), ``tokens_per_sec`` (over the steps after the first,
    which pays for building and loading kernels; over the first if it is
    the only one), ``ssd_launches``, ``ssd_bwd_launches``,
    ``flash_launches`` and ``flash_bwd_launches`` (calls of the SSD forward
    and backward kernels and of the flash forward and backward kernels in
    the run)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                        total_steps=steps)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    opt_state = adamw_init(params)
    start_step = 0

    if ckpt_dir and latest_step(ckpt_dir) is not None:
        (params, opt_state), start_step = restore(ckpt_dir,
                                                  (params, opt_state))
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(model, opt_cfg, microbatches)
    loader = ShardedLoader(cfg.vocab, global_batch, seq_len, seed=seed)
    saver = AsyncSaver()
    kernels = (ssd_scan_cuda, ssd_scan_bwd_cuda, flash_attention_cuda,
               flash_attention_bwd_cuda)
    launches0 = [fn.launches for fn in kernels]

    losses: list[float] = []
    grad_norms: list[float] = []
    step_seconds: list[float] = []
    try:
        for step, batch in zip(range(start_step, steps), loader):
            if fail_at_step is not None and step == fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, tb)
            losses.append(float(metrics["loss"]))      # waits for the step
            grad_norms.append(float(metrics["grad_norm"]))
            step_seconds.append(time.perf_counter() - t0)
            if log_every and step % log_every == 0:
                print(
                    f"[train] step={step} loss={losses[-1]:.4f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"gnorm={grad_norms[-1]:.3f} "
                    f"step_s={step_seconds[-1]:.3f}",
                    flush=True,
                )
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                saver.save(ckpt_dir, step + 1, (params, opt_state))
    finally:
        loader.close()
        saver.wait()
    if ckpt_dir:
        saver.save(ckpt_dir, steps, (params, opt_state))
        saver.wait()
    _sync(dev)
    timed = step_seconds[1:] or step_seconds
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "params": params,
        "steps_run": len(losses),
        "grad_norms": grad_norms,
        "step_seconds": step_seconds,
        "tokens_per_sec": (global_batch * seq_len * len(timed) / sum(timed)
                           if timed else float("nan")),
        **{name: fn.launches - n0 for name, fn, n0 in zip(
            ("ssd_launches", "ssd_bwd_launches", "flash_launches",
             "flash_bwd_launches"), kernels, launches0)},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    out = run_training(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, lr=args.lr, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device,
    )
    print(f"[train] done: {out['steps_run']} steps, "
          f"final loss {out['final_loss']:.4f} "
          f"(ln V = {np.log(cfg.vocab):.2f}), "
          f"{out['tokens_per_sec']:.0f} tokens/s, "
          f"{out['ssd_launches']} SSD, {out['ssd_bwd_launches']} SSD "
          f"backward, {out['flash_launches']} flash and "
          f"{out['flash_bwd_launches']} flash backward kernel launches")


if __name__ == "__main__":
    main()

"""End-to-end driver: train a ~100M-parameter LM for a few dozen steps on the
synthetic Markov pipeline, with periodic async checkpointing — the PyTorch
port's twin of ``examples/train_100m.py``.

    python examples_torch/train_100m.py [--device cpu] [--steps 300]

(A scaled-down internlm2-family config: 12L x 768 with an 8192 vocab ~= 98M
params, f32.  On the card attention runs the hand-written flash forward and
backward kernels (their f32 variants); on the CPU their plain versions, so
pass a small ``--steps``, ``--global-batch`` and ``--seq-len`` there.)

The initial weights are drawn by a CPU ``torch.Generator`` and written as
the checkpoint of step 0, from which ``run_training`` resumes: a CUDA
generator draws other numbers than a CPU one from the same seed, so this is
what makes one seed one model on every device (the reference's
``jax.random`` draw is the same everywhere, but not the port's).
``--device`` defaults to the GPU; without one, pass ``--device cpu``.  The
checkpoints go to a temporary directory unless ``--ckpt-dir`` is given.
``--json PATH`` also writes the printed numbers and every step's loss.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.ckpt import latest_step, save  # noqa: E402
from repro_torch.core import resolve_device  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train import adamw_init  # noqa: E402


def config_100m() -> ModelConfig:
    return ModelConfig(
        name="demo-98m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab=8192, remat=False, dtype="float32",
    )


def initial_checkpoint(cfg: ModelConfig, ckpt_dir: str, seed: int = 0) -> None:
    """Step 0 in ``ckpt_dir``: weights from a CPU generator and fresh AdamW
    moments (a directory that holds a checkpoint already is resumed
    instead)."""
    if latest_step(ckpt_dir) is None:
        params = build_model(cfg).init(torch.Generator().manual_seed(seed))
        save(ckpt_dir, 0, (params, adamw_init(params)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_100m()
    n_params = cfg.param_count()
    print(f"[100m] params = {n_params / 1e6:.1f}M, ln(V) = "
          f"{np.log(cfg.vocab):.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        initial_checkpoint(cfg, ckpt_dir)
        out = run_training(
            cfg, steps=args.steps, global_batch=args.global_batch,
            seq_len=args.seq_len, lr=6e-4, ckpt_dir=ckpt_dir,
            ckpt_every=50, log_every=10, device=dev,
        )
    first, last = out["losses"][0], out["final_loss"]
    print(f"[100m] loss {first:.3f} -> {last:.3f} over {out['steps_run']} steps")
    rec = {"n_params": n_params, "losses": out["losses"], "final_loss": last,
           "steps_run": out["steps_run"],
           "launches": {"flash": out["flash_launches"],
                        "flash_bwd": out["flash_bwd_launches"]}}
    if args.json:
        Path(args.json).write_text(json.dumps(rec))
    assert last < first, "model did not learn"
    return rec


if __name__ == "__main__":
    main()

"""AdamW + warmup-cosine schedule + global-norm clipping: the port of
``repro.train.optimizer``.

The optimizer state mirrors the parameter tree (two moment trees) plus a
0-d int32 ``step``, as in the reference, so a JAX state carries across with
``convert.opt_state_from_arrays`` and checkpoints share one layout.  The
reference's choices are kept exactly: the schedule reads the step *before*
the increment; clipping is by the global norm in f32; weight decay is
decided by the leaf's own dict key (no decay for names holding ``norm`` or
ending in ``_b``, so ``A_log``, ``D`` and ``dt_bias`` are decayed and
``conv_b`` is not); the update is done in f32 and cast back to the
parameter's dtype.  Scalars stay 0-d tensors on the parameters' device, so a
step makes no host synchronisation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import Tensor

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(cfg: OptConfig) -> Callable[[Tensor], Tensor]:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``;
    in f32 on the step's device."""
    def lr(step: Tensor) -> Tensor:
        step = torch.as_tensor(step).float()
        warm = cfg.lr * step / max(cfg.warmup_steps, 1)
        t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        t = t.clamp(0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)

    return lr


def adamw_init(params: Any) -> dict:
    device = tree.leaves(params)[0].device
    return {
        "mu": tree.map_tree(torch.zeros_like, params),
        "nu": tree.map_tree(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(grads: Any) -> Tensor:
    """``sqrt(sum of squares)`` over every leaf in f32, leaves added in the
    reference's order."""
    total = None
    for leaf in tree.leaves(grads):
        sq = leaf.float().square().sum()
        total = sq if total is None else total + sq
    return total.sqrt()


def _decay_mask(path: tuple) -> bool:
    """Weight decay on matrices only (no norms / biases / scalars), by the
    leaf's own key."""
    name = str(path[-1])
    return "norm" not in name and not name.endswith("_b")


def adamw_update(grads: Any, state: dict, params: Any,
                 cfg: OptConfig) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics with ``grad_norm`` and
    ``lr``)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_schedule(cfg)(state["step"])
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(path, p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g.square()
        delta = (mu / b1c) / ((nu / b2c).sqrt() + cfg.eps)
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = tree.map_with_path(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": _pick(out, 1), "nu": _pick(out, 2), "step": step}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(out: dict, i: int) -> dict:
    """Item ``i`` of every ``(param, mu, nu)`` leaf of a dict tree."""
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in out.items()}

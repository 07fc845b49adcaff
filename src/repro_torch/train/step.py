"""Microbatched training step: the port of ``repro.train.step``.

``make_train_step(model, opt_cfg, microbatches)`` returns
``train_step(params, opt_state, batch) -> (params', opt_state', metrics)``,
functional like the reference's: the inputs are not modified.  Gradients
come from ``torch.autograd.grad`` over the parameter leaves, taken as
leaf tensors that require a gradient for the one call; the tree itself
stays plain tensors.  Gradient accumulation splits the batch into
``microbatches`` sequential slices (the reference's ``lax.scan`` becomes a
Python loop), adds their gradients in f32 and averages, with one weight
update per step.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from repro_torch import tree
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update


def _split_mb(batch: dict, m: int) -> list[dict]:
    """``m`` slices of the batch axis (``positions [3, B, S]``: axis 1)."""
    def split(k, x):
        axis = 1 if k == "positions" and x.dim() == 3 else 0
        b = x.shape[axis]
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        return x.chunk(m, dim=axis)

    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(m)]


def value_and_grad(model, params: Any, batch: dict) -> tuple[Tensor, Any]:
    """(loss, gradients with the tree of ``params``) of ``model.loss``."""
    paths = [p for p, _ in tree.leaves_with_path(params)]
    live = tree.map_tree(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = model.loss(live, batch)
        leaves = tree.leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach gets zeros, as under jax.grad
    by_path = {p: torch.zeros_like(x) if g is None else g
               for p, x, g in zip(paths, leaves, grads)}
    return loss.detach(), tree.map_with_path(lambda p, _: by_path[p], params)


def make_train_step(model, opt_cfg: OptConfig, microbatches: int = 1):
    def train_step(params, opt_state, batch: dict[str, Any]):
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            device = tree.leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree.map_tree(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for mb in _split_mb(batch, microbatches):
                l, g = value_and_grad(model, params, mb)
                loss = loss + l
                grads = tree.map_tree(torch.add, grads, g)
            loss = loss / microbatches
            grads = tree.map_tree(lambda g: g / microbatches, grads)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(model, generator: torch.Generator, opt_cfg: OptConfig):
    """Random parameters from ``generator`` and a fresh optimizer state."""
    params = model.init(generator)
    return params, adamw_init(params)

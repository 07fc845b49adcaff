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

import contextlib
from typing import Any

import torch
from torch import Tensor

from repro_torch import tree
from repro_torch.dist.act_sharding import is_dtensor
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update


def _split_mb(batch: dict, m: int) -> list[dict]:
    """``m`` slices of the batch axis (``positions [3, B, S]``: axis 1); a
    ``DTensor``'s slices keep its placements (``_split_rows``)."""
    def split(k, x):
        axis = 1 if k == "positions" and x.dim() == 3 else 0
        if x.shape[axis] % m:
            raise ValueError(f"batch {x.shape[axis]} not divisible by "
                             f"microbatches {m}")
        if is_dtensor(x):
            return _split_rows(x, axis, m)
        return x.chunk(m, dim=axis)

    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(m)]


def _split_rows(x, axis: int, m: int) -> list:
    """The ``m`` microbatches of a ``DTensor`` batch, each placed as ``x``:
    microbatch i is rows [i M, (i + 1) M) of ``axis`` (M = rows / m), as on
    one device, and the rank that holds block r of ``x``'s rows holds block
    r of each microbatch.  One all-to-all over the ranks that split the rows
    sends each row once, to the rank whose block holds it; nothing is
    gathered whole."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import spmd

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names[i] for i, pl in enumerate(x.placements)
                  if pl.is_shard(axis))
    n, mb = spmd.axis_size(mesh, names), x.shape[axis] // m
    if mb % n:
        raise ValueError(f"a microbatch of {mb} rows does not divide over "
                         f"the {n} ranks that split the batch")
    local = x.to_local()
    if n > 1:
        held, k = x.shape[axis] // n, mb // n
        r = spmd.axis_index(mesh, names)

        def to(g):             # the rank whose microbatch block holds row g
            return g % mb // k

        dest = [to(g) for g in range(r * held, (r + 1) * held)]
        order = sorted(range(held), key=dest.__getitem__)
        send = [dest.count(j) for j in range(n)]
        recv = [sum(to(g) == r for g in range(j * held, (j + 1) * held))
                for j in range(n)]
        rows = local.index_select(
            axis, torch.tensor(order, device=local.device))
        # rows arrive by sender, so in global order: microbatch-major
        local = funcol.wait_tensor(funcol.all_to_all_single(
            rows.movedim(axis, 0).contiguous(), recv, send,
            spmd.axis_group(mesh, names))).movedim(0, axis)
    return [DTensor.from_local(part, mesh, x.placements, run_check=False)
            for part in local.chunk(m, dim=axis)]


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


def make_train_step(model, opt_cfg: OptConfig, microbatches: int = 1,
                    param_shardings: Any = None):
    """The step.  ``param_shardings`` is the tree of ``DTensor`` placement
    tuples of the parameters (``dist.named(mesh, param_pspec_tree(...))``):
    each microbatch's gradients and the f32 accumulator are redistributed
    to it, the reference's ``with_sharding_constraint``, so AdamW reads
    gradients laid out as their parameters.  None constrains nothing, as
    in the reference."""
    def constrain(grads):
        if param_shardings is None:
            return grads
        return tree.map_tree(_place, grads, param_shardings)

    def train_step(params, opt_state, batch: dict[str, Any]):
        sharded = is_dtensor(tree.leaves(params)[0])
        if param_shardings is not None and not sharded:
            raise ValueError("param_shardings needs DTensor parameters")
        with _replicating(sharded):
            if microbatches == 1:
                loss, grads = value_and_grad(model, params, batch)
                grads = constrain(grads)
            else:
                device = tree.leaves(params)[0].device
                loss = torch.zeros((), dtype=torch.float32, device=device)
                grads = constrain(tree.map_tree(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))
                for mb in _split_mb(batch, microbatches):
                    l, g = value_and_grad(model, params, mb)
                    loss = loss + l
                    grads = constrain(tree.map_tree(torch.add, grads,
                                                    constrain(g)))
                loss = loss / microbatches
                grads = tree.map_tree(lambda g: g / microbatches, grads)
            params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _place(x, placements):
    """``x`` redistributed to ``placements`` (a plain tensor unchanged)."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, tuple(placements))


def _replicating(sharded: bool):
    """Plain tensors among ``DTensor``s (scalars of the schedule, position
    tables built from shapes) taken as replicated values while a sharded
    step runs; nothing otherwise."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def init_train_state(model, generator: torch.Generator, opt_cfg: OptConfig):
    """Random parameters from ``generator`` and a fresh optimizer state."""
    params = model.init(generator)
    return params, adamw_init(params)

"""Activation sharding: a context, a state query and one constraint helper
(the port of ``repro.dist.act_sharding``).

Model code names *logical* axes (``"batch"``, ``"seq"``, ``"model"``,
None), never mesh axes.  Outside an ``activation_shardings`` context
``shard_act`` returns its argument itself: the one-device path adds no
operation.  Inside, it resolves the logical axes against the active (mesh,
rules) with the parameter rules' divisibility fallback, and redistributes a
``DTensor`` to those placements; a plain tensor passes unchanged.

``gather_fsdp`` is the other half of the parameters' layout: a weight
sharded over the FSDP axes (``"data"``) is gathered over them where it is
used, after its cast to the compute dtype, as the reference's memory model
assumes ("bf16 weight shard, cast live during compute"); its gradient
comes back reduce-scattered onto the shard.  A plain tensor passes
unchanged.

``current_state()`` exposes the raw ``(mesh, rules, sequence_parallel)``
triple: ``models/moe.py`` picks its expert-parallel schedule from it and
``models/attention.py`` switches to the length-sharded decode.  The state
is a module global, set for the calls made inside the context and restored
on exit.
"""
from __future__ import annotations

from contextlib import contextmanager

from repro_torch.dist.sharding import (
    P, Rules, axis_sizes, placements, resolve_dim, rules_for_mesh)
from repro_torch.dist.spmd import grad_hook, is_dtensor

_STATE: tuple | None = None        # (mesh, Rules, sequence_parallel)


def current_state() -> tuple | None:
    """The active ``(mesh, rules, sequence_parallel)`` triple, or None."""
    return _STATE


@contextmanager
def activation_shardings(mesh, rules: Rules | None = None, *,
                         sequence_parallel: bool = False,
                         strategy: str = "2d"):
    """Activate activation sharding for the calls made inside."""
    global _STATE
    if rules is None:
        rules = rules_for_mesh(mesh, strategy)
    prev = _STATE
    _STATE = (mesh, rules, bool(sequence_parallel))
    try:
        yield _STATE
    finally:
        _STATE = prev


def act_spec(shape, logical_axes, state) -> P:
    """The spec of an activation of ``shape`` with ``logical_axes`` under
    ``state``: ``"batch"`` the data axes, ``"model"`` the tensor-parallel
    axis, ``"seq"`` the tensor-parallel axis under sequence parallelism,
    None replicated."""
    mesh, rules, seq_par = state
    sizes = axis_sizes(mesh)
    used: set = set()
    entries = []
    for dim, logical in zip(shape, logical_axes):
        if logical is None:
            entries.append(None)
        elif logical == "batch":
            entries.append(resolve_dim(dim, rules.batch, sizes, used))
        elif logical == "model":
            entries.append(resolve_dim(dim, (rules.tp,), sizes, used))
        elif logical == "seq":
            cand = (rules.tp,) if seq_par else ()
            entries.append(resolve_dim(dim, cand, sizes, used))
        else:
            raise ValueError(
                f"unknown logical activation axis {logical!r}: "
                "'batch' | 'seq' | 'model' | None")
    return P(*entries)


def shard_act(x, logical_axes):
    """``x`` laid out by the active sharding; ``x`` itself when no state
    is set or when it is a plain tensor (one rank's whole value).  As
    ``with_sharding_constraint`` does, the constraint holds for the
    gradient too: the cotangent is redistributed to the same placements
    (a partial sum over ``"model"`` is reduced where the activation is)."""
    state = _STATE
    if state is None:
        return x
    spec = act_spec(tuple(x.shape), logical_axes, state)
    if not is_dtensor(x) or all(e is None for e in spec):
        return x
    want = placements(state[0], spec)
    if tuple(x.placements) != want:
        x = x.redistribute(state[0], want)
    return _constrain_grad(x, want)


def _constrain_grad(x, want):
    """``x``, whose cotangent is redistributed to the placements ``want``."""
    def place(g):
        return g if tuple(g.placements) == want else \
            g.redistribute(g.device_mesh, want)
    return grad_hook(x, place)


def gather_fsdp(w):
    """``w`` with its shards over the FSDP mesh axes gathered (the active
    rules' ``fsdp`` axes; outside a context every axis but ``"model"``);
    ``w`` itself when it is a plain tensor or holds no such shard."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = tuple(w.device_mesh.mesh_dim_names)
    fsdp = (_STATE[1].fsdp if _STATE is not None
            else tuple(a for a in names if a != "model"))
    want = tuple(Replicate() if names[i] in fsdp and pl.is_shard() else pl
                 for i, pl in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def split_last(x, n: int, d: int):
    """``x [..., n * d]`` -> ``[..., n, d]`` (heads, groups).  A ``DTensor``
    whose last dim is split over a mesh dim that does not divide ``n`` is
    first gathered over that mesh dim: the split could not keep whole
    heads on each rank."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh, last = x.device_mesh, x.dim() - 1
        want = tuple(Replicate() if pl.is_shard(last) and n % mesh.size(i)
                     else pl for i, pl in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(mesh, want)
    return x.reshape(*x.shape[:-1], n, d)


def merge_last(x):
    """``x [..., n, d]`` -> ``[..., n * d]``.  On a ``DTensor`` the
    gradient is held to the merged value's placements: a cotangent split
    over the merged dim by a mesh dim that does not divide ``n`` could not
    be unflattened back to whole heads."""
    y = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if is_dtensor(y):
        y = _constrain_grad(y, tuple(y.placements))
    return y

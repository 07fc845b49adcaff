"""Activation sharding: a context, a state query and one constraint helper
(the port of ``repro.dist.act_sharding``).

Model code names *logical* axes (``"batch"``, ``"seq"``, ``"model"``,
None), never mesh axes.  Outside an ``activation_shardings`` context
``shard_act`` returns its argument itself: the one-device path adds no
operation.  Inside, it resolves the logical axes against the active (mesh,
rules) with the parameter rules' divisibility fallback, and redistributes a
``DTensor`` to those placements; a plain tensor passes unchanged.

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
    is set or when it is a plain tensor (one rank's whole value)."""
    state = _STATE
    if state is None:
        return x
    spec = act_spec(tuple(x.shape), logical_axes, state)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or all(e is None for e in spec):
        return x
    return x.redistribute(state[0], placements(state[0], spec))

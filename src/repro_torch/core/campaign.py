"""Campaigns: many scenarios as one batch-major run (DESIGN.md §5, §10).

The port of ``stack_scenarios`` and ``broadcast_campaign`` from
``repro.core.campaign``.  ``engine.simulate`` runs a stacked campaign
natively, each row bitwise its solo run.  Chunking, reducers and sharding
belong to a later slice.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from repro_torch.core.entities import Scenario, TensorTree


def _stack(items: list, path: str):
    first = items[0]
    if any((x is None) != (first is None) for x in items):
        raise ValueError(
            f"stack_scenarios: {path} is set in some scenarios and None in "
            "others; attachments must agree across a campaign")
    if first is None:
        return None
    if isinstance(first, Tensor):
        return torch.stack(items)
    if isinstance(first, tuple):
        kinds = [tuple(type(x) for x in t) for t in items]
        if any(k != kinds[0] for k in kinds):
            raise ValueError(
                f"stack_scenarios: {path} differ across the campaign "
                f"({kinds[0]} vs another row's); every row needs the same "
                "instrument types in the same order")
        return tuple(_stack([t[i] for t in items], f"{path}[{i}]")
                     for i in range(len(first)))
    if not isinstance(first, TensorTree):
        return first    # an instrument without tensor fields
    return dataclasses.replace(first, **{
        f.name: _stack([getattr(x, f.name) for x in items], f"{path}.{f.name}")
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), (Tensor, TensorTree, tuple))
        or getattr(first, f.name) is None
    })


def stack_scenarios(scenarios: list[Scenario]) -> Scenario:
    """Stack same-shape scenarios along a new leading campaign axis.

    ``max_steps`` is static and must agree; so must the structure (a power
    model or an outage schedule on every row or on none, and the same
    instrument types in the same order).  Instrument tensor fields stack
    like any other leaf, so a campaign may vary them per row.
    """
    if not scenarios:
        raise ValueError("empty campaign")
    ref = scenarios[0]
    for i, scn in enumerate(scenarios[1:], start=1):
        if scn.max_steps != ref.max_steps:
            raise ValueError(
                f"stack_scenarios: scenario {i} has max_steps={scn.max_steps} "
                f"but scenario 0 has {ref.max_steps}; static fields must "
                "agree across a campaign")
    return _stack(list(scenarios), "scenario")


def broadcast_campaign(template: Scenario, n: int, **overrides) -> Scenario:
    """Broadcast one scenario to an ``n``-row campaign, substituting the
    batched subtrees that vary (``cloudlets=``, ``policy=``, ... with
    leading dimension ``n`` on every leaf)."""
    batched = template.map(lambda x: x.expand((n,) + tuple(x.shape)).clone())
    for name, sub in overrides.items():
        leaves = sub.leaves() if isinstance(sub, TensorTree) else [sub]
        for leaf in leaves:
            if leaf.dim() == 0 or leaf.shape[0] != n:
                raise ValueError(
                    f"broadcast_campaign: override {name!r} has a leaf of "
                    f"shape {tuple(leaf.shape)}; every leaf needs leading "
                    f"dim {n}")
    return batched.replace(**overrides)

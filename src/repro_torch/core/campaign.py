"""Campaigns: many scenarios as one batch-major run, streamed in chunks
(the port of ``repro.core.campaign``, DESIGN.md §10, §12).

``engine.simulate`` runs a stacked campaign natively, each row bitwise its
solo run.  ``run_campaign(batched, chunk_size=...)`` slices the campaign
axis into fixed-size chunks (the trailing chunk padded by repeating the
last row, then trimmed), so working memory is one chunk's; with
``reduce=`` each chunk's result folds into fixed-shape
``reducers.CampaignReducer`` carries and is dropped, so the ``[N, ...]``
result is never assembled and a sweep may outgrow the card's memory (keep
the stacked campaign on the host: each chunk moves to ``device`` when it
runs).  ``core/search.py`` drives it for policy search.

``run_campaign(..., mesh=, axis=)`` (and ``run_campaign_sharded``) shards
each chunk's rows over ``mesh[axis]`` of a ``DeviceMesh``, one process per
rank: each rank moves only its rows to its device and simulates them, and
the chunk's result is all-gathered over the axis, so every rank holds it
(and folds it, with ``reduce=``).  Shards never communicate inside a
simulation, and every row stays bitwise its solo run.  ``lower_chunk``
reads XLA's HLO and ``donate`` hands buffers to XLA; neither has a
counterpart here: a chunk's tensors are freed when the chunk goes out of
scope.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from repro_torch.core.engine import simulate
from repro_torch.core.entities import (
    Scenario, SimResult, TensorTree, resolve_device)
from repro_torch.core.reducers import CampaignReducer
from repro_torch.dist import spmd
from repro_torch.dist.sharding import (
    axis_sizes, campaign_pspec_tree, spec_leaves)


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


def _campaign_len(batched: Scenario) -> int:
    return batched.policy.horizon.shape[0]


def _chunk(batched: Scenario, lo: int, size: int) -> Scenario:
    """Rows ``lo .. lo + size`` of the campaign, padded to ``size`` rows by
    repeating the last row."""
    def cut(x: Tensor) -> Tensor:
        c = x[lo:lo + size]
        short = size - c.shape[0]
        if short:
            c = torch.cat([c, x[-1:].expand((short,) + tuple(x.shape[1:]))])
        return c
    return batched.map(cut)


def _check_mesh(mesh, axis: str, rows: int) -> None:
    """The reference's checks: the axis exists and divides the rows each
    run shards."""
    sizes = axis_sizes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh has no axis {axis!r}; axes: "
                         f"{tuple(mesh.mesh_dim_names)}")
    if rows % sizes[axis]:
        raise ValueError(f"chunk of {rows} rows is not divisible by mesh "
                         f"axis {axis!r} (size {sizes[axis]})")


def _simulate(chunk: Scenario, dev, mesh, axis: str) -> SimResult:
    """``simulate`` of a chunk on ``dev``; with a mesh, of this rank's rows
    (its block of ``mesh[axis]``), the result all-gathered over the axis."""
    if mesh is None:
        return simulate(chunk, device=dev)
    if any(s and s[0] is None
           for s in spec_leaves(campaign_pspec_tree(chunk, mesh, axis))):
        raise ValueError(
            f"campaign axis of {_campaign_len(chunk)} rows is not divisible "
            f"by mesh axis {axis!r} (size {axis_sizes(mesh)[axis]}); pick a "
            "chunk_size that divides")
    n, k = axis_sizes(mesh)[axis], _campaign_len(chunk)
    lo = spmd.axis_index(mesh, axis) * (k // n)
    mine = simulate(chunk.map(lambda x: x[lo:lo + k // n]).to(dev),
                    device=dev)
    group = spmd.axis_group(mesh, axis)
    return mine.map(lambda x: spmd._gather(x, group, n, 0))


def _normalize_reduce(reduce):
    """-> (keys | None, tuple of reducers, single)."""
    if isinstance(reduce, CampaignReducer):
        return None, (reduce,), True
    if isinstance(reduce, dict):
        for k, r in reduce.items():
            if not isinstance(r, CampaignReducer):
                raise TypeError(f"reduce[{k!r}] is not a CampaignReducer")
        return tuple(reduce), tuple(reduce.values()), False
    raise TypeError(
        f"reduce must be a CampaignReducer or a dict of them, got {reduce!r}")


def _run_reduced(batched: Scenario, chunk: int, reduce, dev, mesh,
                 axis: str):
    keys, reducers, single = _normalize_reduce(reduce)
    n = _campaign_len(batched)
    carries = None
    for lo in range(0, n, chunk):
        scn = _chunk(batched, lo, chunk)
        if mesh is None:
            scn = scn.to(dev)
        res = _simulate(scn, dev, mesh, axis)
        scn = scn.to(dev)
        if carries is None:
            carries = tuple(r.init(scn, res) for r in reducers)
        index = lo + torch.arange(chunk, dtype=torch.int32, device=dev)
        valid = index < n
        carries = tuple(r.fold(c, scn, res, index, valid)
                        for r, c in zip(reducers, carries))
        del scn, res
    outs = tuple(r.finalize(c) for r, c in zip(reducers, carries))
    if keys is not None:
        return dict(zip(keys, outs))
    return outs[0] if single else outs


def run_campaign(batched: Scenario, chunk_size: int | None = None,
                 reduce=None, device=None, mesh=None, axis: str = "data"):
    """Run a stacked campaign; the front door for every sweep size.

    ``chunk_size`` bounds working memory: the campaign axis runs in chunks
    of that many rows (the trailing chunk padded by repeating the last row,
    then trimmed), each on ``device`` (``None``: the GPU).  Every row is
    bitwise its solo run whatever the chunking.  ``reduce`` (a
    ``CampaignReducer`` or a dict of them) folds each chunk's result into
    fixed-shape carries instead and returns only the finalized summary (a
    dict mirroring ``reduce``); integer folds, ``ArgBestReducer`` and
    ``ValuesReducer`` are the same for every chunk size.

    ``mesh`` (a ``DeviceMesh``; call on every rank) shards each chunk's rows
    over ``mesh[axis]``, which must exist and divide the chunk (or the
    whole campaign when unchunked); every rank returns the whole result.
    The reference's ``donate`` has no counterpart (see the module
    docstring).
    """
    if chunk_size is not None and chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    dev = resolve_device(device)
    n = _campaign_len(batched)
    if mesh is not None:
        _check_mesh(mesh, axis, chunk_size or n)
    if reduce is not None:
        return _run_reduced(batched, chunk_size or n, reduce, dev, mesh, axis)
    if chunk_size is None:
        return _simulate(batched, dev, mesh, axis)
    parts = [_simulate(_chunk(batched, lo, chunk_size), dev, mesh, axis)
             for lo in range(0, n, chunk_size)]
    return SimResult(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts])[:n]
        for f in dataclasses.fields(SimResult)})


def run_campaign_sharded(batched: Scenario, mesh, axis: str = "data",
                         device=None) -> SimResult:
    """The one-argument spelling of ``run_campaign(batched, mesh=mesh,
    axis=axis)``: each rank simulates its rows, with no communication
    inside a simulation."""
    return run_campaign(batched, mesh=mesh, axis=axis, device=device)

"""SPMD over a ``DeviceMesh``: one process per rank, collectives on the
mesh's sub-groups (the port's counterpart of ``shard_map``).

``shard_map(fn, mesh, in_specs, out_specs)`` takes global tensors, the same
value on every rank, cuts each rank's block by its mesh coordinates, runs
``fn`` on the blocks and gathers the outputs back to global tensors.  Inside
``fn`` the collectives below run over named mesh axes, as ``jax.lax``'s do
inside ``shard_map``: ``psum``, ``pmean``, ``all_gather`` (tiled) and
``psum_scatter`` (tiled), and ``axis_index``.

Gradients flow as through ``shard_map`` without its replication check:
each collective's backward is its transpose (``psum`` -> ``psum``,
``all_gather`` -> ``psum_scatter`` and back), the gathered output's
gradient reaches each rank as its block divided by the ranks that hold the
same block (the mesh axes its spec does not name), and an input's gradient
is the sum over all ranks of their blocks' gradients, so every rank ends
with the whole gradient.  ``torch.distributed.nn.functional`` has the same
transposes, but its ``all_gather`` backward scatters by global rank and
fails on a sub-group of a gloo world, so the port keeps its own four.

On ``DTensor`` inputs (the sharded train step) ``shard_map`` runs ``fn``
under ``local_map`` instead: each input is redistributed to its spec's
placements and ``fn`` sees the rank's blocks.  The gradients keep the
semantics above: an input's gradient is partial over the mesh axes its
spec does not name (the sum over ranks of their blocks' gradients), and an
output's cotangent reaches ``fn`` divided by the ranks that hold the same
block.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

from repro_torch.dist.sharding import P, axis_sizes


def _axes(axes) -> tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def axis_group(mesh, axes):
    """The process group over mesh ``axes`` (one name or several, major
    first), its ranks in the order of the axes' flattened coordinates."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def axis_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def _require_device_mesh(mesh) -> None:
    if not hasattr(mesh, "get_coordinate"):
        raise TypeError(f"SPMD runs on a DeviceMesh, not {mesh!r} (an "
                        "AbstractMesh only derives specs)")


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes`` (flattened, major first)."""
    _require_device_mesh(mesh)
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = axis_sizes(mesh)
    i = 0
    for a in _axes(axes):
        i = i * sizes[a] + coord[names.index(a)]
    return i


# torch >= 2.12 names it all_gather_single and deprecates the old name
_all_gather_flat = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)


def _gather(x: Tensor, group, n: int, dim: int) -> Tensor:
    """The ``n`` ranks' ``x`` concatenated on ``dim`` in group-rank order
    (the collectives move flat buffers: gloo asks for them)."""
    if n == 1:
        return x
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, x.contiguous().reshape(-1), group=group)
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def _scatter_sum(x: Tensor, group, n: int, dim: int) -> Tensor:
    """The sum of the ``n`` ranks' ``x``, of which this rank keeps block
    ``rank`` of ``n`` on ``dim``."""
    if n == 1:
        return x
    parts = torch.stack(x.chunk(n, dim=dim))
    out = torch.empty(parts[0].numel(), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, parts.reshape(-1), group=group)
    return out.view(parts.shape[1:])


def _sum(x: Tensor, group, n: int) -> Tensor:
    if n == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _sum(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, ctx.n), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter_sum(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


def psum(x: Tensor, mesh, axes) -> Tensor:
    """The sum of ``x`` over the ranks along ``axes``."""
    return _Psum.apply(x, axis_group(mesh, axes), axis_size(mesh, axes))


def pmean(x: Tensor, mesh, axes) -> Tensor:
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def all_gather(x: Tensor, mesh, axes, dim: int) -> Tensor:
    """The blocks of the ranks along ``axes`` concatenated on ``dim`` in
    coordinate order (``jax.lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, axis_group(mesh, axes), axis_size(mesh, axes),
                            dim)


def psum_scatter(x: Tensor, mesh, axes, dim: int) -> Tensor:
    """The sum over the ranks along ``axes``, of which this rank keeps the
    block at its coordinate on ``dim`` (``jax.lax.psum_scatter(...,
    tiled=True)``)."""
    return _PsumScatter.apply(x, axis_group(mesh, axes),
                              axis_size(mesh, axes), dim)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _GradHook(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def grad_hook(x: Tensor, fn) -> Tensor:
    """The identity on ``x``, whose backward passes the cotangent through
    ``fn`` (a scale, a redistribution, a dense copy)."""
    return _GradHook.apply(x, fn)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: Tensor, group) -> Tensor:
    """The sum of ``x`` over a process group, of a value every rank then
    uses alike: the cotangent passes through unchanged, each rank's term
    taking the whole of it (Megatron's vocabulary-parallel embedding and
    loss).  A functional collective, so that a fake group traces it."""
    return _SumOver.apply(x, group)


# ---------------------------------------------------------------------------
# global tensors <-> rank blocks
# ---------------------------------------------------------------------------

def _block(x: Tensor, mesh, spec: P) -> Tensor:
    for d, entry in enumerate(spec):
        if entry is not None:
            n = axis_size(mesh, entry)
            if x.shape[d] % n:
                raise ValueError(
                    f"dimension {d} of size {x.shape[d]} does not divide "
                    f"over mesh axes {entry} ({n} ranks)")
            size = x.shape[d] // n
            x = x.narrow(d, axis_index(mesh, entry) * size, size)
    return x


def _world(mesh):
    return axis_group(mesh, tuple(mesh.mesh_dim_names))


class _Cut(torch.autograd.Function):
    """Forward: this rank's block of a global tensor.  Backward: the
    global gradient, the sum over every rank of its block's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec, ctx.shape = mesh, spec, x.shape
        return _block(x, mesh, spec).clone()    # the rank's own copy

    @staticmethod
    def backward(ctx, g):
        full = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        _block(full, ctx.mesh, ctx.spec).copy_(g)
        return _sum(full, _world(ctx.mesh), ctx.mesh.size()), None, None


class _Join(torch.autograd.Function):
    """Forward: the global tensor from every rank's block.  Backward: this
    rank's block of the (replicated) gradient, divided by the number of
    ranks that hold the same block."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        for d, entry in reversed(list(enumerate(spec))):
            if entry is not None:
                x = _gather(x, axis_group(mesh, entry),
                            axis_size(mesh, entry), d)
        return x

    @staticmethod
    def backward(ctx, g):
        named = [a for e in ctx.spec if e is not None for a in _axes(e)]
        copies = ctx.mesh.size() // axis_size(ctx.mesh, named) if named \
            else ctx.mesh.size()
        return _block(g, ctx.mesh, ctx.spec) / copies, None, None


def shard_map(fn, mesh, in_specs, out_specs):
    """``fn`` over each rank's blocks of global tensors: the inputs are cut
    by ``in_specs``, ``fn``'s outputs (a tensor or a tuple) joined by
    ``out_specs``.  An entry of a spec names the mesh axes that dimension
    is split over; ``P()`` replicates."""
    _require_device_mesh(mesh)
    single = isinstance(out_specs, P)

    def run(*args):
        if any(is_dtensor(a) for a in args):
            return _local_map(fn, mesh, in_specs, out_specs, single, args)
        blocks = [_Cut.apply(a, mesh, P(*s)) for a, s in zip(args, in_specs)]
        outs = fn(*blocks)
        if single:
            return _Join.apply(outs, mesh, out_specs)
        return tuple(_Join.apply(o, mesh, P(*s))
                     for o, s in zip(outs, out_specs))

    return run


def _named_axes(spec: P) -> list[str]:
    return [a for e in spec if e is not None for a in _axes(e)]


def _local_map(fn, mesh, in_specs, out_specs, single: bool, args):
    """``shard_map``'s ``run`` on DTensor arguments (a plain tensor among
    them is a global value, replicated on every rank)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import placements

    whole = (Replicate(),) * mesh.ndim
    args = [a if is_dtensor(a) else
            DTensor.from_local(a, mesh, whole, run_check=False) for a in args]
    in_pl = [placements(mesh, P(*s)) for s in in_specs]
    in_grad = [tuple(Partial() if pl.is_replicate() else pl for pl in pls)
               for pls in in_pl]
    outs = [out_specs] if single else [P(*s) for s in out_specs]
    copies = [mesh.size() // axis_size(mesh, _named_axes(s)) for s in outs]

    def body(*blocks):
        res = fn(*blocks)
        res = [res] if single else list(res)
        res = [grad_hook(r, lambda g, c=c: g / c) if c > 1 else r
               for r, c in zip(res, copies)]
        return res[0] if single else tuple(res)

    out_pl = [placements(mesh, s) for s in outs]
    return local_map(body, out_placements=(list(out_pl[0]) if single
                                           else tuple(out_pl)),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(in_grad), device_mesh=mesh,
                     redistribute_inputs=True)(*args)

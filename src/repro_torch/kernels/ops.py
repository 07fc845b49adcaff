"""Kernel routing by device.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel, which launches or raises.  There is no
fallback from the kernel to the plain version, and no option that picks
one: the reference's ``sweep_impl`` ("jnp" | "pallas") and ``attn_impl``
("xla" | "pallas") become the device the tensors lie on.
``flash_attention`` is differentiable on both devices through
``FlashAttention`` (the forward and backward kernels on the card, the plain
forward and ``ref.attention_bwd_ref`` on the CPU) when a gradient is
wanted; otherwise it calls the kernel or the plain version directly, so
serving launches the forward alone and saves nothing.  ``ssd_scan`` is
differentiable on both devices: on the card through ``SSDScan`` (the
forward and backward kernels), on the CPU through the plain version;
with ``return_state`` (a prefill, which needs no gradient) it returns the
final state too, from the kernel itself on the card.

A meta tensor (the dry-run's, under ``FakeTensorMode``) routes as a CUDA
tensor does: the kernels' ops give its outputs' shapes through their fake
implementations, so the trace is the card's program without data
(``launch/dryrun.py``); nothing is launched or counted.

On ``DTensor`` inputs (the sharded train step) ``flash_attention`` and
``ssd_scan`` run the same routed function under
``torch.distributed.tensor.experimental.local_map`` with
``redistribute_inputs=False``, on each rank's block: attention and the scan
are independent over the batch and the heads, so a block is the rank's
batch rows and heads (q, k, v ``[B, H, S, D]`` sharded on dims 0 and 1; the
scan's x ``[B, S, H, P]`` on 0 and 2).  K/V heads (or the scan's B/C
groups, or its ``[H]`` A and D) that the head split does not divide arrive
whole over the head axis, as the reference's rules place them
(``dist.sharding.resolve_dim`` replicates a dim its axis does not divide),
and each rank reads the slice its query heads need.  An input whose
placement the kernel cannot take raises: the sequence or the head dim
sharded, a partial sum, heads that do not divide their axis, a k/v laid
out otherwise than q.  Nothing is gathered, and nothing goes to the plain
version because of its placement.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import Tensor

from repro_torch.dist.spmd import grad_hook, is_dtensor
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_cuda)
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_cuda
from repro_torch.kernels.vm_update import advance_sweep_cuda


def resolve_advance(device) -> Callable:
    """The advance sweep for tensors on ``device``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return advance_sweep_cuda
    if kind == "cpu":
        return ref.advance_sweep_ref
    raise ValueError(f"no advance sweep for device type {kind!r}")


def advance_sweep(rem: Tensor, rate: Tensor, active: Tensor,
                  bound_dt: Tensor) -> tuple[Tensor, Tensor]:
    """Engine advance sweep, routed by the device ``rem`` lies on."""
    return resolve_advance(rem.device)(rem, rate, active, bound_dt)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None, softcap: float = 0.0,
                    scale: float | None = None) -> Tensor:
    """Attention routed by the device ``q`` lies on: the CUDA kernel for a
    CUDA tensor, ``ref.attention_ref`` for a CPU tensor; through
    ``FlashAttention`` when grad is enabled and q, k or v requires one."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if is_dtensor(q):
        return _flash_local_map(q, k, v, kw)
    return _flash_routed(q, k, v, kw)


def _on_card(t: Tensor) -> bool:
    """A CUDA tensor, or a meta tensor: the card's program traced."""
    return t.device.type in ("cuda", "meta")


def _flash_routed(q: Tensor, k: Tensor, v: Tensor, kw: dict) -> Tensor:
    card = _on_card(q)
    if not card and q.device.type != "cpu":
        raise ValueError(f"no flash attention for device type "
                         f"{q.device.type!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, kw["causal"], kw["window"],
                                    kw["softcap"], kw["scale"])
    fn = flash_attention_cuda if card else ref.attention_ref
    return fn(q, k, v, **kw)


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
             D: Tensor, *, chunk: int = 128, return_state: bool = False):
    """The Mamba2 SSD scan routed by the device ``x`` lies on: the CUDA
    kernel (through ``SSDScan``) for a CUDA tensor, ``ref.ssd_scan_ref`` for
    a CPU tensor.  S need not be a multiple of ``chunk``.  With
    ``return_state``, ``(y, final state [B, H, P, N] f32)``: on the card the
    kernel's own state output, outside autograd (``ssd_scan_cuda`` refuses
    inputs that require a gradient)."""
    if is_dtensor(x):
        return _ssd_local_map(x, dt, A, Bm, Cm, D, chunk, return_state)
    return _ssd_routed(x, dt, A, Bm, Cm, D, chunk, return_state)


def _ssd_routed(x, dt, A, Bm, Cm, D, chunk: int, return_state: bool):
    kind = x.device.type
    if _on_card(x):
        if return_state:
            return ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk,
                                 return_state=True)
        return SSDScan.apply(x, dt, A, Bm, Cm, D, chunk)
    if kind == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                return_state=return_state)
    raise ValueError(f"no SSD scan for device type {kind!r}")


# ---------------------------------------------------------------------------
# DTensor inputs: the routed functions under local_map
# ---------------------------------------------------------------------------

# calls of each routed function on a rank's block under local_map (a
# forward's; the backward runs through autograd)
local_map_blocks = {"flash_attention": 0, "ssd_scan": 0}


def _dense_grads(*ts):
    """The blocks, whose gradients are made contiguous: a block's input
    gradient becomes a ``DTensor``'s local tensor, which DTensor's view
    rules need dense (the plain scan's gradient of dt is a strided
    view)."""
    return tuple(grad_hook(t, Tensor.contiguous) if t.requires_grad else t
                 for t in ts)


def _same(mesh, a, b) -> bool:
    """Placements ``a`` and ``b`` equal on every mesh dim of more than one
    rank (on a dim of one rank a placement is a label: no data differs)."""
    return all(x == y or mesh.size(i) == 1
               for i, (x, y) in enumerate(zip(a, b)))


def _take(name: str, what: str, t, want):
    """``t`` laid out ``want``: relabelled where only mesh dims of one rank
    differ (``redistribute`` moves nothing there); any other difference
    raises."""
    if tuple(t.placements) == tuple(want):
        return t
    if _same(t.device_mesh, t.placements, want):
        return t.redistribute(t.device_mesh, tuple(want))
    raise ValueError(
        f"{name}: {what} is placed {tuple(t.placements)}, the kernel takes "
        f"{tuple(want)} (blocks of whole batch rows and heads); it is neither "
        "gathered nor sent to the plain version")


def _head_split(name: str, t, head_dim: int, batch_dims: tuple[int, ...]):
    """The mesh dims sharding ``t``'s heads (dim ``head_dim``), after
    checking that every placement is ``Replicate`` or ``Shard`` of a batch
    dim or of the heads, and that the heads divide over them."""
    ok = (*batch_dims, head_dim)
    for i, pl in enumerate(t.placements):
        if not (pl.is_replicate() or (pl.is_shard() and pl.dim in ok)):
            raise ValueError(
                f"{name}: placement {pl} on mesh dim {i} cannot run locally: "
                f"the kernel takes blocks of whole rows of dims {ok} (batch, "
                f"heads) and no sharded sequence, head dim or partial sum")
    dims = [i for i, pl in enumerate(t.placements)
            if pl.is_shard() and pl.dim == head_dim]
    split = math.prod(t.device_mesh.size(i) for i in dims)
    if t.shape[head_dim] % split:
        raise ValueError(f"{name}: {t.shape[head_dim]} heads do not divide "
                         f"over {split} ranks")
    return dims, split


def _rank_block(mesh, dims: list[int]) -> int:
    """This rank's coordinate over mesh ``dims``, flattened major first."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _grouped(name: str, lead, head_dims: list[int], head_dim: int,
             n_q: int, n_kv: int, split: int, mesh):
    """Placements of a grouped input (k/v heads, B/C groups, the scan's A
    and D) beside queries placed ``lead`` with ``n_q`` heads split
    ``split`` ways over mesh ``head_dims``: ``lead`` (its head dim at
    ``head_dim``) when ``split`` divides ``n_kv``, else whole over the head
    dims, and each rank reads the slice its query heads need.  Returns
    (placements, gradient placements, (first, count) of the local slice or
    None)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    lead = tuple(Shard(head_dim) if pl.is_shard() and i in head_dims else pl
                 for i, pl in enumerate(lead))
    if n_kv % split == 0:
        return lead, lead, None
    q_loc = n_q // split
    g = n_q // n_kv
    if not (q_loc % g == 0 or g % q_loc == 0):
        raise ValueError(
            f"{name}: {n_q} query heads over {split} ranks ({q_loc} each) "
            f"do not map onto whole groups of {n_kv}")
    first = _rank_block(mesh, head_dims) * q_loc // g
    count = max(q_loc // g, 1)
    inp = tuple(Replicate() if i in head_dims else pl
                for i, pl in enumerate(lead))
    grad = tuple(Partial() if i in head_dims else pl
                 for i, pl in enumerate(inp))
    return inp, grad, (first, count)


def _flash_local_map(q, k, v, kw: dict):
    def block(ql, kl, vl):
        local_map_blocks["flash_attention"] += 1
        return _flash_routed(ql, kl, vl, kw)

    return heads_local_map("flash_attention", block, q, k, v)


def heads_local_map(name: str, fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` on each rank's block of ``DTensor``s q ``[B,
    Hq, Sq, D]``, k and v ``[B, Hk, Sk, D]`` (whole batch rows and heads;
    k/v heads the head split does not divide arrive whole over it and each
    rank passes the slice its query heads read) and ``rows``, tensors of
    one entry per batch row (a plain tensor is taken as the whole, and each
    rank passes its rows).  The output is laid out as q; placements that
    cannot run locally raise (see the module's docstring)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    head_dims, split = _head_split(name, q, 1, (0,))
    qp = tuple(q.placements)
    kvp, kvg, cut = _grouped(name, qp, head_dims, 1, q.shape[1], k.shape[1],
                             split, mesh)
    k, v = _take(name, "k", k, kvp), _take(name, "v", v, kvp)
    rp = tuple(Shard(0) if pl.is_shard(0) else Replicate() for pl in qp)
    whole = (Replicate(),) * mesh.ndim
    rows = tuple(r if is_dtensor(r) else
                 DTensor.from_local(r, mesh, whole, run_check=False)
                 for r in rows)
    rows = tuple(r.redistribute(mesh, rp) for r in rows)   # local slices

    def block(ql, kl, vl, *rl):
        ql, kl, vl = _dense_grads(ql, kl, vl)
        if cut is not None:
            kl, vl = (t.narrow(1, cut[0], cut[1]) for t in (kl, vl))
        return fn(ql, kl, vl, *rl)

    return local_map(block, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp, *(rp,) * len(rows)),
                     in_grad_placements=(qp, kvg, kvg, *(rp,) * len(rows)),
                     device_mesh=mesh,
                     redistribute_inputs=False)(q, k, v, *rows)


def _per_head(name: str, t, mesh, head_dims: list[int], xp, split: int):
    """A ``[H]`` leaf of the scan (A, D) beside x placed ``xp``: sharded
    with the heads, or whole over the head dims (each rank slices its
    heads); never split by the batch.  Its gradient sums the rank's batch
    rows, so it is partial over the batch's mesh dims (and over the head
    dims where it is sliced).  Returns (the leaf, its placements, its
    gradient's placements, whether each rank slices it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    whole = tuple(Replicate() for _ in range(mesh.ndim))
    hp = tuple(Shard(0) if i in head_dims else Replicate()
               for i in range(mesh.ndim))
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, whole, run_check=False)
    pl = hp if _same(mesh, t.placements, hp) else whole
    t = _take("ssd_scan", name, t, pl)
    sliced = pl == whole and split > 1
    grad = tuple(Partial() if (sliced and i in head_dims)
                 or (xp[i].is_shard() and i not in head_dims) else p
                 for i, p in enumerate(pl))
    return t, pl, grad, sliced


def _ssd_local_map(x, dt, A, Bm, Cm, D, chunk: int, return_state: bool):
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    head_dims, split = _head_split("ssd_scan", x, 2, (0,))
    h = x.shape[2]
    xp = tuple(x.placements)
    dt = _take("ssd_scan", "dt", dt, xp)
    bcp, bcg, cut = _grouped("ssd_scan", xp, head_dims, 2, h, Bm.shape[2],
                             split, mesh)
    Bm = _take("ssd_scan", "Bm", Bm, bcp)
    Cm = _take("ssd_scan", "Cm", Cm, bcp)
    A, ap, ag, a_cut = _per_head("A", A, mesh, head_dims, xp, split)
    D, dp, dg, d_cut = _per_head("D", D, mesh, head_dims, xp, split)
    h_loc = h // split
    first = _rank_block(mesh, head_dims) * h_loc if head_dims else 0
    out = [list(xp)]
    if return_state:     # [B, H, P, N]: batch on 0, heads on 1
        out.append([Shard(1) if i in head_dims else pl
                    for i, pl in enumerate(xp)])

    def block(xl, dtl, Al, Bl, Cl, Dl):
        local_map_blocks["ssd_scan"] += 1
        xl, dtl, Al, Bl, Cl, Dl = _dense_grads(xl, dtl, Al, Bl, Cl, Dl)
        if cut is not None:
            Bl, Cl = (t.narrow(2, cut[0], cut[1]) for t in (Bl, Cl))
        if a_cut:
            Al = Al.narrow(0, first, h_loc)
        if d_cut:
            Dl = Dl.narrow(0, first, h_loc)
        return _ssd_routed(xl, dtl, Al, Bl, Cl, Dl, chunk, return_state)

    return local_map(block,
                     out_placements=tuple(out) if return_state else out[0],
                     in_placements=(xp, xp, ap, bcp, bcp, dp),
                     in_grad_placements=(xp, xp, ag, bcg, bcg, dg),
                     device_mesh=mesh,
                     redistribute_inputs=False)(x, dt, A, Bm, Cm, D)

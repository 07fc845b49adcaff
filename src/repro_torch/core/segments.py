"""Per-segment reductions in arrival (row) order, batch-major.

Every function takes ``[B, N]`` values and segment ids and works on each
scenario row on its own: segment ``s`` of row ``b`` never mixes with row
``b'``.  Ids are clipped to ``[0, num_segments]``, as in
``repro.core.segments``: ``num_segments`` is a junk segment that the outputs
drop, and callers map rows they want ignored there.

Float sums are deterministic on every device, so a row of a campaign is
bitwise the same as the scenario run alone (DESIGN.md §10):

* scatter-adds go through ``index_add_`` on the CPU (sequential in index
  order, like XLA's CPU scatter) and ``index_put_(accumulate=True)`` on CUDA
  (sort-based and deterministic; ``index_add_`` there uses atomics in no
  fixed order).  Each segment's additions happen in row order on the CPU; on
  CUDA their order is fixed but may differ from the CPU, so float sums can
  differ from the CPU in the last bits.  Integer-valued sums (cores, MIPS,
  blocks) are exact either way.
* ``row_sum`` reduces the last axis pairwise in a fixed order that depends
  on its length only, where ``torch.sum`` on CUDA would pick an order from
  the batch size.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core.entities import INF


def take(x: Tensor, index: Tensor) -> Tensor:
    """Per-row gather along the last axis: ``out[b, i] = x[b, index[b, i]]``
    (the batch-major form of the reference's ``x[index]``)."""
    return x.gather(-1, index.long())


def _flat_ids(segment_ids: Tensor, num_segments: int) -> Tensor:
    """Row-offset segment ids in ``[0, B * (num_segments + 1))``, each row's
    ids clipped to ``[0, num_segments]``."""
    b = segment_ids.shape[0]
    seg = segment_ids.long().clamp(0, num_segments)
    off = torch.arange(b, device=seg.device).unsqueeze(-1) * (num_segments + 1)
    return (seg + off).reshape(-1)


def scatter_add_(out: Tensor, index: Tensor, values: Tensor) -> Tensor:
    """``out[index[i]] += values[i]`` on 1-D tensors, in place, in a fixed
    order on every device (see the module note)."""
    if out.is_cuda and out.is_floating_point():
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def segment_sum(values: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """``[B, N]`` -> ``[B, num_segments]`` sum of ``values`` per segment."""
    b = values.shape[0]
    out = torch.zeros(b * (num_segments + 1), dtype=values.dtype,
                      device=values.device)
    scatter_add_(out, _flat_ids(segment_ids, num_segments), values.reshape(-1))
    return out.view(b, num_segments + 1)[:, :-1]


def segment_all(values: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """Logical AND of ``values`` per segment (vacuously True)."""
    neg = segment_sum((~values).to(torch.int32), segment_ids, num_segments)
    return neg == 0


def segment_min(values: Tensor, segment_ids: Tensor, num_segments: int,
                fill) -> Tensor:
    """``[B, N]`` -> ``[B, num_segments]`` minimum per segment (``fill``
    where a segment is empty)."""
    b = values.shape[0]
    out = torch.full((b * (num_segments + 1),), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, _flat_ids(segment_ids, num_segments),
                        values.reshape(-1), reduce="amin", include_self=True)
    return out.view(b, num_segments + 1)[:, :-1]


def segment_prefix_sum(values: Tensor, segment_ids: Tensor,
                       num_segments: int) -> Tensor:
    """Exclusive prefix sum of ``values`` within each segment, in row order.

    A stable per-row sort groups each segment with its rows in index order;
    a cumulative sum minus each segment's starting offset (forward-filled by
    a running max, since the sums of non-negative values never decrease)
    gives the prefix.  Junk-segment entries receive garbage; callers mask.
    Callers pass integer-valued demands (cores, KV blocks), which a float32
    ``cumsum`` adds exactly in any order.
    """
    seg = segment_ids.long().clamp(0, num_segments)
    seg_sorted, order = torch.sort(seg, dim=-1, stable=True)
    v_sorted = values.gather(-1, order)
    incl = torch.cumsum(v_sorted, dim=-1)
    excl = incl - v_sorted
    is_first = torch.ones_like(seg_sorted, dtype=torch.bool)
    is_first[:, 1:] = seg_sorted[:, 1:] != seg_sorted[:, :-1]
    base = torch.where(is_first, excl, -torch.inf)
    base = torch.cummax(base, dim=-1).values
    prefix_sorted = (excl - base).to(values.dtype)
    return torch.empty_like(values).scatter_(-1, order, prefix_sorted)


def min_where(x: Tensor, mask: Tensor) -> Tensor:
    """Minimum of ``x`` over ``mask`` along the last axis, INF where the
    mask is empty (the reference's ``jnp.min(..., initial=INF)``)."""
    masked = torch.where(mask, x, INF)
    return torch.nn.functional.pad(masked, (0, 1), value=INF).amin(-1)


def row_sum(x: Tensor) -> Tensor:
    """Sum over the last axis, pairwise in an order fixed by its length.

    The axis is zero-padded to a power of two (adding +0.0 is exact) and
    halved until one element is left: elementwise adds only, so the result
    is bitwise the same on the CPU and on CUDA, whatever the batch size.
    """
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]

"""What one rank of a step does, counted while the step runs on tensors
without data: the port's counterpart of ``repro.analysis.hlo_walk`` and of
``compiled.memory_analysis()``.

The reference reads the HLO that XLA partitioned for one device; torch has
no such module, so the port runs the step itself under ``FakeTensorMode``
(meta tensors: the card's program, whose kernels' ops give their outputs'
shapes through their fake implementations; or CPU tensors: the plain
versions), with ``DTensor`` parameters over a process group of the mesh's
size (the ``"fake"`` backend: collectives move nothing), inside three of
torch's own counting modes:

* ``RankFlops``, a ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs
  of every operation it has a formula for (the matrix products, and the
  kernels' ops, whose formulas ``kernels/flash_attention.py`` and
  ``kernels/ssd_scan.py`` register), the ``dot_flops`` of the HLO walk.  A
  ``FlopCounterMode`` counts a ``DTensor`` operation at its global shapes;
  this one hands every ``DTensor`` operation back to DTensor, so it counts
  the operations DTensor runs on this rank's local tensors.
* ``RankComms``, a ``torch.distributed.tensor.debug.CommDebugMode``: the
  collectives DTensor and ``dist/spmd.py`` issue on this rank, by the HLO
  walk's kinds, with the bytes of the tensors each one was given and its
  group's size, charged by the ring model (``roofline.ring_bytes``).
* ``RankMemory``, a ``torch.distributed._tools.mem_tracker.MemTracker``:
  the most bytes of storage live at once on this rank (no allocator
  rounding or caching), counting the tensors given to ``track``.

DTensor derives each new operation's global shapes by running it once on
fake tensors of those shapes; the three modes set those runs aside, since
no rank runs them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

from repro_torch.analysis.roofline import CollectiveStats, ring_bytes

# collective op names (functional, c10d and DTensor's) -> the HLO kinds
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}
_KERNEL_NS = "repro_torch::"


class _Aside:
    """The depth of DTensor's global-shape propagation runs in progress,
    shared by one trace's modes."""

    def __init__(self):
        self.depth = 0

    @contextlib.contextmanager
    def around_propagation(self):
        """While inside, DTensor's propagation of global shapes runs with
        ``depth`` raised."""
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)

        real = ShardingPropagator._propagate_tensor_meta_non_cached

        def aside(prop, *args, **kwargs):
            self.depth += 1
            try:
                return real(prop, *args, **kwargs)
            finally:
                self.depth -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = aside
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = real


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class _LocalFlopMode(_FlopCounterMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented        # DTensor runs it on local tensors
        if self.counter.aside.depth:
            return func(*args, **(kwargs or {}))
        packet = getattr(func, "_overloadpacket", None)
        if packet is not None and packet._qualified_op_name.startswith(
                _KERNEL_NS):
            calls = self.counter.kernel_calls
            calls[packet.__name__] = calls.get(packet.__name__, 0) + 1
        return super().__torch_dispatch__(func, types, args, kwargs)


class RankFlops(FlopCounterMode):
    """``FlopCounterMode`` over this rank's local operations;
    ``kernel_calls`` counts the calls of each kernel op."""

    def __init__(self, aside: _Aside):
        super().__init__(display=False)
        self.aside = aside
        self.kernel_calls: dict[str, int] = {}

    def __enter__(self):
        self.flop_counts.clear()
        self.kernel_calls.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


def _group_size(args) -> int:
    """The size of the process group among a collective's arguments: a
    ``ProcessGroup`` (boxed as a ``ScriptObject`` in the c10d ops) or a
    functional collective's group name."""
    for a in tree_leaves(args):
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name(
                ).endswith(".ProcessGroup"):
            a = dist.ProcessGroup.unbox(a)
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):   # not a group
                continue
    return 1


class RankComms(CommDebugMode):
    """``CommDebugMode`` that also keeps, per kind of collective, the count,
    the operand bytes and the ring model's bytes of this rank's calls."""

    def __init__(self, aside: _Aside):
        super().__init__()
        self.aside = aside
        self.counts: dict[str, int] = {}
        self.raw: dict[str, int] = {}
        self.eff_by_kind: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.aside.depth and not _is_dtensor_op(types):
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        kind = _KIND.get(packet.__name__) if packet is not None else None
        if out is not NotImplemented and kind is not None:
            self._charge(kind, args)
        return out

    def _charge(self, kind: str, args) -> None:
        sizes = [t.numel() * t.element_size() for t in tree_leaves(args)
                 if isinstance(t, torch.Tensor)]
        if not sizes:
            return
        n = _group_size(args)
        if kind == "all-gather":       # c10d ops list the output too
            operand = min(sizes)
        elif kind == "reduce-scatter":
            operand = max(sizes)
        else:
            operand = sizes[0]
        result = operand * n if kind == "all-gather" else operand
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.raw[kind] = self.raw.get(kind, 0) + operand
        self.eff_by_kind[kind] = (self.eff_by_kind.get(kind, 0.0)
                                  + ring_bytes(kind, n, operand, result))

    def stats(self) -> CollectiveStats:
        return CollectiveStats(counts=dict(self.counts),
                               raw_bytes=dict(self.raw),
                               effective_bytes=sum(self.eff_by_kind.values()))


class RankMemory(MemTracker):
    """``MemTracker`` that leaves DTensor's global-shape runs out."""

    def __init__(self, aside: _Aside):
        super().__init__()
        self.aside = aside

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.aside.depth and not _is_dtensor_op(types):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class StepTrace:
    """The three modes at once, around a step (see the module's
    docstring).  ``track`` the tensors that exist before the step, before
    entering.  After the step: ``dot_flops``, ``kernel_calls``, the
    collectives (``coll_counts``, ``coll_raw``, ``coll_eff_by_kind``,
    ``coll_effective``, ``collectives()``) and ``peak_bytes``."""

    def __init__(self):
        self._aside = _Aside()
        self.flops = RankFlops(self._aside)
        self.comms = RankComms(self._aside)
        self.memory = RankMemory(self._aside)
        self._stack: contextlib.ExitStack | None = None

    def track(self, values) -> None:
        tensors = [t for t in tree_leaves(values)
                   if isinstance(t, torch.Tensor)]
        self.memory.track_external(*tensors)

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._aside.around_propagation())
        self._stack.enter_context(self.memory)
        self._stack.enter_context(self.flops)
        self._stack.enter_context(self.comms)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    @property
    def dot_flops(self) -> float:
        return float(self.flops.get_total_flops())

    @property
    def kernel_calls(self) -> dict[str, int]:
        return dict(self.flops.kernel_calls)

    @property
    def coll_counts(self) -> dict[str, int]:
        return self.comms.counts

    @property
    def coll_raw(self) -> dict[str, int]:
        return self.comms.raw

    @property
    def coll_eff_by_kind(self) -> dict[str, float]:
        return self.comms.eff_by_kind

    @property
    def coll_effective(self) -> float:
        return sum(self.comms.eff_by_kind.values())

    def collectives(self) -> CollectiveStats:
        return self.comms.stats()

    @property
    def peak_bytes(self) -> int:
        """The largest live total of any one device this rank used."""
        peak = self.memory.get_tracker_snapshot("peak")
        return max((v["Total"] for v in peak.values()), default=0)

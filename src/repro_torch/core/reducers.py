"""Streaming campaign reductions: fold chunk results, never hold ``[N, ...]``
(the port of ``repro.core.reducers``, DESIGN.md §12).

A policy study over thousands of scenarios wants a few summary statistics,
not thousands of stacked ``SimResult``s.  A ``CampaignReducer`` is a fold
over campaign chunks with a **fixed-shape carry**:
``campaign.run_campaign(batched, chunk_size=..., reduce=...)`` runs each
chunk, folds its ``SimResult`` into the carry on the chunk's device, drops
the chunk's result, and returns only the finalized summary.

Protocol
--------
``init(chunk, res)`` builds the carry from the first chunk and its result
(their shapes and dtypes; nothing more is simulated for it); ``fold(carry,
chunk, res, index, valid)`` consumes one chunk, where ``index`` holds the
rows' global indices and ``valid`` masks the repeated-row padding of the
trailing chunk; ``finalize(carry)`` turns the carry into the summary.
Reducers are frozen dataclasses, as in the reference.

Determinism and chunk-size invariance
-------------------------------------
Integer folds (``SumReducer`` over counts, the histograms' bin counts,
``ArgBestReducer`` with lowest-index tie-breaking, ``ValuesReducer``'s
scatters) are exact, so they are bitwise the same for every chunking.
Float sums (``MeanReducer``, ``SumReducer`` over f32 fields) regroup per
chunk and agree to rounding; within one chunk they add in a fixed order on
every device (``segments.row_sum``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from repro_torch.core.entities import INF, Scenario, SimResult
from repro_torch.core.segments import row_sum


def _metric_fn(metric):
    """A ``SimResult`` field name or a callable ``SimResult -> [B]``."""
    if callable(metric):
        return metric
    if isinstance(metric, str):
        if metric not in {f.name for f in dataclasses.fields(SimResult)}:
            raise ValueError(
                f"unknown SimResult field {metric!r}; pass a callable for "
                "derived metrics")
        return lambda res: getattr(res, metric)
    raise TypeError(f"metric must be a field name or callable, got {metric!r}")


def _metric(metric, res: SimResult) -> Tensor:
    """The ``[B]`` metric of a chunk's result; any other rank raises."""
    v = _metric_fn(metric)(res)
    if v.dim() != 1:
        raise ValueError(
            f"reducer metrics must be one scalar per scenario row ([B]); "
            f"metric {metric!r} has shape {tuple(v.shape)}; reduce "
            "per-entity fields (e.g. turnaround [B, C]) to a row scalar in "
            "the callable")
    return v


def _total(x: Tensor) -> Tensor:
    """0-d sum of a [B] vector in its own dtype: exact for integers, in a
    fixed pairwise order for floats."""
    if x.is_floating_point():
        return row_sum(x)
    return x.sum(dtype=x.dtype)


def _bins(v: Tensor, lo: float, hi: float, bins: int) -> Tensor:
    """Histogram bin of each value: ``trunc((v - lo) / width)`` clipped to
    ``[0, bins - 1]``, as the reference's int32 cast and clip give it.

    Clamped in float before the cast: torch's cast of an out-of-range
    float is undefined (``-2**31`` on the CPU for +-INF and NaN), where
    XLA's saturates and sends NaN to 0; so +INF lands in the last bin,
    -INF in the first and NaN in bin 0, as in the reference.
    """
    dev = v.device
    lo32 = torch.tensor(lo, dtype=torch.float32, device=dev)
    width = torch.tensor((hi - lo) / bins, dtype=torch.float32, device=dev)
    x = (v.float() - lo32) / width
    return torch.nan_to_num(x, nan=0.0).clamp(0, bins - 1).to(torch.int32)


def _count(carry: Tensor, idx: Tensor, keep: Tensor) -> Tensor:
    """``carry`` [bins] i32 plus one per kept bin index (exact in any
    order)."""
    bins = carry.shape[0]
    out = torch.cat([carry, carry.new_zeros(1)])
    slot = torch.where(keep, idx, bins).reshape(-1).long()
    out.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return out[:bins]


@dataclasses.dataclass(frozen=True)
class CampaignReducer:
    """Base protocol; see the module docstring for the fold contract."""

    def init(self, chunk: Scenario, res: SimResult):
        raise NotImplementedError

    def fold(self, carry, chunk: Scenario, res: SimResult, index: Tensor,
             valid: Tensor):
        raise NotImplementedError

    def finalize(self, carry):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SumReducer(CampaignReducer):
    """Total of a per-scenario metric (violation counts, downtime seconds).
    Integer metrics fold exactly, so any chunking gives the same total."""

    metric: object

    def init(self, chunk, res):
        v = _metric(self.metric, res)
        dtype = torch.int32 if v.dtype == torch.bool else v.dtype
        return torch.zeros((), dtype=dtype, device=v.device)

    def fold(self, carry, chunk, res, index, valid):
        v = _metric(self.metric, res).to(carry.dtype)
        return carry + _total(torch.where(valid, v, torch.zeros_like(v)))

    def finalize(self, carry):
        return carry


@dataclasses.dataclass(frozen=True)
class MeanReducer(CampaignReducer):
    """Streaming count / sum / sum of squares -> ``{n, mean, std}`` (float
    sums: agreement to rounding across chunkings)."""

    metric: object

    def init(self, chunk, res):
        dev = _metric(self.metric, res).device
        return tuple(torch.zeros((), device=dev) for _ in range(3))

    def fold(self, carry, chunk, res, index, valid):
        n, s, ss = carry
        v = torch.where(valid, _metric(self.metric, res).float(), 0.0)
        return (n + _total(valid.float()), s + _total(v), ss + _total(v * v))

    def finalize(self, carry):
        n, s, ss = carry
        mean = s / n.clamp_min(1.0)
        var = (ss / n.clamp_min(1.0) - mean * mean).clamp_min(0.0)
        return {"n": n, "mean": mean, "std": torch.sqrt(var)}


@dataclasses.dataclass(frozen=True)
class HistogramReducer(CampaignReducer):
    """Fixed-shape histogram -> bin counts + percentile estimates.

    ``bins`` i32 counters over ``[lo, hi]`` (values clipped into range, so
    the end bins double as under/overflow; see ``_bins`` for +-INF and
    NaN).  Counts are exact, so any chunking gives the same bins; quantiles
    interpolate within the selected bin, within one bin width.
    """

    metric: object
    lo: float
    hi: float
    bins: int = 64
    qs: tuple = (0.5, 0.9, 0.99)

    def __post_init__(self):
        if not (self.hi > self.lo):
            raise ValueError(f"empty histogram range [{self.lo}, {self.hi}]")
        if self.bins < 1:
            raise ValueError(f"bins must be >= 1, got {self.bins}")

    def init(self, chunk, res):
        dev = _metric(self.metric, res).device
        return torch.zeros(self.bins, dtype=torch.int32, device=dev)

    def fold(self, carry, chunk, res, index, valid):
        v = _metric(self.metric, res)
        return _count(carry, _bins(v, self.lo, self.hi, self.bins), valid)

    def finalize(self, carry):
        counts = carry
        f32 = torch.float32
        total = counts.sum(dtype=torch.int32).clamp_min(1)
        cum = torch.cumsum(counts, 0, dtype=torch.int32)
        width = torch.tensor((self.hi - self.lo) / self.bins, dtype=f32,
                             device=counts.device)
        out = {"counts": counts,
               "edges": torch.linspace(self.lo, self.hi, self.bins + 1,
                                       device=counts.device)}
        for q in self.qs:
            target = q * total.to(f32)
            bin_ = (cum.to(f32) >= target).int().argmax()   # first True
            below = torch.where(bin_ > 0, cum[(bin_ - 1).clamp_min(0)], 0)
            in_bin = counts[bin_].clamp_min(1).to(f32)
            frac = ((target - below) / in_bin).clamp(0.0, 1.0)
            out[f"q{q:g}"] = self.lo + (bin_.to(f32) + frac) * width
        return out


@dataclasses.dataclass(frozen=True)
class LatencyHistogramReducer(HistogramReducer):
    """Serving tail latency pooled over the campaign: per-request TTFT
    (``start_t - submit_t``) or TPOT (``(finish_t - start_t) /
    max_new_tokens``) of every finished serving row of every valid
    scenario row, in one fixed-bin histogram (DESIGN.md §14)."""

    def __post_init__(self):
        super().__post_init__()
        if self.metric not in ("ttft", "tpot"):
            raise ValueError(
                f"metric must be 'ttft' or 'tpot', got {self.metric!r}")

    def init(self, chunk, res):
        return torch.zeros(self.bins, dtype=torch.int32,
                           device=res.finish_t.device)

    def fold(self, carry, chunk, res, index, valid):
        cls = chunk.cloudlets
        served = (cls.exists & (cls.prompt_tokens > 0.0)
                  & (res.finish_t < INF / 2))                         # [B,C]
        if self.metric == "ttft":
            v = res.start_t - cls.submit_t
        else:
            v = (res.finish_t - res.start_t) / cls.max_new_tokens.clamp_min(1.0)
        return _count(carry, _bins(v, self.lo, self.hi, self.bins),
                      served & valid[:, None])


def _policy_rows(policy, fn):
    """Apply ``fn(field name, leaf)`` to every leaf of a ``Policy``."""
    return policy.replace(**{
        f.name: fn(f.name, getattr(policy, f.name))
        for f in dataclasses.fields(policy)})


@dataclasses.dataclass(frozen=True)
class ArgBestReducer(CampaignReducer):
    """Best scenario row by a scalar metric, carrying its ``Policy`` row.

    Ties go to the lowest global row index (``argmin`` takes the first
    occurrence in a chunk; across chunks only a strict improvement replaces
    the incumbent), so the fold is bitwise the same for every chunking.
    """

    metric: object
    mode: str = "min"

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {self.mode!r}")

    def init(self, chunk, res):
        dev = _metric(self.metric, res).device
        row = _policy_rows(chunk.policy, lambda _, x: torch.zeros_like(x[0]))
        # the incumbent in sign space: always minimise sign * metric
        return (torch.tensor(INF, dtype=torch.float32, device=dev),
                torch.tensor(-1, dtype=torch.int32, device=dev), row)

    def fold(self, carry, chunk, res, index, valid):
        best, best_idx, best_row = carry
        sign = 1.0 if self.mode == "min" else -1.0
        v = _metric(self.metric, res).float()
        masked = torch.where(valid, sign * v, INF)
        local = masked.argmin().view(1)            # first occurrence

        def at(x: Tensor) -> Tensor:               # x[local], no host read
            return x.index_select(0, local)[0]

        cand = at(masked)
        improved = cand < best                     # strict: incumbent wins ties
        best = torch.where(improved, cand, best)
        best_idx = torch.where(improved, at(index), best_idx)
        best_row = _policy_rows(best_row, lambda name, old: torch.where(
            improved, at(getattr(chunk.policy, name)), old))
        return best, best_idx, best_row

    def finalize(self, carry):
        best, best_idx, best_row = carry
        sign = 1.0 if self.mode == "min" else -1.0
        return {"value": sign * best, "index": best_idx, "policy": best_row}


@dataclasses.dataclass(frozen=True)
class ValuesReducer(CampaignReducer):
    """One scalar metric per scenario scattered into a fixed ``[n_slots]``
    table: all of a campaign's scores without its ``[N, ...]`` results.
    ``core/search.py`` keeps ``n_slots`` at the first rung's population
    across successive-halving rungs.  Scatters at distinct indices commute,
    so the table is the same for every chunking."""

    metric: object
    n_slots: int

    def init(self, chunk, res):
        v = _metric(self.metric, res)
        return (torch.zeros(self.n_slots, dtype=v.dtype, device=v.device),
                torch.zeros(self.n_slots, dtype=torch.bool, device=v.device))

    def fold(self, carry, chunk, res, index, valid):
        values, filled = carry
        v = _metric(self.metric, res)
        # invalid rows (and rows past the table) land in a junk slot
        keep = valid & (index < self.n_slots)
        slot = torch.where(keep, index, self.n_slots).long()
        values = torch.cat([values, values.new_zeros(1)]).scatter(
            0, slot, v.to(values.dtype))[:-1]
        filled = torch.cat([filled, filled.new_zeros(1)]).scatter(
            0, slot, torch.ones_like(keep))[:-1]
        return values, filled

    def finalize(self, carry):
        values, filled = carry
        return {"values": values, "filled": filled}

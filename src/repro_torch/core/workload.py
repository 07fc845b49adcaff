"""Seeded dynamic-workload generators (the paper's "varying load"), the port
of ``repro.core.workload``.

* ``poisson_arrivals``  homogeneous Poisson: iid exponential gaps.
* ``diurnal_arrivals``  sinusoid-modulated Poisson by time rescaling: unit
                        arrivals pushed through the inverse cumulative
                        intensity, found by a fixed number of bisection steps.
* ``bursty_arrivals``   on/off bursts: exponential off-gaps between bursts,
                        within-burst gaps at ``burst_rate``.
* ``host_outages``      per-host failure/repair windows (exponential MTBF /
                        MTTR), the reliability subsystem's input (DESIGN.md §9).

Every generator draws from an explicit CPU ``torch.Generator`` in a fixed
order and works in float32 on the CPU; the finished table then moves to
``device``.  So the same seed gives the same arrays on every device, and a
scenario built for the card equals the one built for the CPU.  Torch cannot
reproduce ``jax.random``'s bits: parity with the reference carries a
JAX-drawn table across with ``convert.scenario_from_arrays`` instead.
Shapes (counts) are Python ints; rates and sizes may be Python floats or
tensors.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core.entities import INF, Cloudlets, Outages, resolve_device

_TWO_PI = 6.2831853
_F32 = torch.float32


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=_F32)


def _exponential(gen: torch.Generator, shape) -> Tensor:
    return torch.empty(shape, dtype=_F32).exponential_(1.0, generator=gen)


def host_outages(gen: torch.Generator, n_dc: int, n_hosts: int,
                 n_outages: int, mtbf_s, mttr_s, device=None) -> Outages:
    """``[D, H, K]`` exponential failure/repair schedule (DESIGN.md §9).

    Up-gaps ~ Exp(mean ``mtbf_s``) and down-durations ~ Exp(mean
    ``mttr_s``) alternate, so ``fail_t[k] = sum_{i<=k} gap_i + sum_{i<k}
    dur_i`` and ``repair_t[k] = fail_t[k] + dur_k``: windows are disjoint
    and sorted.  ``mtbf_s`` / ``mttr_s`` are scalars or ``[D, H]``;
    ``mtbf_s >= INF`` means never, every entry padding.
    """
    shape = (n_dc, n_hosts, n_outages)
    mtbf = _f32(mtbf_s).broadcast_to((n_dc, n_hosts))[..., None]
    # durations stay finite: inf - inf in the sums below would give NaN
    mttr = _f32(mttr_s).broadcast_to((n_dc, n_hosts))[..., None].clamp(
        1e-6, 1e30)
    gaps = _exponential(gen, shape) * mtbf
    durs = _exponential(gen, shape) * mttr
    cum_durs = torch.cumsum(durs, dim=-1)
    fail = torch.cumsum(gaps, dim=-1) + (cum_durs - durs)
    never = (mtbf >= INF / 2).expand(shape)
    dev = resolve_device(device)
    return Outages(
        fail_t=torch.where(never, INF, fail.clamp_max(INF)).to(dev),
        repair_t=torch.where(never, INF, (fail + durs).clamp_max(INF)).to(dev),
    )


def no_outages(n_dc: int, n_hosts: int, n_outages: int = 1,
               device=None) -> Outages:
    """An all-INF schedule: hosts never fail, but the ``Outages`` attachment
    (and so the campaign's structure) matches a failing row's."""
    dev = resolve_device(device)
    shape = (n_dc, n_hosts, n_outages)
    return Outages(fail_t=torch.full(shape, INF, dtype=_F32, device=dev),
                   repair_t=torch.full(shape, INF, dtype=_F32, device=dev))


def poisson_arrivals(gen: torch.Generator, n: int, rate) -> Tensor:
    """[n] sorted arrival times of a homogeneous Poisson process."""
    return torch.cumsum(_exponential(gen, (n,)) / _f32(rate).clamp_min(1e-9),
                        dim=0)


def diurnal_arrivals(gen: torch.Generator, n: int, base_rate, amp=0.8,
                     period=1000.0, iters: int = 60) -> Tensor:
    """[n] arrivals of a Poisson process of intensity ``base_rate (1 + amp
    sin(2 pi t / period))``, ``0 <= amp < 1``: unit-rate arrivals S_k
    through the inverse of the cumulative intensity, by ``iters`` bisection
    steps on every arrival at once (no data-dependent control flow)."""
    base = _f32(base_rate).clamp_min(1e-9)
    amp = _f32(amp).clamp(0.0, 0.999)
    period = _f32(period).clamp_min(1e-6)
    s = torch.cumsum(_exponential(gen, (n,)), dim=0)

    def cum_intensity(t: Tensor) -> Tensor:
        osc = (1.0 - torch.cos(_TWO_PI * t / period)) * period / _TWO_PI
        return base * (t + amp * osc)

    # the cumulative intensity is at least base (1 - amp) t: an upper end
    lo = torch.zeros_like(s)
    hi = (s[-1] / (base * (1.0 - amp)) + period).expand(s.shape)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cum_intensity(mid) < s
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def bursty_arrivals(gen: torch.Generator, n_bursts: int, per_burst: int,
                    burst_rate, off_gap_mean) -> Tensor:
    """[n_bursts * per_burst] on/off arrivals: bursts of ``per_burst`` jobs
    at ``burst_rate`` separated by exponential off-gaps of mean
    ``off_gap_mean``; sorted by construction."""
    rate = _f32(burst_rate).clamp_min(1e-9)
    off = _f32(off_gap_mean).clamp_min(0.0)
    gaps = _exponential(gen, (n_bursts,)) * off
    intra = _exponential(gen, (n_bursts, per_burst)) / rate
    within = torch.cumsum(intra, dim=1)              # offsets inside a burst
    dur = within[:, -1]
    starts = torch.cumsum(gaps, dim=0) + torch.cat(
        [torch.zeros(1, dtype=_F32), torch.cumsum(dur, dim=0)[:-1]])
    return (starts[:, None] + within).reshape(-1)


def lognormal(gen: torch.Generator, n: int, median, sigma) -> Tensor:
    """[n] lognormal samples with the given median and log-space sigma."""
    z = torch.randn(n, dtype=_F32, generator=gen)
    return _f32(median) * torch.exp(_f32(sigma) * z)


def assemble_cloudlets(vm, length_mi, submit_t: Tensor, cores=1, input_mb=0.0,
                       output_mb=0.0, deadline=INF, input_dc=-1,
                       prompt_tokens=0.0, max_new_tokens=0.0,
                       device=None) -> Cloudlets:
    """A ``Cloudlets`` table on ``device``, rows stably sorted by submit
    time (FCFS is row order downstream); scalars broadcast."""
    n = submit_t.shape[0]
    order = torch.argsort(submit_t, stable=True)
    dev = resolve_device(device)

    def col(x, dtype) -> Tensor:
        return torch.as_tensor(x, dtype=dtype).broadcast_to((n,))[order].to(dev)

    return Cloudlets(
        vm=col(vm, torch.int32),
        length_mi=col(length_mi, _F32),
        cores=col(cores, torch.int32),
        submit_t=col(submit_t, _F32),
        input_mb=col(input_mb, _F32),
        input_dc=col(input_dc, torch.int32),
        output_mb=col(output_mb, _F32),
        deadline=col(deadline, _F32),
        prompt_tokens=col(prompt_tokens, _F32),
        max_new_tokens=col(max_new_tokens, _F32),
        exists=torch.ones(n, dtype=torch.bool, device=dev),
    )


def _arrivals(gen: torch.Generator, n: int, kind: str, rate, amp, period,
              n_bursts: int, off_gap_mean) -> Tensor:
    if kind == "poisson":
        return poisson_arrivals(gen, n, rate)
    if kind == "diurnal":
        return diurnal_arrivals(gen, n, rate, amp=amp, period=period)
    if kind == "bursty":
        if n % n_bursts:
            raise ValueError(f"n={n} not divisible by n_bursts={n_bursts}")
        return bursty_arrivals(gen, n_bursts, n // n_bursts, rate,
                               off_gap_mean)
    raise ValueError(f"unknown arrival kind {kind!r}")


def generate_cloudlets(gen: torch.Generator, n: int, *, kind: str = "poisson",
                       rate=1.0, amp=0.8, period=1000.0, n_bursts: int = 4,
                       off_gap_mean=500.0, median_mi=10_000.0, sigma_mi=0.5,
                       io_mb=0.0, sigma_io=0.5, n_vms: int | None = None,
                       cores: int = 1, deadline_rel=None,
                       device=None) -> Cloudlets:
    """One seeded dynamic workload as a ``Cloudlets`` table.

    Draws, in order: arrivals (``kind`` = poisson / diurnal / bursty; for
    bursty ``n`` divides into ``n_bursts`` and ``rate`` is the within-burst
    rate), lognormal lengths, then input and output sizes.  ``n_vms=None``
    emits broker-dispatched rows (``vm == -1``); an int routes round-robin.
    ``deadline_rel`` (seconds after submission) attaches SLA deadlines.
    """
    submit = _arrivals(gen, n, kind, rate, amp, period, n_bursts, off_gap_mean)
    length = lognormal(gen, n, median_mi, sigma_mi)
    io_scale, sig = _f32(io_mb), _f32(sigma_io)
    input_mb = io_scale * torch.exp(
        sig * torch.randn(n, dtype=_F32, generator=gen))
    output_mb = io_scale * torch.exp(
        sig * torch.randn(n, dtype=_F32, generator=gen))
    vm = (torch.full((n,), -1, dtype=torch.int32) if n_vms is None
          else torch.arange(n, dtype=torch.int32) % n_vms)
    deadline = INF if deadline_rel is None else submit + _f32(deadline_rel)
    return assemble_cloudlets(vm, length, submit, cores=cores,
                              input_mb=input_mb, output_mb=output_mb,
                              deadline=deadline, device=device)


def generate_serving_requests(gen: torch.Generator, n: int, *,
                              kind: str = "diurnal", rate=1.0, amp=0.8,
                              period=1000.0, n_bursts: int = 4,
                              off_gap_mean=500.0, median_prompt=128.0,
                              sigma_prompt=0.7, median_new=64.0,
                              sigma_new=0.6, max_new_cap=1024.0,
                              token_mi=10.0, sigma_token=0.2,
                              deadline_rel=None, device=None) -> Cloudlets:
    """One seeded LLM-inference request stream as serving ``Cloudlets``
    (DESIGN.md §14): arrivals as in ``generate_cloudlets``, then lognormal
    prompt and decode token counts (rounded up; decode clipped to
    ``max_new_cap``) and a lognormal per-token cost around ``token_mi``, so
    ``length_mi = max_new_tokens x per-token MI``.  Rows are
    broker-dispatched (``vm == -1``)."""
    submit = _arrivals(gen, n, kind, rate, amp, period, n_bursts, off_gap_mean)
    prompt = torch.ceil(
        lognormal(gen, n, median_prompt, sigma_prompt)).clamp_min(1.0)
    new = torch.minimum(
        torch.ceil(lognormal(gen, n, median_new, sigma_new)).clamp_min(1.0),
        _f32(max_new_cap))
    per_token = lognormal(gen, n, token_mi, sigma_token)
    deadline = INF if deadline_rel is None else submit + _f32(deadline_rel)
    return assemble_cloudlets(
        torch.full((n,), -1, dtype=torch.int32), new * per_token, submit,
        deadline=deadline, prompt_tokens=prompt, max_new_tokens=new,
        device=device)

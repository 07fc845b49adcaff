"""Simulation drivers over the batch-major event step (paper §4.1).

The port of ``repro.core.engine``.  CloudSim advances the world between
events: rates are piecewise-constant, so each sweep yields the next
completion time and the clock jumps straight to it (DESIGN.md §2).  The
reference's ``lax.while_loop`` becomes a Python loop over
``step.batch_event_step`` that ends when no row is live; its fixed-length
``lax.scan`` (``simulate_history``) becomes the same loop padded with the
invalid rows the reference emits after the end.  ``simulate_trace`` is
``simulate`` with a ``TraceInstrument`` attached, a pure observer: its
``SimResult`` is bitwise the untraced run's.

Every driver takes one scenario (``[D, H]`` hosts) or a stacked campaign
(``[B, D, H]``, see ``campaign.stack_scenarios``) and a ``device``: ``None``
means the GPU, and without one the caller must pass ``device="cpu"``.  One
scenario runs as the ``B = 1`` batch and comes back unbatched.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from repro_torch.core import energy, policies
from repro_torch.core.entities import (
    INF, Scenario, SimResult, SimState, TensorTree, resolve_device)
from repro_torch.core.step import (
    TraceInstrument, batch_event_step, finalize_result, host_any,
    make_context, ready_times, resolve_max_steps, step_cond)


def init_state(scn: Scenario) -> SimState:
    """Initial ``[B, ...]`` state of a batched scenario."""
    hosts, vms, cls = scn.hosts, scn.vms, scn.cloudlets
    B, D, _ = hosts.cores.shape
    V, C = vms.n_vms, cls.n_cloudlets
    dev = hosts.cores.device
    f32, i32 = torch.float32, torch.int32

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(value, *shape, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    exists = hosts.exists
    ready0 = torch.where(cls.vm >= 0, ready_times(scn), INF)
    if scn.topology is not None:
        # network stage-ins wait for the transfer phase to open them on the
        # link ledger; an idle ledger grants each link its full bandwidth
        ready0 = torch.where(cls.input_dc >= 0, INF, ready0)
        link_share0 = scn.topology.bw_mbps.float().clone()
    else:
        link_share0 = zeros(B, D, D)
    return SimState(
        t=zeros(B),
        step=zeros(B, dtype=i32),
        vm_host=full(-1, B, V, dtype=i32),
        vm_dc=vms.dc.to(i32).clone(),
        vm_placed=zeros(B, V, dtype=torch.bool),
        vm_failed=zeros(B, V, dtype=torch.bool),
        vm_evicted=zeros(B, V, dtype=torch.bool),
        vm_avail_t=full(INF, B, V),
        vm_released=zeros(B, V, dtype=torch.bool),
        vm_migrations=zeros(B, V, dtype=i32),
        vm_mig_src=full(-1, B, V, dtype=i32),
        pool_active=zeros(B, V, dtype=torch.bool),
        # a schedule that starts down flips this at the first event
        host_up=exists.clone(),
        free_ram=torch.where(exists, hosts.ram_mb, 0.0),
        free_storage=torch.where(exists, hosts.storage_mb, 0.0),
        free_bw=torch.where(exists, hosts.bw_mbps, 0.0),
        free_cores=torch.where(exists, hosts.cores.float(), 0.0),
        free_kv=torch.where(exists, hosts.kv_blocks, 0.0),
        cl_vm=cls.vm.to(i32).clone(),
        cl_ready_t=ready0,
        cl_admitted=zeros(B, C, dtype=torch.bool),
        cl_kv=zeros(B, C),
        rem_mi=torch.where(cls.exists, cls.length_mi, 0.0),
        cl_rollback_mi=zeros(B, C),
        started=zeros(B, C, dtype=torch.bool),
        start_t=full(INF, B, C),
        finish_t=torch.where(cls.exists, INF, -INF),  # ghosts count as finished
        cpu_time=zeros(B, C),
        sensed_load=zeros(B, D),
        last_tick=zeros(B),
        cpu_cost=zeros(B, D),
        ram_cost=zeros(B, D),
        storage_cost=zeros(B, D),
        bw_cost=zeros(B, D),
        energy_j=zeros(B, D),
        vm_downtime=zeros(B, V),
        n_evacuations=zeros(B, dtype=i32),
        link_busy=zeros(B, D, D, dtype=i32),
        link_share=link_share0,
        vm_xfer_src=full(-1, B, V, dtype=i32),
        vm_xfer_dst=full(-1, B, V, dtype=i32),
        vm_xfer_rem=zeros(B, V),
        vm_xfer_share=zeros(B, V),
        cl_xfer_dst=full(-1, B, C, dtype=i32),
        cl_xfer_rem=zeros(B, C),
        cl_xfer_share=zeros(B, C),
    )


def is_batched(scn: Scenario) -> bool:
    """A stacked campaign has ``[B, D, H]`` hosts; one scenario ``[D, H]``."""
    return scn.hosts.cores.dim() == 3


def scenario_row(scn: Scenario, i: int = 0) -> Scenario:
    """Row ``i`` of a stacked campaign."""
    return scn.map(lambda x: x[i])


def _as_batch(scn: Scenario, device) -> tuple[Scenario, bool]:
    """The scenario on ``device`` with a leading batch axis, and whether it
    was a single scenario (unbatch the outputs)."""
    scn = scn.to(resolve_device(device))
    if is_batched(scn):
        return scn, False
    return scn.map(lambda x: x.unsqueeze(0)), True


def _run(scn_b: Scenario, extra_instruments: tuple = (), on_step=None):
    """``while any(live)``: step every live row; returns the final carry,
    the context and the step budget."""
    ctx, aux = make_context(scn_b, extra_instruments)
    max_steps = resolve_max_steps(scn_b, ctx.instruments)
    carry = (init_state(scn_b), aux)
    while True:
        live = step_cond(scn_b, carry[0], max_steps)
        if not host_any(live):
            return carry, ctx, max_steps
        carry, ev, live = batch_event_step(scn_b, carry, ctx, live)
        if on_step is not None:
            on_step(carry[0], ev, live)


def simulate_instrumented(scn: Scenario, extra_instruments: tuple = (),
                          device=None) -> tuple[SimResult, dict]:
    """Run a simulation and collect instrument outputs by name.

    Instruments are the defaults, then ``Scenario.instruments``, then
    ``extra_instruments`` (whose tensor fields must lie on ``device``; a
    field without the batch axis is shared by every campaign row).  Outputs
    are ``{name: {key: tensor}}``, with a leading campaign axis for a
    stacked campaign.
    """
    scn_b, single = _as_batch(scn, device)
    (st, aux), ctx, _ = _run(scn_b, tuple(extra_instruments))
    res = finalize_result(scn_b, st)
    out = {}
    for ins, a in zip(ctx.instruments, aux):
        o = ins.finalize(scn_b, st, a)
        if o:
            out[ins.name] = {k: v[0] for k, v in o.items()} if single else o
    return (res.map(lambda x: x[0]) if single else res), out


def simulate(scn: Scenario, device=None) -> SimResult:
    """Run one simulation, or every row of a stacked campaign (per-row
    results bitwise those of the solo runs, DESIGN.md §10)."""
    res, _ = simulate_instrumented(scn, device=device)
    return res


def simulate_trace(scn: Scenario, sample_ts, device=None
                   ) -> tuple[SimResult, Tensor]:
    """Simulation plus the fraction of work done per cloudlet at each
    sample time (``[S, C]``, or ``[B, S, C]`` for a campaign), rows in
    ascending time order.  Mid-interval progress interpolates exactly
    under piecewise-constant rates, so no clock stop is added and the
    ``SimResult`` is bitwise ``simulate``'s."""
    dev = resolve_device(device)
    ts = torch.sort(torch.as_tensor(sample_ts, dtype=torch.float32)
                    .to(dev).reshape(-1)).values
    res, out = simulate_instrumented(scn, (TraceInstrument(sample_ts=ts),),
                                     device=dev)
    return res, out["trace"]["progress"]


def entry_points() -> dict:
    """The engine's public drivers, by stable name."""
    return {
        "simulate": simulate,
        "simulate_trace": simulate_trace,
        "simulate_history": simulate_history,
    }


@dataclass(frozen=True)
class History(TensorTree):
    """Fixed-length per-event log, leading axis ``max_steps`` (then the
    campaign axis for a batch).  Rows past the end have ``valid=False``,
    ``kind=-1`` and zeros."""

    t: Tensor            # [T] f32 clock after each event
    dt: Tensor           # [T] f32 interval length
    kind: Tensor         # [T] i32 step.K_* classification (-1: padding)
    valid: Tensor        # [T] bool event actually happened
    n_finished: Tensor   # [T] i32 cloudlets finished so far
    utilization: Tensor  # [T, D] f32 per-DC utilization during the interval
    cpu_cost: Tensor     # [T, D] f32 accrued CPU cost after the event
    bw_cost: Tensor      # [T, D] f32
    energy_j: Tensor     # [T, D] f32


def simulate_history(scn: Scenario, device=None) -> tuple[SimResult, History]:
    """Run a simulation emitting the full per-event log.

    The reference scans ``max_steps`` times; once no row is live every
    further step is an exact no-op emitting invalid rows, so the loop stops
    there and pads the log with those rows.
    """
    scn_b, single = _as_batch(scn, device)
    B, D = scn_b.market.cost_per_cpu_sec.shape
    dev = scn_b.hosts.cores.device
    i32 = torch.int32
    records = []

    def record(st: SimState, ev, live: Tensor):
        util = energy.dc_utilization(scn_b, st, vm_mips=ev.vm_mips)
        n_fin = (policies.cloudlet_finished(st)
                 & scn_b.cloudlets.exists).sum(-1, dtype=i32)
        row = live[:, None]
        records.append(History(
            t=torch.where(live, ev.t1, 0.0),
            dt=torch.where(live, ev.dt, 0.0),
            kind=torch.where(live, ev.kind, -1),
            valid=live,
            n_finished=torch.where(live, n_fin, 0),
            utilization=torch.where(row, util, 0.0),
            cpu_cost=torch.where(row, st.cpu_cost, 0.0),
            bw_cost=torch.where(row, st.bw_cost, 0.0),
            energy_j=torch.where(row, st.energy_j, 0.0),
        ))

    (st, _), _, max_steps = _run(scn_b, on_step=record)
    zeros_bd = torch.zeros(B, D, device=dev)
    blank = History(
        t=torch.zeros(B, device=dev), dt=torch.zeros(B, device=dev),
        kind=torch.full((B,), -1, dtype=i32, device=dev),
        valid=torch.zeros(B, dtype=torch.bool, device=dev),
        n_finished=torch.zeros(B, dtype=i32, device=dev),
        utilization=zeros_bd, cpu_cost=zeros_bd, bw_cost=zeros_bd,
        energy_j=zeros_bd,
    )
    records += [blank] * (max_steps - len(records))
    hist = History(**{
        name: torch.stack([getattr(r, name) for r in records])
        for name in History.__dataclass_fields__})
    res = finalize_result(scn_b, st)
    if single:
        return res.map(lambda x: x[0]), hist.map(lambda x: x[:, 0])
    return res, hist

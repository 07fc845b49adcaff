"""The batch-major event step (the port of ``repro.core.step``).

``batch_event_step`` advances a ``[B, ...]`` batch of scenarios by one event
each; one scenario is the ``B = 1`` case.  Its phases are the reference's
(DESIGN.md §10):

    prologue   instrument ``pre`` hooks (Sensor tick), release drained VMs
    provision  place due VM requests          } skipped when no live row
    dispatch   bind submitted service rows    } needs them: ``if x.any()``
    serving    KV-block ledger sweep          } (one host sync each)
    bound      per-cloudlet rates + next-event bound
    advance    the advance sweep on the whole [B, C] block: the CUDA kernel
               on the card, the plain version on the CPU
    commit     clock, completions, instrument ``post`` hooks (market, energy)

Rows whose ``step_cond`` is False are frozen: every write is row-gated by
``live``, so a row of a campaign is bitwise the scenario run alone.

Each phase skip reads one boolean on the host (``host_any``), as does the
driver's loop test; ``host_any.syncs`` counts them.  ``jax.lax.cond`` with
a scalar predicate becomes that read; ``vmap`` becomes the written-out batch
axis.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch
from torch import Tensor

from repro_torch.core import kvserve, policies, provision
from repro_torch.core.entities import INF, Scenario, SimResult, SimState
from repro_torch.core.segments import min_where, row_sum, scatter_add_, take
from repro_torch.kernels import ops

# Event kinds recorded by ``StepEvent.kind`` / ``History.kind``.
K_COMPLETION = 0   # a cloudlet ran out of work
K_READY = 1        # a submitted cloudlet finished stage-in
K_VM_REQUEST = 2   # a broker VM request came due
K_MIGRATION = 3    # a VM creation/migration transfer completed
K_TICK = 4         # a federation Sensor refresh
K_INSTRUMENT = 5   # a custom instrument clock stop
K_HORIZON = 6      # the simulation horizon
K_SCALE = 7        # an autoscaler evaluation tick
K_FAILURE = 8      # a scheduled host failure
K_REPAIR = 9       # a failed host came back
K_STAGE = 10       # a pending data stage-in became openable
K_SERVING = 11     # a decoding request crossed a KV-block boundary


def host_any(x: Tensor) -> bool:
    """``bool(x.any())``: one device-to-host read, counted in
    ``host_any.syncs``."""
    host_any.syncs += 1
    return bool(x.any())


host_any.syncs = 0


def default_max_steps(scn: Scenario) -> int:
    """Safety bound on event batches: starts + finishes + VM lifecycle +
    slack (no outage or topology terms: those scenarios are not ported)."""
    return 4 * (scn.cloudlets.n_cloudlets + scn.vms.n_vms) + 260


def resolve_max_steps(scn: Scenario, instruments: tuple = ()) -> int:
    """Scenario override or derived bound, plus the instruments' extras."""
    base = scn.max_steps if scn.max_steps > 0 else default_max_steps(scn)
    return base + sum(ins.extra_steps(scn) for ins in instruments)


def _eps_mi(length_mi: Tensor) -> Tensor:
    """Finish tolerance for float32 work counters (DESIGN.md §2)."""
    return 1e-5 * length_mi + 0.25


def _done_or_doomed(scn: Scenario, st: SimState) -> Tensor:
    fin = policies.cloudlet_finished(st)
    doomed = (st.cl_vm >= 0) & take(
        st.vm_failed, st.cl_vm.clamp(0, scn.vms.n_vms - 1))
    return fin | doomed | ~scn.cloudlets.exists


def step_cond(scn: Scenario, st: SimState, max_steps: int) -> Tensor:
    """[B] per-row loop continuation (the reference's ``step_cond``, and
    ``batch_live`` over a batch)."""
    return (
        (st.step < max_steps)
        & (st.t < scn.policy.horizon)
        & ~_done_or_doomed(scn, st).all(-1)
    )


def ready_times(scn: Scenario) -> Tensor:
    """[B, C] submit + SAN stage-in of fixed-binding rows."""
    cls, vms = scn.cloudlets, scn.vms
    vmi = cls.vm.clamp(0, vms.n_vms - 1)
    stage_in = torch.where(
        cls.input_mb > 0,
        cls.input_mb / take(vms.bw_mbps, vmi).clamp_min(1e-6), 0.0)
    remote = (cls.input_dc >= 0) & (cls.input_dc != take(vms.dc, vmi))
    stage_in = torch.where(
        remote,
        cls.input_mb / scn.policy.interdc_bw_mbps.clamp_min(1e-6)[:, None],
        stage_in)
    return cls.submit_t + stage_in


@dataclass(frozen=True)
class StepEvent:
    """What one step emitted, per row (``[B]`` scalars, ``[B, C]`` and
    ``[B, V]`` vectors).  Rates are constant over ``[t0, t1)``."""

    t0: Tensor
    t1: Tensor
    dt: Tensor
    kind: Tensor            # i32 K_* classification
    rate: Tensor            # [B,C] MIPS during the interval
    active: Tensor          # [B,C] executing during the interval
    rem_before: Tensor      # [B,C]
    newly_started: Tensor   # [B,C]
    newly_finished: Tensor  # [B,C]
    vm_mips: Tensor         # [B,V] host-level granted MIPS


class Instrument:
    """Base observable with the reference's five hooks, batch-major: every
    hook sees the ``[B, ...]`` scenario and state.  Only the three default
    instruments are ported; their aux states are empty."""

    name: str = "instrument"
    bound_kind: int = K_INSTRUMENT

    def init(self, scn: Scenario):
        return ()

    def extra_steps(self, scn: Scenario) -> int:
        return 0

    def pre(self, scn: Scenario, st: SimState, aux):
        return st, aux

    def bound(self, scn: Scenario, st: SimState, aux) -> Tensor:
        return torch.full_like(st.t, INF)

    def post(self, scn: Scenario, st: SimState, ev: StepEvent, aux):
        return st, aux

    def finalize(self, scn: Scenario, st: SimState, aux) -> dict:
        return {}


class SensorInstrument(Instrument):
    """Periodic, stale-by-design load sensing (paper §2.3): refresh
    ``sensed_load`` when a tick is due; the next tick is a clock stop."""

    name = "sensor"
    bound_kind = K_TICK

    def pre(self, scn, st, aux):
        pol = scn.policy
        tick_due = pol.federation & (st.t >= st.last_tick + pol.sensor_interval)
        st = st.replace(
            sensed_load=torch.where(
                tick_due[:, None], provision.sense_load(scn, st), st.sensed_load),
            last_tick=torch.where(tick_due, st.t, st.last_tick),
        )
        return st, aux

    def bound(self, scn, st, aux):
        pol = scn.policy
        return torch.where(pol.federation, st.last_tick + pol.sensor_interval, INF)


class MarketInstrument(Instrument):
    """Per-interval market accrual (paper §3.3): CPU-seconds while
    executing, bandwidth at cloudlet IO edges."""

    name = "market"

    def post(self, scn, st, ev, aux):
        cls, mkt = scn.cloudlets, scn.market
        B, D = st.cpu_cost.shape
        dc_of_cl = take(st.vm_dc, st.cl_vm.clamp(0, scn.vms.n_vms - 1))
        dc_seg = dc_of_cl.clamp(0, D - 1)
        run_cost = torch.where(
            ev.active, ev.dt[:, None] * take(mkt.cost_per_cpu_sec, dc_seg), 0.0)
        io_mb = (torch.where(ev.newly_started, cls.input_mb, 0.0)
                 + torch.where(ev.newly_finished, cls.output_mb, 0.0))
        io_cost = io_mb * take(mkt.cost_per_bw_mb, dc_seg)
        # scatter-add into the running totals, in row order (segments.py)
        at = (dc_seg + torch.arange(B, device=dc_seg.device)[:, None] * D).reshape(-1)

        def accrue(total: Tensor, amount: Tensor) -> Tensor:
            flat = total.reshape(-1).clone()
            return scatter_add_(flat, at, amount.reshape(-1)).view(B, D)

        return st.replace(cpu_cost=accrue(st.cpu_cost, run_cost),
                          bw_cost=accrue(st.bw_cost, io_cost)), aux


class EnergyInstrument(Instrument):
    """Integrate P(t) dt per DC under the linear power model; a no-op
    without ``Scenario.power``."""

    name = "energy"

    def post(self, scn, st, ev, aux):
        if scn.power is None:
            return st, aux
        from repro_torch.core import energy

        watts = energy.power_draw(scn, st, vm_mips=ev.vm_mips)
        return st.replace(energy_j=st.energy_j + watts * ev.dt[:, None]), aux


def default_instruments() -> tuple[Instrument, ...]:
    return (SensorInstrument(), MarketInstrument(), EnergyInstrument())


@dataclass(frozen=True)
class StepContext:
    """Loop-invariant context resolved once per driver: the instruments,
    the event kind of each next-event candidate, the advance sweep for the
    scenario's device, and whether any row carries serving rows (the
    serving phase's predicate reads the scenario only)."""

    instruments: tuple
    cand_kinds: Tensor
    advance: Callable
    serving: bool


def make_context(scn: Scenario) -> tuple[StepContext, tuple]:
    """Step context + initial instrument aux states for a batch driver."""
    instruments = default_instruments()
    device = scn.hosts.cores.device
    ctx = StepContext(
        instruments=instruments,
        cand_kinds=_cand_kinds(instruments, device),
        advance=ops.resolve_advance(device),
        serving=host_any(kvserve.serving_needed(scn)),
    )
    return ctx, tuple(ins.init(scn) for ins in instruments)


def _provision_needed(scn: Scenario, st: SimState) -> Tensor:
    """[B] any due, unplaced, unfailed VM request (the ``due`` mask of
    ``provision.provision_due_vms``)."""
    vms = scn.vms
    due = (
        vms.exists & ~st.vm_placed & ~st.vm_failed
        & (vms.request_t <= st.t[:, None]) & (~vms.pool | st.pool_active)
    )
    return due.any(-1)


def _dispatch_needed(scn: Scenario, st: SimState) -> Tensor:
    """[B] any submitted service-routed cloudlet still unbound."""
    cls = scn.cloudlets
    return (cls.exists & (st.cl_vm < 0) & (cls.submit_t <= st.t[:, None])).any(-1)


def _phase_prologue(scn: Scenario, st: SimState, aux: tuple,
                    instruments: tuple) -> tuple[SimState, tuple]:
    """Outage edges and transfer settling (no-ops on this slice), instrument
    ``pre`` hooks, release of drained VMs."""
    st = provision.apply_outages(scn, st)
    st = provision.settle_transfers(scn, st)
    aux = list(aux)
    for i, ins in enumerate(instruments):
        st, aux[i] = ins.pre(scn, st, aux[i])
    st = provision.release_done_vms(scn, st)
    return st, tuple(aux)


def _cand_kinds(instruments: tuple, device) -> Tensor:
    """Event kinds aligned with ``_phase_bound``'s candidate times (built
    once per driver: a host-to-device copy waits for the stream)."""
    kinds = [K_READY, K_READY, K_VM_REQUEST, K_MIGRATION, K_SERVING]
    kinds += [ins.bound_kind for ins in instruments]
    kinds.append(K_HORIZON)
    return torch.tensor(kinds, dtype=torch.int32, device=device)


def _phase_bound(scn: Scenario, st: SimState, aux: tuple, instruments: tuple):
    """Policy sweep + next-event bound: (rate, vm_mips, active, bound_dt,
    cand_ts)."""
    pol, cls, vms = scn.policy, scn.cloudlets, scn.vms
    t = st.t[:, None]

    rate, vm_mips = policies.cloudlet_rates(scn, st)
    active = rate > 0

    unready = cls.exists & (st.cl_ready_t > t)
    undispatched = cls.exists & (st.cl_vm < 0) & (cls.submit_t > t)
    unplaced = (
        vms.exists & ~st.vm_placed & ~st.vm_failed & ~st.vm_evicted
        & (~vms.pool | st.pool_active)
    )
    migrating = vms.exists & st.vm_placed & (st.vm_avail_t > t)
    cand_t = [
        min_where(st.cl_ready_t, unready),
        min_where(cls.submit_t, undispatched),
        min_where(vms.request_t, unplaced),
        min_where(st.vm_avail_t, migrating),
        kvserve.serving_bound(scn, st, rate),
    ]
    for i, ins in enumerate(instruments):
        cand_t.append(ins.bound(scn, st, aux[i]))
    cand_t.append(pol.horizon)
    cand_ts = torch.stack(cand_t, dim=-1)
    bound_dt = (cand_ts.amin(-1) - st.t).clamp_min(0.0)
    return rate, vm_mips, active, bound_dt, cand_ts


def _phase_commit(scn: Scenario, st: SimState, aux: tuple, ctx: StepContext,
                  rate: Tensor, vm_mips: Tensor, active: Tensor,
                  cand_ts: Tensor, dt: Tensor, new_rem: Tensor):
    """State update after the advance sweep + instrument ``post`` hooks."""
    cls = scn.cloudlets
    t_next = st.t + dt

    newly_started = active & ~st.started
    newly_fin = active & (new_rem <= _eps_mi(cls.length_mi))
    new_rem = torch.where(newly_fin, 0.0, new_rem)

    kind = torch.where(newly_fin.any(-1), K_COMPLETION,
                       ctx.cand_kinds[cand_ts.argmin(-1)])
    ev = StepEvent(
        t0=st.t, t1=t_next, dt=dt, kind=kind, rate=rate, active=active,
        rem_before=st.rem_mi, newly_started=newly_started,
        newly_finished=newly_fin, vm_mips=vm_mips,
    )
    st = st.replace(
        t=t_next,
        step=st.step + 1,
        rem_mi=new_rem,
        started=st.started | newly_started,
        start_t=torch.where(newly_started, st.t[:, None], st.start_t),
        finish_t=torch.where(newly_fin, t_next[:, None], st.finish_t),
        cpu_time=st.cpu_time + torch.where(active, dt[:, None], 0.0),
    )
    aux = list(aux)
    for i, ins in enumerate(ctx.instruments):
        st, aux[i] = ins.post(scn, st, ev, aux[i])
    return (st, tuple(aux)), ev


def _freeze(live: Tensor, new, old):
    """Per-leaf row select: live rows take the stepped value, the others
    stay bitwise at their old one."""
    if isinstance(new, Tensor):
        return torch.where(live.view((-1,) + (1,) * (new.dim() - 1)), new, old)
    if isinstance(new, tuple):
        return tuple(_freeze(live, a, b) for a, b in zip(new, old))
    return new.replace(**{
        f.name: _freeze(live, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(new)})


def batch_event_step(scn_b: Scenario, carry: tuple[SimState, tuple],
                     ctx: StepContext, live: Tensor):
    """Advance every live row of a ``[B, ...]`` batch by one event.

    ``live`` is ``step_cond`` of the carry's state (the driver computed it
    for its loop test).  Returns ``(carry', StepEvent, live)``; dead rows'
    event fields are garbage and must be masked with ``live``.
    """
    st_b, aux_b = carry
    instruments = ctx.instruments

    st1, aux1 = _phase_prologue(scn_b, st_b, aux_b, instruments)

    st2 = st1
    if host_any(_provision_needed(scn_b, st1) & live):
        st2, _ = provision.provision_due_vms(scn_b, st1)
    st3 = st2
    if host_any(_dispatch_needed(scn_b, st2) & live):
        st3 = provision.dispatch_cloudlets(scn_b, st2)
    if ctx.serving:
        st3 = kvserve.serving_phase(scn_b, st3)

    rate, vm_mips, active, bound_dt, cand_ts = _phase_bound(
        scn_b, st3, aux1, instruments)

    # the advance sweep on the whole [B, C] block
    dt, new_rem = ctx.advance(st3.rem_mi, rate, active, bound_dt)

    (st4, aux2), ev = _phase_commit(
        scn_b, st3, aux1, ctx, rate, vm_mips, active, cand_ts, dt, new_rem)
    return _freeze(live, (st4, aux2), (st_b, aux_b)), ev, live


def _masked_pct(x: Tensor, mask: Tensor, q: float) -> Tensor:
    """[B] nearest-rank percentile of ``x`` over ``mask``; INF when empty."""
    xs = torch.sort(torch.where(mask, x, INF), dim=-1).values
    k = mask.sum(-1, dtype=torch.int32)
    idx = (torch.ceil(q * k.float()).int() - 1).clamp(0, x.shape[-1] - 1)
    return torch.where(k > 0, take(xs, idx[:, None])[:, 0], INF)


def finalize_result(scn: Scenario, st: SimState) -> SimResult:
    """Assemble the reported outcome from a final ``[B, ...]`` state."""
    cls = scn.cloudlets
    i32 = torch.int32
    fin = policies.cloudlet_finished(st) & cls.exists
    tat = torch.where(fin, st.finish_t - cls.submit_t, INF)
    n_fin = fin.sum(-1, dtype=i32)
    mean_tat = row_sum(torch.where(fin, tat, 0.0)) / n_fin.clamp_min(1)
    makespan = -min_where(-st.finish_t, fin)
    total_cost = row_sum(st.cpu_cost + st.ram_cost + st.storage_cost + st.bw_cost)
    sfin = fin & (cls.prompt_tokens > 0.0)
    ttft = torch.where(sfin, st.start_t - cls.submit_t, INF)
    tpot = torch.where(
        sfin, (st.finish_t - st.start_t) / cls.max_new_tokens.clamp_min(1.0), INF)
    return SimResult(
        finish_t=st.finish_t,
        start_t=st.start_t,
        cl_vm=st.cl_vm,
        turnaround=tat,
        makespan=makespan,
        mean_turnaround=mean_tat,
        n_finished=n_fin,
        n_events=st.step,
        n_migrations=st.vm_migrations.sum(-1, dtype=i32),
        vm_placed=st.vm_placed,
        vm_dc=st.vm_dc,
        vm_failed=st.vm_failed,
        cpu_cost=st.cpu_cost,
        ram_cost=st.ram_cost,
        storage_cost=st.storage_cost,
        bw_cost=st.bw_cost,
        energy_j=st.energy_j,
        total_cost=total_cost,
        end_t=st.t,
        sla_violations=policies.sla_violation_mask(scn, st).sum(-1, dtype=i32),
        downtime=row_sum(st.vm_downtime),
        n_evacuations=st.n_evacuations,
        ttft_p50=_masked_pct(ttft, sfin, 0.50),
        ttft_p99=_masked_pct(ttft, sfin, 0.99),
        tpot_p50=_masked_pct(tpot, sfin, 0.50),
        tpot_p99=_masked_pct(tpot, sfin, 0.99),
    )

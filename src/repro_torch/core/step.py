"""The batch-major event step (the port of ``repro.core.step``).

``batch_event_step`` advances a ``[B, ...]`` batch of scenarios by one event
each; one scenario is the ``B = 1`` case.  Its phases are the reference's
(DESIGN.md §10):

    prologue   host failure/repair edges, settling of finished link
               transfers, instrument ``pre`` hooks (Sensor tick,
               autoscaler, migration and evacuation coordinators), release
               of drained VMs
    provision  place due VM requests          } skipped when no live row
    dispatch   bind submitted service rows    } needs them: ``if x.any()``
    transfer   open stage-ins, re-time shared } (one host sync each; the
               links (topology only)          } transfer phase applies per
                                              } row, see ``_transfer``)
    serving    KV-block ledger sweep
    bound      per-cloudlet rates + next-event bound
    advance    the advance sweep on the whole [B, C] block: the CUDA kernel
               on the card, the plain version on the CPU
    commit     clock, completions, downtime, instrument ``post`` hooks
               (market, energy, trace sampling)

Rows whose ``step_cond`` is False are frozen: every write is row-gated by
``live``, so a row of a campaign is bitwise the scenario run alone.

Each phase skip reads one boolean on the host (``host_any``), as does the
driver's loop test; ``host_any.syncs`` counts them.  ``jax.lax.cond`` with
a scalar predicate becomes that read; ``vmap`` becomes the written-out batch
axis.  The instruments' per-row decisions (which pool VM to activate, which
VM to move where) are masked tensor ops over ``[B, ...]``, with ties broken
at the lowest index as the reference's ``argmin`` / ``argmax`` break them;
none of them reads a value on the host.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import Tensor

from repro_torch.core import energy, kvserve, policies, provision, segments
from repro_torch.core.entities import (
    INF, Scenario, SimResult, SimState, TensorTree)
from repro_torch.core.segments import min_where, row_sum, take
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
    slack, plus an outage schedule's fail/repair edges and per-edge
    eviction/evacuation slack, plus a K_STAGE open and a K_READY arrival
    per cloudlet under a topology (fair-share recomputes may also split
    coincident completions)."""
    extra = 0
    if scn.outages is not None:
        n_out = math.prod(scn.outages.fail_t.shape[-3:])
        extra = 4 * n_out + 2 * scn.vms.n_vms
    if scn.topology is not None:
        extra += 2 * scn.cloudlets.n_cloudlets
    return 4 * (scn.cloudlets.n_cloudlets + scn.vms.n_vms) + 260 + extra


def resolve_max_steps(scn: Scenario, instruments: tuple = ()) -> int:
    """Scenario override or derived bound, plus the instruments' extras."""
    base = scn.max_steps if scn.max_steps > 0 else default_max_steps(scn)
    return base + sum(ins.extra_steps(scn) for ins in instruments)


def _eps_mi(length_mi: Tensor) -> Tensor:
    """Finish tolerance for float32 work counters (DESIGN.md §2)."""
    return 1e-5 * length_mi + 0.25


def _at(x: Tensor, i: Tensor) -> Tensor:
    """``x[b, i[b]]``: one entry per row of ``[B, N]`` at a ``[B]`` index."""
    return take(x, i.unsqueeze(-1)).squeeze(-1)


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
    """[B, C] submit + SAN stage-in of fixed-binding rows.  Remote inputs
    bill the flat ``interdc_bw_mbps`` divisor; under a topology
    ``engine.init_state`` sets them to INF instead and the transfer phase
    prices the move on the link ledger."""
    cls, vms = scn.cloudlets, scn.vms
    vmi = cls.vm.clamp(0, vms.n_vms - 1)
    stage_in = torch.where(
        cls.input_mb > 0,
        cls.input_mb / take(vms.bw_mbps, vmi).clamp_min(1e-6), 0.0)
    if scn.topology is None:
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
    hook sees the ``[B, ...]`` scenario and state, and its aux state holds
    ``[B, ...]`` tensors.  ``pre`` may rewrite the state before the policy
    sweep, ``bound`` returns a ``[B]`` absolute clock stop, ``post``
    observes the emitted ``StepEvent``, ``finalize`` turns the final aux
    into ``{name: [B, ...]}`` outputs.  An instrument with tensor fields is
    a frozen ``TensorTree`` dataclass, so a campaign stacks those fields
    with the scenario; a field given without the batch axis (a driver's
    extra instrument) is shared by every row."""

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
    executing, bandwidth at cloudlet IO edges.

    Each event's charges are summed per DC first and then added to the
    running totals, one add a DC an event.  Scattered one by one into the
    totals (the reference's ``.at[dc].add``), each rounds against a growing
    total, and the result hangs on the order of the additions, which the
    card and the CPU do not share (``segments.py``): reversing that order
    moves ``cpu_cost`` by 2.7e-5 over a 1,208-event reliability row at
    10,000 hosts, past the rtol 1e-5 the card is held to against the CPU.
    Summed per event first, the orders differ only in a step sum's last
    bits."""

    name = "market"

    def post(self, scn, st, ev, aux):
        cls, mkt = scn.cloudlets, scn.market
        D = st.cpu_cost.shape[-1]
        dc_seg = take(st.vm_dc, st.cl_vm.clamp(0, scn.vms.n_vms - 1)).clamp(
            0, D - 1)
        run_cost = torch.where(
            ev.active, ev.dt[:, None] * take(mkt.cost_per_cpu_sec, dc_seg), 0.0)
        io_mb = (torch.where(ev.newly_started, cls.input_mb, 0.0)
                 + torch.where(ev.newly_finished, cls.output_mb, 0.0))
        io_cost = io_mb * take(mkt.cost_per_bw_mb, dc_seg)
        return st.replace(
            cpu_cost=st.cpu_cost + segments.segment_sum(run_cost, dc_seg, D),
            bw_cost=st.bw_cost + segments.segment_sum(io_cost, dc_seg, D)), aux


class EnergyInstrument(Instrument):
    """Integrate P(t) dt per DC under the linear power model; a no-op
    without ``Scenario.power``."""

    name = "energy"

    def post(self, scn, st, ev, aux):
        if scn.power is None:
            return st, aux
        watts = energy.power_draw(scn, st, vm_mips=ev.vm_mips)
        return st.replace(energy_j=st.energy_j + watts * ev.dt[:, None]), aux


def _batch(scn: Scenario) -> tuple[int, torch.device]:
    return scn.policy.horizon.shape[0], scn.policy.horizon.device


@dataclass(frozen=True)
class AutoscaleInstrument(TensorTree, Instrument):
    """Threshold-based horizontal scaling over the pre-declared VM pool
    (DESIGN.md §7).  Every ``sensor_interval`` (a ``K_SCALE`` clock stop)
    it reads per-DC demand utilization: demand above ``scale_up_thresh`` at
    two consecutive ticks activates the lowest-index inactive pool VM of
    that DC; demand below ``scale_down_thresh`` releases the lowest-index
    idle booted pool VM of that DC.  ``Policy.autoscale`` gates it all."""

    name = "autoscale"
    bound_kind = K_SCALE

    def init(self, scn):
        B, dev = _batch(scn)
        D = scn.hosts.n_dc
        return (
            torch.zeros(B, device=dev),                       # last evaluation
            torch.zeros(B, D, dtype=torch.bool, device=dev),  # over last tick
            torch.zeros(B, dtype=torch.int32, device=dev),    # activations
            torch.zeros(B, dtype=torch.int32, device=dev),    # releases
        )

    def pre(self, scn, st, aux):
        last_t, over_prev, n_up, n_down = aux
        pol, vms = scn.policy, scn.vms
        V, D = vms.n_vms, scn.hosts.n_dc
        due = pol.autoscale & (st.t >= last_t + pol.sensor_interval)   # [B]
        util = provision.demand_load(scn, st)                          # [B,D]
        over = util > pol.scale_up_thresh[:, None]
        under = util < pol.scale_down_thresh[:, None]
        rows = torch.arange(V, device=util.device).expand(st.vm_dc.shape)

        # scale up: sustained pressure activates one inactive pool row per DC
        want_up = due[:, None] & over & over_prev                      # [B,D]
        cand_up = (
            vms.pool & vms.exists & ~st.pool_active & ~st.vm_placed
            & ~st.vm_failed & take(want_up, vms.dc)
        )
        first_up = segments.segment_min(
            torch.where(cand_up, rows, V), vms.dc, D, fill=V)
        act = cand_up & (rows == take(first_up, vms.dc))

        # scale down: one idle booted pool row per under-pressure DC
        dc_now = st.vm_dc.clamp(0, D - 1)
        seg = torch.where(scn.cloudlets.exists & (st.cl_vm >= 0), st.cl_vm, V)
        busy = segments.segment_sum(
            (~policies.cloudlet_finished(st)).float(), seg, V) > 0
        cand_down = (
            vms.pool & st.pool_active & st.vm_placed & ~st.vm_released
            & (st.vm_avail_t <= st.t[:, None]) & ~busy
            & take(due[:, None] & under, dc_now)
        )
        first_down = segments.segment_min(
            torch.where(cand_down, rows, V), dc_now, D, fill=V)
        rel = cand_down & (rows == take(first_down, dc_now))

        st = provision.release_pool_vms(scn, st, rel)
        st = st.replace(pool_active=st.pool_active | act)
        aux = (
            torch.where(due, st.t, last_t),
            torch.where(due[:, None], over, over_prev),
            n_up + act.sum(-1, dtype=torch.int32),
            n_down + rel.sum(-1, dtype=torch.int32),
        )
        return st, aux

    def bound(self, scn, st, aux):
        pol = scn.policy
        return torch.where(pol.autoscale, aux[0] + pol.sensor_interval, INF)

    def finalize(self, scn, st, aux):
        return {"n_scale_up": aux[2], "n_scale_down": aux[3]}


@dataclass(frozen=True)
class MigrationInstrument(TensorTree, Instrument):
    """Runtime (live) VM migration across federated datacenters (DESIGN.md
    §8).  At every sensor tick (a ``K_TICK`` clock stop) the coordinator
    commits at most one move per row: load balancing sheds the busiest VM
    of the most-loaded DC above ``migrate_balance_thresh`` to the
    least-loaded feasible peer when that strictly shrinks the pair's spread
    (no ping-pong); otherwise consolidation drains the idlest VM of the
    least-loaded DC below ``migrate_consolidate_thresh`` toward the busiest
    strictly busier feasible peer.  ``Policy.federation &
    Policy.live_migration`` gate it all."""

    name = "migration"
    bound_kind = K_TICK

    def init(self, scn):
        B, dev = _batch(scn)
        return (
            torch.zeros(B, device=dev),                     # last evaluation
            torch.zeros(B, dtype=torch.int32, device=dev),  # balance moves
            torch.zeros(B, dtype=torch.int32, device=dev),  # consolidations
        )

    def pre(self, scn, st, aux):
        last_t, n_bal, n_con = aux
        pol, vms = scn.policy, scn.vms
        D = scn.hosts.n_dc
        enabled = pol.federation & pol.live_migration
        due = enabled & (st.t >= last_t + pol.sensor_interval)

        st = _clear_arrived_moves(st)

        util = provision.demand_load(scn, st)                          # [B,D]
        cap = provision.dc_capacity_mips(scn).clamp_min(1e-9)          # [B,D]
        outstanding = policies.vm_outstanding_mi(scn, st)              # [B,V]
        demand = policies.vm_demand_mips(scn, st)                      # [B,V]
        movable = (
            vms.exists & st.vm_placed & ~st.vm_failed & ~st.vm_released
            & (st.vm_avail_t <= st.t[:, None])
        )
        dc_of = st.vm_dc.clamp(0, D - 1)
        has_movable = segments.segment_sum(movable.float(), dc_of, D) > 0
        dcs = torch.arange(D, device=util.device)

        # --- load balancing: loaded source sheds its busiest VM ---
        src_ok_b = has_movable & (util > pol.migrate_balance_thresh[:, None])
        src_b = torch.where(src_ok_b, util, -torch.inf).argmax(-1)
        v_b = torch.where(movable & (dc_of == src_b[:, None]), outstanding,
                          -torch.inf).argmax(-1)
        dst_ok_b = (provision.slot_feasible(scn, st, v_b).any(-1)
                    & (dcs != src_b[:, None]))
        dst_b = torch.where(dst_ok_b, util, torch.inf).argmin(-1)
        # improvement rule: the move must strictly shrink the pair's spread
        util_src = _at(util, src_b)
        spread_after = torch.maximum(
            util_src - _at(demand, v_b) / _at(cap, src_b),
            _at(util, dst_b) + _at(demand, v_b) / _at(cap, dst_b),
        )
        bal_ok = (due & src_ok_b.any(-1) & dst_ok_b.any(-1)
                  & (spread_after < util_src - 1e-6))

        # --- consolidation: idle source drains toward a busier peer ---
        src_ok_c = has_movable & (
            util < pol.migrate_consolidate_thresh[:, None])
        src_c = torch.where(src_ok_c, util, torch.inf).argmin(-1)
        v_c = torch.where(movable & (dc_of == src_c[:, None]), outstanding,
                          torch.inf).argmin(-1)
        dst_ok_c = (
            provision.slot_feasible(scn, st, v_c).any(-1)
            & (dcs != src_c[:, None])
            & (util > _at(util, src_c)[:, None] + 1e-6)  # strictly busier
        )
        dst_c = torch.where(dst_ok_c, util, -torch.inf).argmax(-1)
        con_ok = due & src_ok_c.any(-1) & dst_ok_c.any(-1) & ~bal_ok

        v = torch.where(bal_ok, v_b, v_c)
        dst = torch.where(bal_ok, dst_b, dst_c)
        st, moved = provision.live_migrate(scn, st, v, dst, bal_ok | con_ok)
        aux = (
            torch.where(due, st.t, last_t),
            n_bal + (moved & bal_ok).int(),
            n_con + (moved & con_ok).int(),
        )
        return st, aux

    def bound(self, scn, st, aux):
        pol = scn.policy
        return torch.where(pol.federation & pol.live_migration,
                           aux[0] + pol.sensor_interval, INF)

    def finalize(self, scn, st, aux):
        return {"n_balance": aux[1], "n_consolidate": aux[2]}


def _clear_arrived_moves(st: SimState) -> SimState:
    """Reset the pending-move marker of transfers that have landed (shared
    by every instrument that commits ``provision.live_migrate`` moves)."""
    arrived = (st.vm_mig_src >= 0) & (st.vm_avail_t <= st.t[:, None])
    return st.replace(vm_mig_src=torch.where(arrived, -1, st.vm_mig_src))


def _evac_candidate(scn: Scenario, st: SimState):
    """``(v, dst_dc, safe, ok)`` per row: the usable VM with the most
    outstanding work on a host scheduled to fail within ``evac_lead_s``,
    bound for the least-loaded federation peer with a safe free slot
    (``safe`` is the ``[B, D, H]`` landing mask).  Shared by
    ``ReliabilityInstrument.pre`` (the commit) and ``.bound`` (the clock
    stop that keeps the drain going), so they never disagree."""
    pol, vms, hosts = scn.policy, scn.vms, scn.hosts
    B, D, H = hosts.cores.shape
    nf = scn.outages.next_fail_after(st.t)                          # [B,D,H]
    doomed = (hosts.exists & st.host_up
              & (nf <= (st.t + pol.evac_lead_s)[:, None, None]))
    at = st.vm_dc.clamp(0, D - 1) * H + st.vm_host.clamp(0, H - 1)
    cand = (
        vms.exists & st.vm_placed & ~st.vm_released & ~st.vm_failed
        & (st.vm_avail_t <= st.t[:, None]) & take(doomed.reshape(B, D * H), at)
    )
    outstanding = policies.vm_outstanding_mi(scn, st)
    v = torch.where(cand, outstanding, -torch.inf).argmax(-1)
    # a peer DC with a free slot on a host neither down nor itself doomed
    safe = provision.slot_feasible(scn, st, v) & ~doomed
    dcs = torch.arange(D, device=v.device)
    dst_ok = safe.any(-1) & (dcs != _at(st.vm_dc, v).clamp(0, D - 1)[:, None])
    util = provision.demand_load(scn, st)
    dst = torch.where(dst_ok, util, torch.inf).argmin(-1)
    ok = pol.federation & pol.evacuation & cand.any(-1) & dst_ok.any(-1)
    return v, dst, safe, ok


@dataclass(frozen=True)
class ReliabilityInstrument(TensorTree, Instrument):
    """Proactive evacuation ahead of scheduled host failures (DESIGN.md §9).

    The failure semantics (edges, eviction, rollback, downtime) live in the
    engine (``provision.apply_outages``).  This instrument's ``bound`` is an
    alarm ``evac_lead_s`` before each host's next failure, and a zero-length
    clock stop while a usable VM still sits on a doomed host with a safe
    peer; ``pre`` commits one such move per event through
    ``provision.live_migrate`` and counts it in ``n_evacuations``.
    ``Policy.federation & Policy.evacuation`` gate it; without
    ``Scenario.outages`` it does nothing."""

    name = "reliability"

    def pre(self, scn, st, aux):
        if scn.outages is None:
            return st, aux
        st = _clear_arrived_moves(st)
        v, dst, safe, ok = _evac_candidate(scn, st)
        st, moved = provision.live_migrate(scn, st, v, dst, ok, host_ok=safe)
        return st.replace(n_evacuations=st.n_evacuations + moved.int()), aux

    def bound(self, scn, st, aux):
        if scn.outages is None:
            return torch.full_like(st.t, INF)
        pol, hosts = scn.policy, scn.hosts
        nf = torch.where(hosts.exists & st.host_up,
                         scn.outages.next_fail_after(st.t), INF)
        alarm = torch.where(nf < INF / 2, nf - pol.evac_lead_s[:, None, None],
                            INF).flatten(1).amin(-1)
        future = torch.where(alarm > st.t, alarm, INF)
        # more to drain right now: stop the clock (dt = 0), one move an event
        _, _, _, ok_now = _evac_candidate(scn, st)
        return torch.where(pol.federation & pol.evacuation,
                           torch.where(ok_now, st.t, future), INF)


def _sample_times(ts: Tensor, B: int) -> Tensor:
    """``[B, S]`` sample times from a shared ``[S]`` or per-row ``[B, S]``."""
    return ts.expand(B, ts.shape[-1])


@dataclass(frozen=True)
class TraceInstrument(TensorTree, Instrument):
    """Per-cloudlet progress fractions at ``sample_ts``, a pure observer.

    Rates are constant over each event interval, so progress at a sample
    time inside it interpolates exactly: rem(s) = rem(t0) - rate (s - t0).
    No clock stop is added, so a traced run's ``SimResult`` is bitwise the
    untraced run's.  Output rows follow ``sample_ts`` as given."""

    name = "trace"

    sample_ts: Tensor   # [S] (or [B, S]) f32 absolute sample times

    def init(self, scn):
        B, dev = _batch(scn)
        S, C = self.sample_ts.shape[-1], scn.cloudlets.n_cloudlets
        return (torch.zeros(B, S, C, device=dev),
                torch.zeros(B, S, dtype=torch.bool, device=dev))

    def post(self, scn, st, ev, aux):
        prog, recorded = aux
        ts = _sample_times(self.sample_ts, prog.shape[0])
        length = scn.cloudlets.length_mi
        dt_s = torch.minimum((ts - ev.t0[:, None]).clamp_min(0.0),
                             ev.dt[:, None])                           # [B,S]
        rem0 = ev.rem_before[:, None, :]
        depleted = ev.rate[:, None, :] * dt_s[:, :, None]              # [B,S,C]
        rem_s = torch.where(ev.active[:, None, :],
                            (rem0 - depleted).clamp_min(0.0), rem0)
        frac = 1.0 - rem_s / length.clamp_min(1e-9)[:, None, :]
        hit = ~recorded & (ts <= ev.t1[:, None])
        return st, (torch.where(hit[..., None], frac, prog), recorded | hit)

    def finalize(self, scn, st, aux):
        prog, recorded = aux
        # samples past the last event see the frozen final state exactly
        final = 1.0 - st.rem_mi / scn.cloudlets.length_mi.clamp_min(1e-9)
        return {"progress": torch.where(recorded[..., None], prog,
                                        final[:, None, :])}


@dataclass(frozen=True)
class UtilizationTimelineInstrument(TensorTree, Instrument):
    """Per-DC utilization sampled at ``sample_ts`` (Figure 9/10-style)."""

    name = "utilization"

    sample_ts: Tensor   # [S] (or [B, S]) f32

    def init(self, scn):
        B, dev = _batch(scn)
        S = self.sample_ts.shape[-1]
        return (torch.zeros(B, S, scn.hosts.n_dc, device=dev),
                torch.zeros(B, S, dtype=torch.bool, device=dev))

    def post(self, scn, st, ev, aux):
        util_tl, recorded = aux
        util = energy.dc_utilization(scn, st, vm_mips=ev.vm_mips)     # [B,D]
        ts = _sample_times(self.sample_ts, util.shape[0])
        hit = ~recorded & (ts <= ev.t1[:, None])
        util_tl = torch.where(hit[..., None], util[:, None, :], util_tl)
        return st, (util_tl, recorded | hit)

    def finalize(self, scn, st, aux):
        util_tl, recorded = aux
        final = energy.dc_utilization(scn, st)
        return {"utilization": torch.where(recorded[..., None], util_tl,
                                           final[:, None, :])}


def default_instruments() -> tuple[Instrument, ...]:
    return (SensorInstrument(), MarketInstrument(), EnergyInstrument())


def instruments_for(scn: Scenario, extra_instruments: tuple = ()
                    ) -> tuple[Instrument, ...]:
    """The instruments a driver threads through the loop, in accrual
    order: the defaults, then ``Scenario.instruments``, then the driver's
    extras."""
    return (default_instruments() + tuple(scn.instruments)
            + tuple(extra_instruments))


def init_aux(scn: Scenario, extra_instruments: tuple = ()) -> tuple:
    """Initial ``[B, ...]`` aux states of ``instruments_for``."""
    return tuple(ins.init(scn)
                 for ins in instruments_for(scn, extra_instruments))


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


def make_context(scn: Scenario, extra_instruments: tuple = ()
                 ) -> tuple[StepContext, tuple]:
    """Step context + initial instrument aux states for a batch driver.
    Outputs are keyed by instrument name, so two instruments of one name
    raise ``ValueError``."""
    instruments = instruments_for(scn, extra_instruments)
    names = [ins.name for ins in instruments]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(
            f"duplicate instrument name(s) {sorted(dupes)}: outputs are keyed "
            "by name — give each instance a distinct `name` class attr")
    device = scn.hosts.cores.device
    ctx = StepContext(
        instruments=instruments,
        cand_kinds=_cand_kinds(scn, instruments, device),
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
    """Outage edges (before anything may observe or use a dead host),
    settling of arrived or cancelled transfers (topology only: their link
    slots free up before this event's migrations and stage-ins), instrument
    ``pre`` hooks, release of drained VMs."""
    st = provision.apply_outages(scn, st)
    st = provision.settle_transfers(scn, st)
    aux = list(aux)
    for i, ins in enumerate(instruments):
        st, aux[i] = ins.pre(scn, st, aux[i])
    st = provision.release_done_vms(scn, st)
    return st, tuple(aux)


def _cand_kinds(scn: Scenario, instruments: tuple, device) -> Tensor:
    """Event kinds aligned with ``_phase_bound``'s candidate times (built
    once per driver: a host-to-device copy waits for the stream)."""
    kinds = [K_READY, K_READY, K_VM_REQUEST, K_MIGRATION, K_SERVING]
    if scn.topology is not None:
        kinds.append(K_STAGE)
    if scn.outages is not None:
        kinds += [K_FAILURE, K_REPAIR]
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
    # evicted rows' request_t is in the past: they retry at every event (and
    # wake on K_REPAIR / completions), so they contribute no bound
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
    if scn.topology is not None:
        # a bound network stage-in submitted in the future wakes the loop
        # at its submit time, so the transfer phase can open it
        staging = (
            cls.exists & (cls.input_dc >= 0) & (st.cl_vm >= 0)
            & (st.cl_xfer_dst < 0) & (st.cl_ready_t >= INF / 2)
            & (cls.submit_t > t)
        )
        cand_t.append(min_where(cls.submit_t, staging))
    if scn.outages is not None:
        ex = scn.hosts.exists
        cand_t.append(torch.where(
            ex, scn.outages.next_fail_after(st.t), INF).flatten(1).amin(-1))
        cand_t.append(torch.where(
            ex, scn.outages.next_repair_after(st.t), INF).flatten(1).amin(-1))
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
    if scn.outages is not None:
        # downtime integral: a VM is down while evicted and not yet usable
        vm_down = st.vm_evicted & ~(st.vm_placed
                                    & (st.vm_avail_t <= ev.t0[:, None]))
        st = st.replace(
            vm_downtime=st.vm_downtime + torch.where(vm_down, dt[:, None], 0.0))
    aux = list(aux)
    for i, ins in enumerate(ctx.instruments):
        st, aux[i] = ins.post(scn, st, ev, aux[i])
    return (st, tuple(aux)), ev


def _freeze(live: Tensor, new, old):
    """Per-leaf row select: live rows take the stepped value, the others
    stay bitwise at their old one (a leaf the step left alone is kept as
    it is)."""
    if new is old:
        return new
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
    if scn_b.topology is not None:
        st3 = _transfer(scn_b, st3, live)
    if ctx.serving:
        st3 = kvserve.serving_phase(scn_b, st3)

    rate, vm_mips, active, bound_dt, cand_ts = _phase_bound(
        scn_b, st3, aux1, instruments)

    # the advance sweep on the whole [B, C] block
    dt, new_rem = ctx.advance(st3.rem_mi, rate, active, bound_dt)

    (st4, aux2), ev = _phase_commit(
        scn_b, st3, aux1, ctx, rate, vm_mips, active, cand_ts, dt, new_rem)
    return _freeze(live, (st4, aux2), (st_b, aux_b)), ev, live


def _transfer(scn: Scenario, st: SimState, live: Tensor) -> SimState:
    """The transfer phase, applied to the live rows that need it.

    The reference's batch step runs ``transfer_phase`` on every row once
    any live row needs it.  For a row that needs nothing that is not an
    identity: it refreshes a stale ``link_share``, after which a later
    migration on that link is re-timed (or not) differently, in the last
    bit, from the row's solo run.  Gated per row, each row of a campaign
    stays bitwise its solo run, which is the reference's solo semantics.
    """
    need = provision.transfer_needed(scn, st) & live
    if not host_any(need):
        return st
    return _freeze(need, provision.transfer_phase(scn, st), st)


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

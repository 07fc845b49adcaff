"""Two-level space/time-shared scheduling (paper §3.2, Figure 4), batch-major.

The port of ``repro.core.policies``: given the entity set, produce the MIPS
rate of every VM (host level) and every cloudlet (VM level).  Both policy
variants are computed and selected per row with ``where``, so one campaign
mixes all four Figure-4 combinations.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core import segments
from repro_torch.core.entities import INF, TIME_SHARED, Scenario, SimState
from repro_torch.core.segments import take


def cloudlet_ready(scn: Scenario, state: SimState) -> Tensor:
    """[B, C] dispatched and staged in."""
    return (state.t[:, None] >= state.cl_ready_t) & scn.cloudlets.exists


def cloudlet_finished(state: SimState) -> Tensor:
    return state.finish_t < INF / 2


def vm_done(scn: Scenario, state: SimState) -> Tensor:
    """[B, V] VM has work assigned and all of it finished (and no service
    row waits for dispatch); pool VMs are done only once released."""
    cls = scn.cloudlets
    V = scn.vms.n_vms
    assigned = state.cl_vm >= 0
    cl_fin = cloudlet_finished(state) | ~cls.exists
    seg = torch.where(cls.exists & assigned, state.cl_vm, V)
    all_fin = segments.segment_all(cl_fin, seg, V)
    has_work = segments.segment_sum(
        (cls.exists & assigned).float(), seg, V) > 0
    pending = (cls.exists & ~assigned).any(-1, keepdim=True)
    done = has_work & all_fin & ~pending
    return torch.where(scn.vms.pool, state.vm_released, done)


def sla_violation_mask(scn: Scenario, state: SimState) -> Tensor:
    """[B, C] existing row with a real deadline that finished past it (or
    never finished)."""
    cls = scn.cloudlets
    return cls.exists & (cls.deadline < INF / 2) & (state.finish_t > cls.deadline)


def vm_outstanding_mi(scn: Scenario, state: SimState) -> Tensor:
    """[B, V] assigned-but-unfinished remaining MI per VM."""
    V = scn.vms.n_vms
    seg = torch.where(scn.cloudlets.exists & (state.cl_vm >= 0), state.cl_vm, V)
    return segments.segment_sum(
        torch.where(cloudlet_finished(state), 0.0, state.rem_mi), seg, V)


def vm_demand_mips(scn: Scenario, state: SimState) -> Tensor:
    """[B, V] MIPS demanded now by ready, unfinished cloudlets."""
    cls, vms = scn.cloudlets, scn.vms
    V = vms.n_vms
    want = cls.exists & cloudlet_ready(scn, state) & ~cloudlet_finished(state)
    seg = torch.where(want & (state.cl_vm >= 0), state.cl_vm, V)
    cores = segments.segment_sum(
        torch.where(want, cls.cores.float(), 0.0), seg, V)
    return cores * vms.mips


def host_level_mips(scn: Scenario, state: SimState) -> Tensor:
    """[B, V] f32 total MIPS each VM is granted by its host right now."""
    hosts, vms = scn.hosts, scn.vms
    B, D, H = hosts.cores.shape
    n_seg = D * H

    done = vm_done(scn, state)
    occupying = state.vm_placed & ~done & vms.exists
    usable = occupying & (state.t[:, None] >= state.vm_avail_t)

    seg = torch.where(occupying, state.vm_dc * H + state.vm_host, n_seg)
    # unplaced rows gather some host's values; every use below masks them
    at = state.vm_dc.clamp(0, D - 1) * H + state.vm_host.clamp(0, H - 1)
    host_cores_v = take(hosts.cores.reshape(B, n_seg), at).float()
    host_mips_v = take(hosts.mips.reshape(B, n_seg), at)
    vm_cores_f = vms.cores.float()

    # --- space-shared (Fig 4a): FCFS exclusive core grants ---
    demand_cores = torch.where(occupying, vm_cores_f, 0.0)
    prefix = segments.segment_prefix_sum(demand_cores, seg, n_seg)
    fits = prefix + vm_cores_f <= host_cores_v + 1e-6
    percore = torch.minimum(vms.mips, host_mips_v)
    space = torch.where(usable & fits, vm_cores_f * percore, 0.0)

    # --- time-shared (Fig 4c): proportional share of host capacity ---
    demand_mips = torch.where(occupying, vm_cores_f * vms.mips, 0.0)
    total = segments.segment_sum(demand_mips, seg, n_seg)
    cap = (hosts.cores.float() * hosts.mips).reshape(B, n_seg)
    seg_safe = seg.clamp(0, n_seg - 1)
    total_v = take(total, seg_safe)
    scale = torch.where(
        total_v > 0,
        (take(cap, seg_safe) / total_v.clamp_min(1e-9)).clamp_max(1.0), 0.0)
    time = torch.where(usable, vm_cores_f * vms.mips * scale, 0.0)

    return torch.where(scn.policy.host_policy[:, None] == TIME_SHARED, time, space)


def cloudlet_rates(scn: Scenario, state: SimState) -> tuple[Tensor, Tensor]:
    """([B, C] per-core progress MIPS per cloudlet, [B, V] granted VM MIPS)."""
    cls, vms = scn.cloudlets, scn.vms
    V = vms.n_vms

    vm_mips = host_level_mips(scn, state)
    vmi = state.cl_vm.clamp(0, V - 1)

    ready = cloudlet_ready(scn, state)
    fin = cloudlet_finished(state)
    occ = ready & ~fin & cls.exists
    # serving rows follow the continuous-batch model below, not Figure 4
    is_serving = cls.prompt_tokens > 0.0
    occ_leg = occ & ~is_serving
    seg = torch.where(occ_leg, vmi, V)
    cl_cores_f = cls.cores.float()
    vm_cores_f = vms.cores.float().clamp_min(1.0)

    percore_capacity = vm_mips / vm_cores_f

    # --- space-shared inside the VM (Fig 4a/b upper): FCFS core occupancy ---
    demand = torch.where(occ_leg, cl_cores_f, 0.0)
    prefix = segments.segment_prefix_sum(demand, seg, V)
    fits = prefix + cl_cores_f <= take(vms.cores, vmi).float() + 1e-6
    space = torch.where(occ_leg & fits, take(percore_capacity, vmi), 0.0)

    # --- time-shared inside the VM (Fig 4b/d): equal per-core share ---
    total_demand = segments.segment_sum(demand, seg, V)
    denom = torch.maximum(total_demand, vms.cores.float())
    share = vm_mips / denom.clamp_min(1e-9)
    time = torch.where(occ_leg, take(share, vmi), 0.0)

    rate = torch.where(scn.policy.vm_policy[:, None] == TIME_SHARED, time, space)

    # --- continuous-batching decode (DESIGN.md §14) ---
    occ_srv = occ & is_serving & state.cl_admitted
    seg_srv = torch.where(occ_srv, vmi, V)
    batch = segments.segment_sum(occ_srv.float(), seg_srv, V)
    slow = 1.0 + scn.policy.batch_degradation[:, None] * (batch - 1.0).clamp_min(0.0)
    srv_rate = take(percore_capacity, vmi) / take(slow, vmi).clamp_min(1e-9)
    rate = torch.where(is_serving, torch.where(occ_srv, srv_rate, 0.0), rate)

    # a cloudlet only runs while its VM is granted capacity
    rate = torch.where(take(vm_mips, vmi) > 0, rate, 0.0)
    return rate, vm_mips

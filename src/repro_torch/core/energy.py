"""Energy accounting, batch-major (the port of ``repro.core.energy``).

Linear-in-utilization host power, integrated over the engine's
piecewise-constant event intervals by the default ``EnergyInstrument``:

    P(host) = P_idle + (P_peak - P_idle) * utilization

``Topology`` and ``migration_delay_matrix`` belong to the network slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from repro_torch.core import policies, segments
from repro_torch.core.entities import (
    Scenario, SimState, TensorTree, resolve_device)
from repro_torch.core.segments import row_sum


@dataclass(frozen=True)
class PowerModel(TensorTree):
    """Per-DC host power parameters, ``[D]`` each.  ``gate_idle``: a host
    with no VM holding resources on it draws zero (None: always on)."""

    watts_idle: Tensor
    watts_peak: Tensor
    gate_idle: Tensor | None = None

    @staticmethod
    def uniform(n_dc: int, idle: float = 93.0, peak: float = 135.0,
                gate_idle: bool = False, device=None) -> "PowerModel":
        dev = resolve_device(device)
        return PowerModel(
            watts_idle=torch.full((n_dc,), idle, dtype=torch.float32, device=dev),
            watts_peak=torch.full((n_dc,), peak, dtype=torch.float32, device=dev),
            gate_idle=torch.full((n_dc,), gate_idle, dtype=torch.bool, device=dev),
        )


def host_granted_mips(scn: Scenario, state: SimState,
                      vm_mips: Tensor | None = None) -> Tensor:
    """[B, D, H] MIPS currently granted to VMs on each host."""
    if vm_mips is None:
        vm_mips = policies.host_level_mips(scn, state)
    B, D, H = scn.hosts.cores.shape
    seg = torch.where(state.vm_placed & scn.vms.exists,
                      state.vm_dc * H + state.vm_host, D * H)
    return segments.segment_sum(vm_mips, seg, D * H).reshape(B, D, H)


def host_utilization(scn: Scenario, state: SimState,
                     vm_mips: Tensor | None = None) -> Tensor:
    """[B, D, H] granted / capacity in [0, 1]; 0 for capacity-less hosts."""
    granted = host_granted_mips(scn, state, vm_mips)
    cap = scn.hosts.cores.float() * scn.hosts.mips
    return torch.where(
        cap > 0, (granted / cap.clamp_min(1e-9)).clamp(0, 1), 0.0)


def dc_utilization(scn: Scenario, state: SimState,
                   vm_mips: Tensor | None = None) -> Tensor:
    """[B, D] capacity-weighted datacenter utilization."""
    exists = scn.hosts.exists
    granted = torch.where(exists, host_granted_mips(scn, state, vm_mips), 0.0)
    cap = torch.where(exists, scn.hosts.cores.float() * scn.hosts.mips, 0.0)
    total_cap = row_sum(cap)
    return torch.where(
        total_cap > 0,
        (row_sum(granted) / total_cap.clamp_min(1e-9)).clamp(0, 1), 0.0)


def host_occupied(scn: Scenario, state: SimState) -> Tensor:
    """[B, D, H] bool: at least one VM holds resources on the host."""
    B, D, H = scn.hosts.cores.shape
    occ = state.vm_placed & ~state.vm_released & scn.vms.exists
    seg = torch.where(occ, state.vm_dc * H + state.vm_host, D * H)
    counts = segments.segment_sum(occ.to(torch.int32), seg, D * H)
    return counts.reshape(B, D, H) > 0


def power_draw(scn: Scenario, state: SimState,
               vm_mips: Tensor | None = None) -> Tensor:
    """[B, D] instantaneous watts given the current allocation; failed
    hosts draw nothing, unoccupied hosts under ``gate_idle`` draw zero."""
    util = host_utilization(scn, state, vm_mips)
    pm: PowerModel = scn.power
    idle = pm.watts_idle[:, :, None].expand(util.shape)
    if pm.gate_idle is not None:
        idle = torch.where(
            pm.gate_idle[:, :, None] & ~host_occupied(scn, state), 0.0, idle)
    watts = torch.where(
        scn.hosts.exists & state.host_up,
        idle + (pm.watts_peak - pm.watts_idle)[:, :, None] * util,
        0.0,
    )
    return row_sum(watts)

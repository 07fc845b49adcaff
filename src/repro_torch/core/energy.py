"""Energy accounting, batch-major (the port of ``repro.core.energy``).

Linear-in-utilization host power, integrated over the engine's
piecewise-constant event intervals by the default ``EnergyInstrument``:

    P(host) = P_idle + (P_peak - P_idle) * utilization

``Topology`` is the inter-DC link model (DESIGN.md §13): a latency and
bandwidth matrix per scenario, whose bandwidth every inter-DC byte draws
from through the ``SimState.link_busy`` / ``link_share`` ledger;
``migration_delay_matrix`` prices an uncontended move on it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


@dataclass(frozen=True)
class Topology(TensorTree):
    """Inter-DC link parameters, ``[D, D]`` each (``[B, D, D]`` in the
    engine; the diagonal is intra-DC)."""

    latency_s: Tensor
    bw_mbps: Tensor

    def fair_share(self, busy: Tensor) -> Tensor:
        """Mbps each active transfer of a link receives: ``bw / max(busy,
        1)``, a true division, so a lone transfer gets exactly the link's
        bandwidth and the ledger's change test (``!=``) rounds alike on
        every device."""
        return self.bw_mbps / busy.clamp_min(1).float()

    @staticmethod
    def uniform(n_dc: int, latency_s: float = 0.05, bw_mbps: float = 100.0,
                device=None) -> "Topology":
        dev = resolve_device(device)
        lat = torch.full((n_dc, n_dc), latency_s, dtype=torch.float32,
                         device=dev)
        lat = lat * (1 - torch.eye(n_dc, device=dev))
        bw = torch.full((n_dc, n_dc), bw_mbps, dtype=torch.float32, device=dev)
        return Topology(latency_s=lat, bw_mbps=bw)

    @staticmethod
    def from_coordinates(coords_km: np.ndarray, bw_mbps: float = 100.0,
                         device=None) -> "Topology":
        """BRITE-flavoured: latency ~ distance / 0.6c, computed on the host
        in numpy, then moved to ``device``."""
        coords_km = np.asarray(coords_km)
        d = np.linalg.norm(coords_km[:, None, :] - coords_km[None, :, :],
                           axis=-1)
        lat = (d * 1e3 / (0.6 * 3e8)).astype(np.float32)
        n = coords_km.shape[0]
        dev = resolve_device(device)
        return Topology(
            latency_s=torch.from_numpy(lat).to(dev),
            bw_mbps=torch.full((n, n), bw_mbps, dtype=torch.float32,
                               device=dev))


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


def migration_delay_matrix(scn: Scenario, image_mb, policy=None) -> Tensor:
    """``[D, D]`` (``[B, D, D]`` for a campaign) seconds to move a VM image
    between DC pairs: ``migration_fixed_s + latency + image / bw``, the
    uncontended delay the engine charges when a migration commits.
    ``policy`` defaults to ``scn.policy``; ``image_mb`` is a scalar or one
    value per campaign row."""
    topo: Topology = scn.topology
    pol = scn.policy if policy is None else policy
    lat = topo.latency_s

    def per_row(x) -> Tensor:
        """A scalar or a ``[B]`` value, shaped to broadcast over ``lat``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=lat.device)
        return x.reshape(x.shape + (1,) * (lat.dim() - x.dim()))

    return (per_row(pol.migration_fixed_s) + lat
            + per_row(image_mb) / topo.bw_mbps.clamp_min(1e-6))

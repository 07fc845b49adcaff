"""Scenario builders: the paper's own experiments (§5), on a device.

The port of the paper constructors of ``repro.core.scenarios``, built from
numpy exactly as the reference builds them, then placed on ``device``
(``None``: the GPU; the CPU only when asked for).  Each returns one
unbatched ``Scenario``; ``campaign.stack_scenarios`` makes a campaign.

* ``fig4_scenario``: the 2-core host / 2 VMs / 8 task units illustration.
* ``fig7_8_scenario``: instantiation scaling, 100 -> 100 000 hosts.
* ``fig9_10_scenario``: 10 000 hosts, 50 VMs, 500 cloudlets in groups of 50
  every 10 simulated minutes; space- vs time-shared cloudlet scheduling.
* ``table1_scenario``: 3 federated datacenters, migration on saturation.
* ``generated_scenario``: a seeded Poisson / diurnal / bursty workload over a
  fixed fleet (``workload.generate_cloudlets``).
* ``autoscale_scenario``: bursty service-routed work and a spare-VM pool under
  the threshold autoscaler (DESIGN.md §7).
* ``consolidation_scenario`` / ``balance_scenario``: runtime (live) VM
  migration: energy consolidation under an idle-gated power model, and load
  balancing with progress kept (DESIGN.md §8).
* ``reliability_scenario`` / ``evacuation_scenario``: host failures under a
  seeded or fixed outage schedule, checkpoint rollback, SLA deadlines and
  proactive evacuation (DESIGN.md §9).
* ``staging_scenario``: waves of service-routed cloudlets staging their
  input over shared inter-DC links under a ``Topology`` (DESIGN.md §13).
* ``serving_scenario``: an LLM-inference fleet under KV-bound continuous
  batching (DESIGN.md §14), optionally autoscaled.

The generator-backed builders take a CPU ``torch.Generator`` where the
reference takes a ``jax.random`` key: the same seed gives the same scenario
on every device, but not the reference's draws (a test carries a JAX-drawn
workload across with ``convert.scenario_from_arrays``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import workload
from repro_torch.core.energy import PowerModel, Topology
from repro_torch.core.entities import (
    SPACE_SHARED, TIME_SHARED, Cloudlets, Hosts, Market, Policy, Scenario,
    VMRequests, resolve_device)
from repro_torch.core.step import (
    AutoscaleInstrument, MigrationInstrument, ReliabilityInstrument)

_F = np.float32
_I = np.int32


def _on(dev, x, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype), device=dev)


def make_policy(
    host_policy: int = SPACE_SHARED,
    vm_policy: int = SPACE_SHARED,
    federation: bool = False,
    core_reserving: bool = False,
    best_fit: bool = False,
    sensor_interval: float = 100.0,
    migration_fixed_s: float = 30.0,
    interdc_bw_mbps: float = 100.0,
    horizon: float = 1e7,
    autoscale: bool = False,
    scale_up_thresh: float = 0.75,
    scale_down_thresh: float = 0.0,
    live_migration: bool = False,
    migrate_balance_thresh: float = 1e9,
    migrate_consolidate_thresh: float = 0.0,
    ckpt_interval: float = 3.0e38,
    evacuation: bool = False,
    evac_lead_s: float = 60.0,
    locality_dispatch: bool = False,
    block_tokens: float = 16.0,
    batch_degradation: float = 0.0,
    device=None,
) -> Policy:
    """A ``Policy`` of scalar tensors; defaults reproduce the paper's
    baseline (space-shared at both levels, no federation)."""
    dev = resolve_device(device)
    b, i, f = bool, _I, _F
    return Policy(
        host_policy=_on(dev, host_policy, i),
        vm_policy=_on(dev, vm_policy, i),
        federation=_on(dev, federation, b),
        core_reserving=_on(dev, core_reserving, b),
        best_fit=_on(dev, best_fit, b),
        sensor_interval=_on(dev, sensor_interval, f),
        migration_fixed_s=_on(dev, migration_fixed_s, f),
        interdc_bw_mbps=_on(dev, interdc_bw_mbps, f),
        horizon=_on(dev, horizon, f),
        autoscale=_on(dev, autoscale, b),
        scale_up_thresh=_on(dev, scale_up_thresh, f),
        scale_down_thresh=_on(dev, scale_down_thresh, f),
        live_migration=_on(dev, live_migration, b),
        migrate_balance_thresh=_on(dev, migrate_balance_thresh, f),
        migrate_consolidate_thresh=_on(dev, migrate_consolidate_thresh, f),
        ckpt_interval=_on(dev, ckpt_interval, f),
        evacuation=_on(dev, evacuation, b),
        evac_lead_s=_on(dev, evac_lead_s, f),
        locality_dispatch=_on(dev, locality_dispatch, b),
        block_tokens=_on(dev, block_tokens, f),
        batch_degradation=_on(dev, batch_degradation, f),
    )


def uniform_hosts(n_dc: int, hosts_per_dc: int, cores: int = 1,
                  mips: float = 1000.0, ram_mb: float = 1024.0,
                  storage_mb: float = 2_000_000.0, bw_mbps: float = 1000.0,
                  kv_blocks: float = 0.0, exists: np.ndarray | None = None,
                  device=None) -> Hosts:
    """Homogeneous ``[n_dc, hosts_per_dc]`` host grid; ``exists`` masks
    rows out of the rectangle (ragged federations)."""
    dev = resolve_device(device)
    shape = (n_dc, hosts_per_dc)
    ex = np.ones(shape, bool) if exists is None else exists
    return Hosts(
        cores=_on(dev, np.full(shape, cores), _I),
        mips=_on(dev, np.full(shape, mips), _F),
        ram_mb=_on(dev, np.full(shape, ram_mb), _F),
        storage_mb=_on(dev, np.full(shape, storage_mb), _F),
        bw_mbps=_on(dev, np.full(shape, bw_mbps), _F),
        kv_blocks=_on(dev, np.full(shape, kv_blocks), _F),
        exists=_on(dev, ex, bool),
    )


def uniform_vms(n: int, dc=0, cores: int = 1, mips: float = 1000.0,
                ram_mb: float = 512.0, storage_mb: float = 1024.0,
                bw_mbps: float = 100.0, kv_blocks: float = 0.0,
                request_t=0.0, image_mb: float = 1024.0, pool=False,
                device=None) -> VMRequests:
    """``n`` identical VM requests; scalar args broadcast, arrays vary."""
    dev = resolve_device(device)

    def vec(x, dtype):
        return _on(dev, np.broadcast_to(np.asarray(x, dtype), (n,)), dtype)

    return VMRequests(
        dc=vec(dc, _I),
        cores=vec(cores, _I),
        mips=vec(mips, _F),
        ram_mb=vec(ram_mb, _F),
        storage_mb=vec(storage_mb, _F),
        bw_mbps=vec(bw_mbps, _F),
        kv_blocks=vec(kv_blocks, _F),
        request_t=vec(request_t, _F),
        image_mb=vec(image_mb, _F),
        exists=vec(True, bool),
        pool=vec(pool, bool),
    )


def uniform_market(n_dc: int, cpu=3.0, ram=0.05, storage=0.001, bw=0.1,
                   device=None) -> Market:
    """Per-DC prices, identical across the federation."""
    dev = resolve_device(device)

    def vec(x):
        return _on(dev, np.full((n_dc,), x), _F)

    return Market(cost_per_cpu_sec=vec(cpu), cost_per_ram_mb=vec(ram),
                  cost_per_storage_mb=vec(storage), cost_per_bw_mb=vec(bw))


def make_cloudlets(vm, length_mi, submit_t, cores=1, input_mb=0.3,
                   output_mb: float = 0.3, deadline=3.0e38, input_dc=-1,
                   prompt_tokens=0.0, max_new_tokens=0.0,
                   device=None) -> Cloudlets:
    """Rows are re-sorted by (submit_t, row): FCFS is row order downstream."""
    dev = resolve_device(device)
    vm = np.asarray(vm, _I)
    n = vm.shape[0]

    def vec(x, dtype):
        return np.broadcast_to(np.asarray(x, dtype), (n,))

    submit = vec(submit_t, _F)
    order = np.argsort(submit, kind="stable")

    def col(x, dtype):
        return _on(dev, vec(x, dtype)[order], dtype)

    return Cloudlets(
        vm=col(vm, _I),
        length_mi=col(length_mi, _F),
        cores=col(cores, _I),
        submit_t=col(submit, _F),
        input_mb=col(input_mb, _F),
        input_dc=col(input_dc, _I),
        output_mb=_on(dev, np.full((n,), output_mb), _F),
        deadline=col(deadline, _F),
        prompt_tokens=col(prompt_tokens, _F),
        max_new_tokens=col(max_new_tokens, _F),
        exists=_on(dev, np.ones((n,)), bool),
    )


# ---------------------------------------------------------------------------
# Paper experiments
# ---------------------------------------------------------------------------

def fig4_scenario(host_policy: int, vm_policy: int, length_mi: float = 4000.0,
                  mips: float = 10.0, device=None) -> Scenario:
    """One 2-core host; VM1, VM2 each want 2 cores; 4 unit tasks per VM.

    Completion times with L = length/mips: (a) space/space L, 2L, 3L, 4L;
    (b) space/time VM1 all at 2L, VM2 all at 4L; (c) time/space two tasks
    per VM at 2L and two at 4L; (d) time/time all eight at 4L.
    """
    dev = resolve_device(device)
    hosts = uniform_hosts(1, 1, cores=2, mips=mips, ram_mb=4096.0, device=dev)
    vms = uniform_vms(2, cores=2, mips=mips, ram_mb=1024.0, device=dev)
    cl_vm = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    cls = make_cloudlets(cl_vm, np.full(8, length_mi), np.zeros(8),
                         input_mb=0.0, output_mb=0.0, device=dev)
    pol = make_policy(host_policy=host_policy, vm_policy=vm_policy, device=dev)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(1, device=dev), policy=pol)


def fig7_8_scenario(n_hosts: int, device=None) -> Scenario:
    """Instantiation-scaling environment: one DC, a broker, no workload."""
    dev = resolve_device(device)
    hosts = uniform_hosts(1, n_hosts, cores=1, mips=1000.0, ram_mb=1024.0,
                          storage_mb=2_000_000.0, device=dev)
    cls = make_cloudlets(np.array([0]), np.array([1.0]), np.array([0.0]),
                         input_mb=0.0, output_mb=0.0, device=dev)
    return Scenario(hosts=hosts, vms=uniform_vms(1, device=dev), cloudlets=cls,
                    market=uniform_market(1, device=dev),
                    policy=make_policy(device=dev))


def fig9_10_scenario(vm_policy: int, n_hosts: int = 10_000, n_vms: int = 50,
                     n_groups: int = 10, group_interval_s: float = 600.0,
                     task_mi: float = 1_200_000.0, device=None) -> Scenario:
    """Paper §5 scheduling test: 10k hosts (1 core @1000 MIPS, 1 GB RAM,
    2 TB), 50 VMs (512 MB), 500 x 20-minute task units submitted 50 at a
    time every 10 minutes; space-shared hosts with core reservation, so each
    VM owns a host."""
    dev = resolve_device(device)
    hosts = uniform_hosts(1, n_hosts, cores=1, mips=1000.0, ram_mb=1024.0,
                          storage_mb=2_000_000.0, device=dev)
    vms = uniform_vms(n_vms, ram_mb=512.0, storage_mb=1024.0, device=dev)
    n_cl = n_groups * n_vms
    cl_vm = np.tile(np.arange(n_vms), n_groups)
    submit = np.repeat(np.arange(n_groups) * group_interval_s, n_vms)
    cls = make_cloudlets(cl_vm, np.full(n_cl, task_mi), submit,
                         input_mb=0.3, output_mb=0.3, device=dev)
    pol = make_policy(host_policy=SPACE_SHARED, vm_policy=vm_policy,
                      core_reserving=True, device=dev)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(1, device=dev), policy=pol)


def table1_scenario(federation: bool, n_dc: int = 3, hosts_per_dc: int = 10,
                    dc0_hosts: int = 7, n_vms: int = 25,
                    cloudlet_mi: float = 1_800_000.0,
                    peer_background: int = 5,
                    live_migration: bool = False,
                    migrate_balance_thresh: float = 1e9,
                    migrate_consolidate_thresh: float = 0.0,
                    device=None) -> Scenario:
    """Federated 3-DC experiment (paper §5, Table 1), calibrated as in the
    reference: DC0 has ``dc0_hosts`` single-core hosts, peers hold
    ``peer_background`` idle VMs each, and all 25 user VMs land at DC0; with
    federation the overflow spreads over peer slots.

    ``live_migration=True`` also attaches the runtime
    ``MigrationInstrument`` with the given thresholds (DESIGN.md §8).
    """
    dev = resolve_device(device)
    exists = np.ones((n_dc, hosts_per_dc), bool)
    exists[0, dc0_hosts:] = False
    hosts = uniform_hosts(n_dc, hosts_per_dc, cores=1, mips=1000.0,
                          ram_mb=1024.0, storage_mb=2_000_000.0,
                          exists=exists, device=dev)
    n_bg = peer_background * (n_dc - 1)
    bg_dc = np.repeat(np.arange(1, n_dc), peer_background)
    total_vms = n_vms + n_bg
    vms = uniform_vms(
        total_vms,
        dc=np.concatenate([bg_dc, np.zeros(n_vms, int)]),
        ram_mb=256.0,
        storage_mb=1024.0,
        request_t=np.concatenate([np.full(n_bg, 0.0), np.full(n_vms, 1.0)]),
        image_mb=1024.0,
        device=dev,
    )
    cl_vm = np.arange(n_bg, total_vms)
    cls = make_cloudlets(cl_vm, np.full(n_vms, cloudlet_mi),
                         np.full(n_vms, 1.0), input_mb=0.3, output_mb=0.3,
                         device=dev)
    pol = make_policy(
        host_policy=TIME_SHARED,
        vm_policy=TIME_SHARED,
        federation=federation,
        core_reserving=False,
        sensor_interval=50.0,
        migration_fixed_s=30.0,
        interdc_bw_mbps=100.0,
        horizon=50_000.0,
        live_migration=live_migration,
        migrate_balance_thresh=migrate_balance_thresh,
        migrate_consolidate_thresh=migrate_consolidate_thresh,
        device=dev,
    )
    instruments = ()
    max_steps = 4 * (total_vms + n_vms) + 1200
    if live_migration:
        instruments = (MigrationInstrument(),)
        max_steps += 400   # migration arrivals on top of the tick budget
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(n_dc, device=dev), policy=pol,
                    instruments=instruments, max_steps=max_steps)


# ---------------------------------------------------------------------------
# Generator-backed scenarios (dynamic workloads and autoscaling, DESIGN.md §7)
# ---------------------------------------------------------------------------

def generated_scenario(gen: torch.Generator, kind: str = "poisson",
                       n_cloudlets: int = 64, n_vms: int = 8,
                       n_hosts: int = 8, rate: float = 0.1,
                       median_mi: float = 30_000.0, mips: float = 1000.0,
                       vm_policy: int = SPACE_SHARED, device=None,
                       **gen_kw) -> Scenario:
    """A seeded dynamic workload over a fixed fleet, routed round-robin:
    the paper's "varying load" without elasticity."""
    dev = resolve_device(device)
    hosts = uniform_hosts(1, n_hosts, cores=1, mips=mips, ram_mb=1024.0,
                          storage_mb=2_000_000.0, device=dev)
    vms = uniform_vms(n_vms, mips=mips, ram_mb=512.0, storage_mb=1024.0,
                      device=dev)
    cls = workload.generate_cloudlets(
        gen, n_cloudlets, kind=kind, rate=rate, median_mi=median_mi,
        n_vms=n_vms, device=dev, **gen_kw)
    pol = make_policy(host_policy=SPACE_SHARED, vm_policy=vm_policy,
                      core_reserving=True, device=dev)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(1, device=dev), policy=pol,
                    max_steps=4 * (n_cloudlets + n_vms) + 400)


def autoscale_scenario(gen: torch.Generator, *, n_base: int = 4,
                       n_pool: int = 4, n_cloudlets: int = 48,
                       n_bursts: int = 3, burst_rate: float = 0.1,
                       off_gap_mean: float = 800.0,
                       median_mi: float = 60_000.0, sigma_mi: float = 0.3,
                       mips: float = 1000.0, autoscale: bool = True,
                       scale_up_thresh: float = 0.6,
                       scale_down_thresh: float = 0.0,
                       sensor_interval: float = 20.0, boot_s: float = 30.0,
                       max_steps: int | None = None,
                       device=None) -> Scenario:
    """Bursty broker-dispatched work and a spare-VM pool under the threshold
    autoscaler (DESIGN.md §7): one DC of ``n_base + n_pool`` single-core
    hosts, one VM a host; ``autoscale=False`` is the static-fleet control
    with the same structure."""
    dev = resolve_device(device)
    n_vms = n_base + n_pool
    hosts = uniform_hosts(1, n_vms, cores=1, mips=mips, ram_mb=1024.0,
                          storage_mb=2_000_000.0, device=dev)
    vms = uniform_vms(n_vms, mips=mips, ram_mb=512.0, storage_mb=1024.0,
                      pool=np.arange(n_vms) >= n_base, device=dev)
    cls = workload.generate_cloudlets(
        gen, n_cloudlets, kind="bursty", n_bursts=n_bursts, rate=burst_rate,
        off_gap_mean=off_gap_mean, median_mi=median_mi, sigma_mi=sigma_mi,
        n_vms=None, device=dev)
    pol = make_policy(
        host_policy=SPACE_SHARED, vm_policy=SPACE_SHARED,
        core_reserving=True, sensor_interval=sensor_interval,
        migration_fixed_s=boot_s, autoscale=autoscale,
        scale_up_thresh=scale_up_thresh, scale_down_thresh=scale_down_thresh,
        device=dev)
    if max_steps is None:
        # arrivals + completions + lifecycle, plus one K_SCALE tick per
        # sensor interval over a generous estimate of the active span
        span = 2.0 * n_bursts * (
            off_gap_mean + n_cloudlets / n_bursts / burst_rate
        ) + 4.0 * median_mi / mips
        max_steps = 4 * (n_cloudlets + n_vms) + int(span / sensor_interval) + 200
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(1, device=dev), policy=pol,
                    instruments=(AutoscaleInstrument(),),
                    max_steps=max_steps)


# ---------------------------------------------------------------------------
# Runtime (live) migration scenarios (DESIGN.md §8)
# ---------------------------------------------------------------------------

def consolidation_scenario(*, n_spare: int = 4, n_tasks: int = 4,
                           task_mi: float = 500_000.0,
                           live_migration: bool = True,
                           consolidate_thresh: float = 0.5,
                           sensor_interval: float = 30.0,
                           migration_fixed_s: float = 30.0,
                           interdc_bw_mbps: float = 100.0,
                           horizon: float = 4000.0, idle_w: float = 93.0,
                           peak_w: float = 135.0, device=None) -> Scenario:
    """Energy consolidation: DC0 holds one big host (``1 + n_spare`` cores)
    running one worker VM with ``n_tasks`` serial cloudlets; DC1 holds
    ``n_spare`` idle VMs, one per single-core host.  With live migration on,
    the coordinator drains DC1's idle images into DC0's spare slots one a
    tick, the emptied hosts power-gate, and energy drops against the
    no-migration control."""
    dev = resolve_device(device)
    D, H = 2, max(1, n_spare)
    exists = np.zeros((D, H), bool)
    exists[0, 0] = True
    exists[1, :n_spare] = True
    cores = np.ones((D, H), _I)
    cores[0, 0] = 1 + n_spare
    hosts = uniform_hosts(D, H, cores=1, mips=1000.0, ram_mb=8192.0,
                          storage_mb=2_000_000.0, exists=exists, device=dev)
    hosts = hosts.replace(cores=_on(dev, cores, _I))
    # row 0: the worker at DC0; rows 1..n_spare: idle images at DC1
    vms = uniform_vms(1 + n_spare, dc=np.array([0] + [1] * n_spare),
                      cores=1, mips=1000.0, ram_mb=256.0, storage_mb=1024.0,
                      image_mb=1024.0, device=dev)
    cls = make_cloudlets(np.zeros(n_tasks, _I), np.full(n_tasks, task_mi),
                         np.zeros(n_tasks), input_mb=0.0, output_mb=0.0,
                         device=dev)
    pol = make_policy(
        host_policy=SPACE_SHARED, vm_policy=SPACE_SHARED,
        federation=True, sensor_interval=sensor_interval,
        migration_fixed_s=migration_fixed_s,
        interdc_bw_mbps=interdc_bw_mbps, horizon=horizon,
        live_migration=live_migration,
        migrate_consolidate_thresh=consolidate_thresh, device=dev)
    max_steps = (4 * (n_tasks + 1 + n_spare)
                 + 2 * int(horizon / sensor_interval) + 100)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(D, device=dev), policy=pol,
                    power=PowerModel.uniform(D, idle=idle_w, peak=peak_w,
                                             gate_idle=True, device=dev),
                    instruments=(MigrationInstrument(),),
                    max_steps=max_steps)


def balance_scenario(*, live_migration: bool = True,
                     balance_thresh: float = 1.5,
                     work_mi: float = 1_000_000.0, bg_mi: float = 50_000.0,
                     sensor_interval: float = 100.0,
                     migration_fixed_s: float = 30.0,
                     interdc_bw_mbps: float = 100.0,
                     horizon: float = 10_000.0, device=None) -> Scenario:
    """Load balancing: two single-host DCs; two worker VMs time-share DC0's
    core while DC1's host is held by a short background VM.  Once that slot
    frees, the coordinator sheds one worker, with its progress, to DC1, and
    the improvement rule then holds the split: no ping-pong."""
    dev = resolve_device(device)
    hosts = uniform_hosts(2, 1, cores=1, mips=1000.0, ram_mb=4096.0,
                          storage_mb=2_000_000.0, device=dev)
    # row 0: background at DC1; rows 1-2: the oversubscribed workers at DC0
    vms = uniform_vms(3, dc=np.array([1, 0, 0]), cores=1, mips=1000.0,
                      ram_mb=256.0, storage_mb=1024.0, image_mb=1024.0,
                      device=dev)
    cls = make_cloudlets(np.array([0, 1, 2]),
                         np.array([bg_mi, work_mi, work_mi]),
                         np.zeros(3), input_mb=0.0, output_mb=0.0,
                         device=dev)
    pol = make_policy(
        host_policy=TIME_SHARED, vm_policy=SPACE_SHARED,
        federation=True, sensor_interval=sensor_interval,
        migration_fixed_s=migration_fixed_s,
        interdc_bw_mbps=interdc_bw_mbps, horizon=horizon,
        live_migration=live_migration,
        migrate_balance_thresh=balance_thresh, device=dev)
    max_steps = 4 * (3 + 3) + 2 * int(horizon / sensor_interval) + 100
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(2, device=dev), policy=pol,
                    instruments=(MigrationInstrument(),),
                    max_steps=max_steps)


# ---------------------------------------------------------------------------
# Reliability scenarios (host failures and SLA, DESIGN.md §9)
# ---------------------------------------------------------------------------

def reliability_scenario(gen: torch.Generator | None = None, *,
                         n_dc: int = 2, hosts_per_dc: int = 3,
                         n_vms: int = 4, cl_per_vm: int = 2,
                         task_mi: float = 100_000.0, mips: float = 1000.0,
                         n_outages: int = 2, mtbf_s: float = 700.0,
                         mttr_s: float = 400.0,
                         ckpt_interval: float = 3.0e38,
                         evacuation: bool = False, evac_lead_s: float = 40.0,
                         deadline_slack: float = 6.0, federation: bool = True,
                         sensor_interval: float = 50.0,
                         migration_fixed_s: float = 30.0,
                         horizon: float = 20_000.0, device=None) -> Scenario:
    """A federated fleet under exponential MTBF/MTTR outages
    (``workload.host_outages``), deadlines at ``deadline_slack`` x the ideal
    runtime, checkpoint rollback and the evacuation coordinator.
    ``gen=None`` (or ``mtbf_s >= INF``) is the never-failing control with
    the same shapes."""
    dev = resolve_device(device)
    hosts = uniform_hosts(n_dc, hosts_per_dc, cores=1, mips=mips,
                          ram_mb=1024.0, storage_mb=2_000_000.0, device=dev)
    vms = uniform_vms(n_vms, dc=0, cores=1, mips=mips, ram_mb=512.0,
                      storage_mb=1024.0, image_mb=1024.0, device=dev)
    n_cl = n_vms * cl_per_vm
    ideal_s = cl_per_vm * task_mi / mips
    cls = make_cloudlets(np.arange(n_cl) % n_vms, np.full(n_cl, task_mi),
                         np.zeros(n_cl), input_mb=0.0, output_mb=0.0,
                         deadline=deadline_slack * ideal_s, device=dev)
    if gen is None:
        outages = workload.no_outages(n_dc, hosts_per_dc, n_outages,
                                      device=dev)
    else:
        outages = workload.host_outages(gen, n_dc, hosts_per_dc, n_outages,
                                        mtbf_s, mttr_s, device=dev)
    pol = make_policy(
        host_policy=SPACE_SHARED, vm_policy=SPACE_SHARED,
        core_reserving=True, federation=federation,
        sensor_interval=sensor_interval,
        migration_fixed_s=migration_fixed_s, horizon=horizon,
        ckpt_interval=ckpt_interval, evacuation=evacuation,
        evac_lead_s=evac_lead_s, device=dev)
    n_out = n_dc * hosts_per_dc * n_outages
    max_steps = (4 * (n_cl + n_vms) + 4 * n_out + 4 * n_vms
                 + 2 * int(horizon / sensor_interval) + 200)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(n_dc, device=dev), policy=pol,
                    outages=outages, instruments=(ReliabilityInstrument(),),
                    max_steps=max_steps)


def evacuation_scenario(*, evacuation: bool = True,
                        ckpt_interval: float = 100_000.0,
                        fail_at: float = 300.0, repair_after: float = 5000.0,
                        n_workers: int = 2, task_mi: float = 600_000.0,
                        mips: float = 1000.0, deadline: float = 800.0,
                        evac_lead_s: float = 50.0,
                        sensor_interval: float = 50.0,
                        migration_fixed_s: float = 30.0,
                        interdc_bw_mbps: float = 100.0,
                        horizon: float = 6000.0, idle_w: float = 93.0,
                        peak_w: float = 135.0, device=None) -> Scenario:
    """DC0's only host fails at ``fail_at``; DC1 holds just enough spare
    slots.  With evacuation on, every worker drains to DC1 at the alarm,
    progress kept, and each cloudlet meets its deadline; the
    restart-from-zero control (``evacuation=False, ckpt_interval=INF``)
    loses ``fail_at`` seconds of work, books downtime and misses them."""
    dev = resolve_device(device)
    hosts = uniform_hosts(2, 1, cores=n_workers, mips=mips, ram_mb=4096.0,
                          storage_mb=2_000_000.0, device=dev)
    vms = uniform_vms(n_workers, dc=0, cores=1, mips=mips, ram_mb=256.0,
                      storage_mb=1024.0, image_mb=1024.0, device=dev)
    cls = make_cloudlets(np.arange(n_workers), np.full(n_workers, task_mi),
                         np.zeros(n_workers), input_mb=0.0, output_mb=0.0,
                         deadline=deadline, device=dev)
    outages = workload.no_outages(2, 1, 1, device=dev)
    outages.fail_t[0, 0, 0] = fail_at
    outages.repair_t[0, 0, 0] = fail_at + repair_after
    pol = make_policy(
        host_policy=SPACE_SHARED, vm_policy=SPACE_SHARED,
        core_reserving=True, federation=True,
        sensor_interval=sensor_interval,
        migration_fixed_s=migration_fixed_s,
        interdc_bw_mbps=interdc_bw_mbps, horizon=horizon,
        ckpt_interval=ckpt_interval, evacuation=evacuation,
        evac_lead_s=evac_lead_s, device=dev)
    max_steps = (4 * (2 * n_workers) + 2 * int(horizon / sensor_interval)
                 + 4 * n_workers + 100)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(2, device=dev), policy=pol,
                    power=PowerModel.uniform(2, idle=idle_w, peak=peak_w,
                                             device=dev),
                    outages=outages, instruments=(ReliabilityInstrument(),),
                    max_steps=max_steps)


def staging_scenario(*, n_dc: int = 3, hosts_per_dc: int = 2,
                     vms_per_dc: int = 2, n_cloudlets: int = 48,
                     wave: int = 8, wave_dt: float = 2.0,
                     input_mb: float = 256.0, task_mi: float = 20_000.0,
                     bw_mbps: float = 100.0, latency_s: float = 0.05,
                     locality_dispatch: bool = False,
                     horizon: float = 1e6, device=None) -> Scenario:
    """Data-staging-heavy demo of the contention-aware network layer
    (DESIGN.md §13): service-routed cloudlets whose ``input_mb`` lives on
    ``input_dc = row % n_dc`` arrive in waves of ``wave`` every ``wave_dt``
    seconds, so their stage-ins overlap on the inter-DC links and fair
    sharing sets every completion time.  ``locality_dispatch`` switches the
    broker between least-loaded rank dispatch and the data-gravity score;
    it is data, so a campaign sweeps it."""
    dev = resolve_device(device)
    n_vms = n_dc * vms_per_dc
    hosts = uniform_hosts(n_dc, hosts_per_dc, cores=4, mips=1000.0,
                          ram_mb=8192.0, storage_mb=2_000_000.0, device=dev)
    vms = uniform_vms(n_vms, dc=np.arange(n_vms) % n_dc, cores=1,
                      mips=1000.0, ram_mb=256.0, storage_mb=1024.0,
                      image_mb=1024.0, device=dev)
    submit = (np.arange(n_cloudlets) // wave) * wave_dt
    cls = make_cloudlets(
        np.full(n_cloudlets, -1), np.full(n_cloudlets, task_mi), submit,
        input_mb=input_mb, output_mb=0.0,
        input_dc=np.arange(n_cloudlets) % n_dc, device=dev)
    pol = make_policy(horizon=horizon, interdc_bw_mbps=bw_mbps,
                      locality_dispatch=locality_dispatch, device=dev)
    return Scenario(
        hosts=hosts, vms=vms, cloudlets=cls,
        market=uniform_market(n_dc, device=dev), policy=pol,
        topology=Topology.uniform(n_dc, latency_s=latency_s,
                                  bw_mbps=bw_mbps, device=dev),
        max_steps=6 * n_cloudlets + 4 * n_vms + 300,
    )


# ---------------------------------------------------------------------------
# LLM-serving scenario (KV-bound continuous batching, DESIGN.md §14)
# ---------------------------------------------------------------------------

def serving_scenario(gen: torch.Generator, *, n_requests: int = 64,
                     n_replicas: int = 4, n_pool: int = 0,
                     kv_blocks: float = 64.0, rate: float = 0.5,
                     kind: str = "diurnal", block_tokens: float = 16.0,
                     batch_degradation: float = 0.05, mips: float = 1000.0,
                     token_mi: float = 10.0, median_prompt: float = 128.0,
                     median_new: float = 64.0, autoscale: bool = False,
                     scale_up_thresh: float = 0.75,
                     scale_down_thresh: float = 0.0,
                     sensor_interval: float = 50.0, boot_s: float = 30.0,
                     deadline_rel: float | None = None,
                     horizon: float = 1e6, max_steps: int | None = None,
                     device=None, **gen_kw) -> Scenario:
    """A simulated LLM-inference fleet: seeded request traffic
    (``workload.generate_serving_requests``) over ``n_replicas`` serving
    replicas of ``kv_blocks`` KV-cache blocks each, under KV-bound
    continuous batching; ``n_pool`` spare replicas ride the autoscaler
    (``autoscale`` gates it), and ``deadline_rel`` attaches SLA
    deadlines."""
    dev = resolve_device(device)
    n_vms = n_replicas + n_pool
    hosts = uniform_hosts(1, n_vms, cores=1, mips=mips, ram_mb=8192.0,
                          storage_mb=2_000_000.0, kv_blocks=kv_blocks,
                          device=dev)
    vms = uniform_vms(n_vms, mips=mips, ram_mb=512.0, storage_mb=1024.0,
                      kv_blocks=kv_blocks,
                      pool=np.arange(n_vms) >= n_replicas, device=dev)
    cls = workload.generate_serving_requests(
        gen, n_requests, kind=kind, rate=rate, token_mi=token_mi,
        median_prompt=median_prompt, median_new=median_new,
        deadline_rel=deadline_rel, device=dev, **gen_kw)
    pol = make_policy(
        host_policy=SPACE_SHARED, vm_policy=SPACE_SHARED,
        core_reserving=True, horizon=horizon,
        sensor_interval=sensor_interval, migration_fixed_s=boot_s,
        autoscale=autoscale, scale_up_thresh=scale_up_thresh,
        scale_down_thresh=scale_down_thresh,
        block_tokens=block_tokens, batch_degradation=batch_degradation,
        device=dev)
    if max_steps is None:
        # arrivals/dispatch/completions, one K_SERVING stop per KV-block
        # boundary (with headroom for the lognormal tail and preemption
        # churn), and autoscale ticks over a generous active span
        boundary = int(
            n_requests * (4.0 * median_new / max(block_tokens, 1.0) + 6.0))
        span = 2.0 * n_requests / max(rate, 1e-6) + (
            4.0 * n_requests * median_new * token_mi
            / (mips * max(n_replicas, 1)))
        max_steps = (4 * (n_requests + n_vms) + boundary
                     + int(span / sensor_interval) + 400)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(1, device=dev), policy=pol,
                    instruments=(AutoscaleInstrument(),),
                    max_steps=max_steps)

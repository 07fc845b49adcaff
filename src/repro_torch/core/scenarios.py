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

The generator-backed builders (``generated_scenario`` and the autoscale,
migration and reliability scenarios) belong to later slices; a test carries
a JAX-drawn workload across with ``convert.scenario_from_arrays``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.entities import (
    SPACE_SHARED, TIME_SHARED, Cloudlets, Hosts, Market, Policy, Scenario,
    VMRequests, resolve_device)

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

    ``live_migration=True`` needs the runtime ``MigrationInstrument``, which
    is not ported yet, and raises.
    """
    if live_migration:
        raise NotImplementedError(
            "table1_scenario(live_migration=True) needs MigrationInstrument, "
            "which is not ported to repro_torch yet")
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
        migrate_balance_thresh=migrate_balance_thresh,
        migrate_consolidate_thresh=migrate_consolidate_thresh,
        device=dev,
    )
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=uniform_market(n_dc, device=dev), policy=pol,
                    max_steps=4 * (total_vms + n_vms) + 1200)

"""CloudSim entities as dataclasses of tensors (the port of ``repro.core.entities``).

Same struct-of-arrays layout as the JAX reference: a datacenter is the ``d``
axis of every ``[D, H]`` host tensor, a VM a row of ``VMRequests``, a cloudlet
a row of ``Cloudlets`` (DESIGN.md §1).  Entity *counts* are shapes; entity
*state* is data.  Work counters are float32 and indices int32, as in the
reference (DESIGN.md §2, "f64-free").

The engine is batch-major: every function in ``core/`` takes a leading
scenario axis ``[B, ...]`` on every leaf (scalars become ``[B]``).  Scenario
constructors return one unbatched scenario; ``engine.simulate`` adds the axis
on entry and removes it on exit.

Each dataclass carries ``replace``, ``map`` and ``to(device)`` in place of the
reference's pytree registration; a tuple of trees (``Scenario.instruments``)
is walked like a nested tree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import Tensor

# Scheduling policies (paper §3.2, Figure 4).
SPACE_SHARED = 0
TIME_SHARED = 1

# A time/MI that behaves as "never/unreachable" (float32-representable).
INF = 3.0e38


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  Without one, the caller must ask for the CPU
    explicitly: the port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "engine on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class TensorTree:
    """Helpers shared by the frozen dataclasses below."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn):
        """Apply ``fn`` to every tensor leaf; nested trees (and tuples of
        them) recurse, and ``None`` and ints pass through."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Tensor):
                out[f.name] = fn(v)
            elif isinstance(v, TensorTree):
                out[f.name] = v.map(fn)
            elif isinstance(v, tuple):
                out[f.name] = tuple(
                    x.map(fn) if isinstance(x, TensorTree) else x for x in v)
        return dataclasses.replace(self, **out)

    def to(self, device):
        return self.map(lambda x: x.to(device))

    def leaves(self) -> list[Tensor]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Tensor):
                out.append(v)
            elif isinstance(v, TensorTree):
                out.extend(v.leaves())
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, TensorTree):
                        out.extend(x.leaves())
        return out


@dataclass(frozen=True)
class Hosts(TensorTree):
    """Physical machines, ``[D, H]`` per field (paper §3.1 ``Host``)."""

    cores: Tensor       # [D,H] i32  processing elements per host
    mips: Tensor        # [D,H] f32  MIPS per core
    ram_mb: Tensor      # [D,H] f32
    storage_mb: Tensor  # [D,H] f32
    bw_mbps: Tensor     # [D,H] f32
    kv_blocks: Tensor   # [D,H] f32  KV-cache blocks (0: not a serving host)
    exists: Tensor      # [D,H] bool (ragged datacenters are masked)

    @property
    def n_dc(self) -> int:
        return self.cores.shape[-2]

    @property
    def n_hosts(self) -> int:
        return self.cores.shape[-1]


@dataclass(frozen=True)
class VMRequests(TensorTree):
    """VM creation requests, ``[V]`` per field (paper §4 ``VirtualMachine``)."""

    dc: Tensor          # [V] i32  origin datacenter
    cores: Tensor       # [V] i32
    mips: Tensor        # [V] f32  per core
    ram_mb: Tensor      # [V] f32
    storage_mb: Tensor  # [V] f32
    bw_mbps: Tensor     # [V] f32
    kv_blocks: Tensor   # [V] f32  KV-cache blocks reserved on the host
    request_t: Tensor   # [V] f32  when the broker asks for the VM
    image_mb: Tensor    # [V] f32  migration transfer volume
    exists: Tensor      # [V] bool
    pool: Tensor        # [V] bool autoscaler spare rows

    @property
    def n_vms(self) -> int:
        return self.dc.shape[-1]


@dataclass(frozen=True)
class Cloudlets(TensorTree):
    """Task units, ``[C]`` per field (paper §4 ``Cloudlet``).  Rows are
    ordered by ``submit_t``: FCFS is row order.  ``vm == -1`` rows are
    broker-dispatched; ``prompt_tokens > 0`` rows are LLM-serving requests
    (see the reference's ``Cloudlets`` for the full contract)."""

    vm: Tensor              # [C] i32  target VM (-1: dispatched at submit)
    length_mi: Tensor       # [C] f32  per-core million instructions
    cores: Tensor           # [C] i32
    submit_t: Tensor        # [C] f32
    input_mb: Tensor        # [C] f32
    input_dc: Tensor        # [C] i32  (-1: VM-local input)
    output_mb: Tensor       # [C] f32
    deadline: Tensor        # [C] f32  absolute SLA finish time (INF: none)
    prompt_tokens: Tensor   # [C] f32
    max_new_tokens: Tensor  # [C] f32
    exists: Tensor          # [C] bool

    @property
    def n_cloudlets(self) -> int:
        return self.vm.shape[-1]


@dataclass(frozen=True)
class Outages(TensorTree):
    """Per-host failure/repair schedule, ``[D, H, K]`` per field (``[B, D,
    H, K]`` in the engine; K = max outages per host, DESIGN.md §9).

    A host is down during ``[fail_t[k], repair_t[k])``; windows along K are
    disjoint and sorted, and INF entries are padding ("no k-th outage"), so
    an MTBF = INF control shares its shapes with failing rows.  ``t`` is a
    scalar or the engine's ``[B]`` clock.
    """

    fail_t: Tensor    # [B,D,H,K] f32 outage starts (INF: padding)
    repair_t: Tensor  # [B,D,H,K] f32 outage ends

    def _clock(self, t) -> Tensor:
        t = torch.as_tensor(t, dtype=torch.float32, device=self.fail_t.device)
        return t.reshape(t.shape + (1, 1, 1))

    def down_at(self, t) -> Tensor:
        """[B, D, H] host inside an outage window at time ``t``."""
        t = self._clock(t)
        return ((self.fail_t <= t) & (t < self.repair_t)).any(-1)

    def next_fail_after(self, t) -> Tensor:
        """[B, D, H] earliest failure strictly after ``t`` (INF: none)."""
        t = self._clock(t)
        return torch.where(self.fail_t > t, self.fail_t, INF).amin(-1)

    def next_repair_after(self, t) -> Tensor:
        """[B, D, H] earliest repair strictly after ``t`` (INF: none)."""
        t = self._clock(t)
        return torch.where(self.repair_t > t, self.repair_t, INF).amin(-1)


@dataclass(frozen=True)
class Market(TensorTree):
    """Per-datacenter prices (paper §3.3), ``[D]`` per field."""

    cost_per_cpu_sec: Tensor
    cost_per_ram_mb: Tensor
    cost_per_storage_mb: Tensor
    cost_per_bw_mb: Tensor


@dataclass(frozen=True)
class Policy(TensorTree):
    """All policy selectors: scalar tensors (``[B]`` in a campaign), so a
    campaign may sweep them.  Field meanings as in ``repro.core.Policy``."""

    host_policy: Tensor        # i32 SPACE_SHARED | TIME_SHARED (VMM level)
    vm_policy: Tensor          # i32 cloudlet scheduler inside each VM
    federation: Tensor         # bool CloudCoordinator migration on/off
    core_reserving: Tensor     # bool provisioner also reserves PEs
    best_fit: Tensor           # bool best-fit (leftover RAM) vs first-fit
    sensor_interval: Tensor    # f32 Sensor refresh period
    migration_fixed_s: Tensor  # f32 fixed VM re-creation latency
    interdc_bw_mbps: Tensor    # f32 inter-datacenter link
    horizon: Tensor            # f32 simulation end time
    autoscale: Tensor          # bool
    scale_up_thresh: Tensor    # f32
    scale_down_thresh: Tensor  # f32
    live_migration: Tensor     # bool
    migrate_balance_thresh: Tensor      # f32
    migrate_consolidate_thresh: Tensor  # f32
    ckpt_interval: Tensor      # f32
    evacuation: Tensor         # bool
    evac_lead_s: Tensor        # f32
    locality_dispatch: Tensor  # bool
    block_tokens: Tensor       # f32 tokens per KV-cache block
    batch_degradation: Tensor  # f32 decode slow-down per extra batch member


@dataclass(frozen=True)
class Scenario(TensorTree):
    """A complete experiment: infrastructure + workload + policy + prices.

    ``power`` (an ``energy.PowerModel``), ``topology`` (an
    ``energy.Topology``: inter-DC links with contended transfers, DESIGN.md
    §13) and ``outages`` (an ``Outages`` schedule, usually from
    ``workload.host_outages``) are optional, as in the reference.
    ``instruments`` holds extra ``step.Instrument``s threaded after the
    defaults; their tensor fields are campaign data (stacked with the
    scenario).  ``max_steps`` is a static Python int (0: derived bound).
    The reference's ``sweep_impl`` has no counterpart: the advance sweep is
    routed by device.
    """

    hosts: Hosts
    vms: VMRequests
    cloudlets: Cloudlets
    market: Market
    policy: Policy
    power: object = None        # energy.PowerModel | None
    topology: object = None     # energy.Topology | None
    outages: Outages | None = None
    instruments: tuple = ()     # extra step.Instrument observables
    max_steps: int = 0

    def __post_init__(self):
        object.__setattr__(self, "instruments", tuple(self.instruments))


@dataclass(frozen=True)
class SimState(TensorTree):
    """Everything the event loop carries, batch-major (``[B, ...]``)."""

    t: Tensor             # [B] f32 simulation clock
    step: Tensor          # [B] i32 event-batch counter
    vm_host: Tensor       # [B,V] i32 host index within vm_dc, -1 if unplaced
    vm_dc: Tensor         # [B,V] i32 current datacenter
    vm_placed: Tensor     # [B,V] bool
    vm_failed: Tensor     # [B,V] bool creation rejected everywhere
    vm_evicted: Tensor    # [B,V] bool lost its slot to a host failure
    vm_avail_t: Tensor    # [B,V] f32 creation/migration completes
    vm_released: Tensor   # [B,V] bool resources returned
    vm_migrations: Tensor  # [B,V] i32
    vm_mig_src: Tensor    # [B,V] i32 source DC of an in-flight live move (-1)
    pool_active: Tensor   # [B,V] bool pool row activated by the autoscaler
    host_up: Tensor       # [B,D,H] bool
    free_ram: Tensor      # [B,D,H] f32
    free_storage: Tensor  # [B,D,H] f32
    free_bw: Tensor       # [B,D,H] f32
    free_cores: Tensor    # [B,D,H] f32
    free_kv: Tensor       # [B,D,H] f32
    cl_vm: Tensor         # [B,C] i32 current VM assignment (-1: undispatched)
    cl_ready_t: Tensor    # [B,C] f32 stage-in completes (INF until dispatched)
    cl_admitted: Tensor   # [B,C] bool serving row in its VM's decode batch
    cl_kv: Tensor         # [B,C] f32 KV blocks the row holds
    rem_mi: Tensor        # [B,C] f32 remaining MI (per core)
    cl_rollback_mi: Tensor  # [B,C] f32 work re-done after preemption
    started: Tensor       # [B,C] bool
    start_t: Tensor       # [B,C] f32 (INF until started)
    finish_t: Tensor      # [B,C] f32 (INF until finished)
    cpu_time: Tensor      # [B,C] f32 accumulated executing seconds
    sensed_load: Tensor   # [B,D] f32 last Sensor reading
    last_tick: Tensor     # [B] f32
    cpu_cost: Tensor      # [B,D] f32
    ram_cost: Tensor      # [B,D] f32
    storage_cost: Tensor  # [B,D] f32
    bw_cost: Tensor       # [B,D] f32
    energy_j: Tensor      # [B,D] f32
    vm_downtime: Tensor   # [B,V] f32
    n_evacuations: Tensor  # [B] i32
    # the transfer ledger (idle without Scenario.topology, DESIGN.md §13)
    link_busy: Tensor     # [B,D,D] i32 active transfers per directed link
    link_share: Tensor    # [B,D,D] f32 Mbps a transfer got at the last
                          #   recompute (the occupancy-change detector)
    vm_xfer_src: Tensor   # [B,V] i32 source DC of the image in flight (-1)
    vm_xfer_dst: Tensor   # [B,V] i32 its destination DC (pinned at commit)
    vm_xfer_rem: Tensor   # [B,V] f32 MB left as of the last recompute
    vm_xfer_share: Tensor  # [B,V] f32 Mbps it receives
    cl_xfer_dst: Tensor   # [B,C] i32 destination DC of the stage-in (-1)
    cl_xfer_rem: Tensor   # [B,C] f32 MB left as of the last recompute
    cl_xfer_share: Tensor  # [B,C] f32 Mbps it receives


@dataclass(frozen=True)
class SimResult(TensorTree):
    """Derived outcome of one simulation (the paper's tables).  Field
    meanings as in ``repro.core.SimResult``."""

    finish_t: Tensor
    start_t: Tensor
    cl_vm: Tensor
    turnaround: Tensor
    makespan: Tensor
    mean_turnaround: Tensor
    n_finished: Tensor
    n_events: Tensor
    n_migrations: Tensor
    vm_placed: Tensor
    vm_dc: Tensor
    vm_failed: Tensor
    cpu_cost: Tensor
    ram_cost: Tensor
    storage_cost: Tensor
    bw_cost: Tensor
    energy_j: Tensor
    total_cost: Tensor
    end_t: Tensor
    sla_violations: Tensor
    downtime: Tensor
    n_evacuations: Tensor
    ttft_p50: Tensor
    ttft_p99: Tensor
    tpot_p50: Tensor
    tpot_p99: Tensor


def finished_mask(res: SimResult) -> Tensor:
    return torch.isfinite(res.finish_t) & (res.finish_t < INF / 2)

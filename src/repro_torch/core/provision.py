"""VM provisioning, federated placement, broker dispatch, host failures
and live migration, batch-major.

The port of ``repro.core.provision`` without its topology branches: VMs are
placed in request order on the first host (or best fit) whose
RAM/storage/bandwidth (and, when core-reserving, cores) fit, in the origin
datacenter first and, with federation on, in the least-loaded feasible peer
(paper §4, Table 1).  ``apply_outages`` commits host failure/repair edges
(DESIGN.md §9), ``release_pool_vms`` the autoscaler's scale-down (§7) and
``live_migrate`` one coordinator move per row (§8).

``provision_due_vms`` keeps the reference's sequential order over VM rows,
which is semantic: it is a Python loop over ``v`` whose body is vectorised
over the whole ``[B, D, H]`` host table, V iterations for the batch.  It
writes its columns in place into copies it makes once per call, so the
caller's state is never mutated.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core import policies, segments
from repro_torch.core.entities import INF, Scenario, SimState
from repro_torch.core.segments import row_sum, take


def _host_index(scn: Scenario, state: SimState) -> Tensor:
    """[B, V] flat ``d * H + h`` of each VM's host, clipped into the table."""
    D, H = scn.hosts.n_dc, scn.hosts.n_hosts
    return state.vm_dc.clamp(0, D - 1) * H + state.vm_host.clamp(0, H - 1)


def _return_resources(scn: Scenario, state: SimState, newly: Tensor) -> SimState:
    """Give the host resources of the ``newly``-masked [B, V] VM rows back."""
    B, D, H = scn.hosts.cores.shape
    vms = scn.vms
    rows = torch.arange(B, device=newly.device).unsqueeze(-1)
    at = (_host_index(scn, state) + rows * (D * H)).reshape(-1)
    w = newly.float()

    def give(free: Tensor, amount: Tensor) -> Tensor:
        flat = free.reshape(-1).clone()
        segments.scatter_add_(flat, at, (w * amount).reshape(-1))
        return flat.view(B, D, H)

    return state.replace(
        free_ram=give(state.free_ram, vms.ram_mb),
        free_storage=give(state.free_storage, vms.storage_mb),
        free_bw=give(state.free_bw, vms.bw_mbps),
        free_cores=give(state.free_cores, vms.cores),
        free_kv=give(state.free_kv, vms.kv_blocks),
    )


def release_done_vms(scn: Scenario, state: SimState) -> SimState:
    """Return the resources of VMs whose whole workload finished."""
    done = policies.vm_done(scn, state)
    newly = done & state.vm_placed & ~state.vm_released
    state = _return_resources(scn, state, newly)
    return state.replace(vm_released=state.vm_released | newly)


def release_pool_vms(scn: Scenario, state: SimState, rel: Tensor) -> SimState:
    """Scale-down commit: the ``rel``-masked [B, V] pool VMs give their host
    resources back and return to the inactive pool state (placement
    cleared), so a later scale-up re-places the same row (DESIGN.md §7)."""
    newly = rel & state.vm_placed & ~state.vm_released
    state = _return_resources(scn, state, newly)
    return state.replace(
        pool_active=state.pool_active & ~newly,
        vm_placed=state.vm_placed & ~newly,
        vm_host=torch.where(newly, -1, state.vm_host),
        vm_dc=torch.where(newly, scn.vms.dc, state.vm_dc),
        vm_avail_t=torch.where(newly, INF, state.vm_avail_t),
        vm_mig_src=torch.where(newly, -1, state.vm_mig_src),
    )


def apply_outages(scn: Scenario, state: SimState) -> SimState:
    """Commit the host failure/repair edges due at the current clock (the
    K_FAILURE / K_REPAIR clock stops land the loop on them, DESIGN.md §9).

    **Failure**: every resident VM is evicted (placement cleared, the
    transient ``vm_evicted`` set, never the terminal ``vm_failed``), its
    in-flight cloudlets roll back to the last completed ``ckpt_interval``
    (INF: restart from zero), evicted serving rows lose their KV blocks, and
    the host's free ledger zeroes.  The row stays due, so the creation path
    re-places it.  **Repair**: the host comes back empty, its ledger full.
    ``vm_evicted`` clears once a VM is placed and available again.
    """
    if scn.outages is None:
        return state
    hosts, vms, cls, pol = scn.hosts, scn.vms, scn.cloudlets, scn.policy
    B, D, H = hosts.cores.shape
    down = scn.outages.down_at(state.t) & hosts.exists
    up_next = hosts.exists & ~down
    newly_down = state.host_up & down
    newly_up = ~state.host_up & up_next

    t = state.t[:, None]
    recovered = state.vm_evicted & state.vm_placed & (state.vm_avail_t <= t)
    evict = (vms.exists & state.vm_placed & ~state.vm_released
             & take(newly_down.reshape(B, D * H), _host_index(scn, state)))

    # checkpoint rollback: executed work floors to the last completed
    # ckpt_interval multiple; the difference is re-done work
    cl_evict = (
        cls.exists & (state.cl_vm >= 0)
        & take(evict, state.cl_vm.clamp(0, vms.n_vms - 1))
        & state.started & ~policies.cloudlet_finished(state)
    )
    executed = cls.length_mi - state.rem_mi
    ckpt = pol.ckpt_interval.clamp_min(1e-6)[:, None]
    kept = torch.where(
        (pol.ckpt_interval < INF / 2)[:, None],
        torch.minimum(torch.floor(executed / ckpt) * ckpt, executed),
        0.0)
    new_rem = torch.where(cl_evict, cls.length_mi - kept, state.rem_mi)

    def ledger(free: Tensor, capacity: Tensor) -> Tensor:
        return torch.where(newly_down, 0.0,
                           torch.where(newly_up, capacity, free))

    return state.replace(
        host_up=up_next,
        vm_placed=state.vm_placed & ~evict,
        vm_host=torch.where(evict, -1, state.vm_host),
        vm_dc=torch.where(evict, vms.dc, state.vm_dc),
        vm_avail_t=torch.where(evict, INF, state.vm_avail_t),
        vm_mig_src=torch.where(evict, -1, state.vm_mig_src),
        vm_evicted=(state.vm_evicted & ~recovered) | evict,
        rem_mi=new_rem,
        cl_rollback_mi=state.cl_rollback_mi + (new_rem - state.rem_mi),
        # a failure wipes the host's accelerator memory: evicted serving rows
        # lose their KV blocks and re-admit once their VM is re-placed
        cl_admitted=state.cl_admitted & ~cl_evict,
        cl_kv=torch.where(cl_evict, 0.0, state.cl_kv),
        free_ram=ledger(state.free_ram, hosts.ram_mb),
        free_storage=ledger(state.free_storage, hosts.storage_mb),
        free_bw=ledger(state.free_bw, hosts.bw_mbps),
        free_cores=ledger(state.free_cores, hosts.cores.float()),
        free_kv=ledger(state.free_kv, hosts.kv_blocks),
    )


def settle_transfers(scn: Scenario, state: SimState) -> SimState:
    """Close finished link transfers.  Only the no-topology path is ported."""
    if scn.topology is None:
        return state
    raise NotImplementedError(
        "settle_transfers is not ported to repro_torch yet")


def _vm_need(x: Tensor, v: int | Tensor) -> Tensor:
    """[B, 1, 1] column ``v`` of a [B, V] VM field: one row index for the
    whole batch (an int) or one per scenario row (a [B] tensor)."""
    col = x[:, v] if isinstance(v, int) else take(x, v.unsqueeze(-1))[:, 0]
    return col[:, None, None]


def resource_feasible(scn: Scenario, state: SimState,
                      v: int | Tensor) -> Tensor:
    """[B, D, H] hosts meeting RAM/storage/bandwidth/KV for VM row ``v``
    (an int, or a [B] tensor of one row per scenario)."""
    hosts, vms = scn.hosts, scn.vms

    def need(x: Tensor) -> Tensor:
        return _vm_need(x, v)

    return (
        hosts.exists
        & state.host_up
        & (state.free_ram >= need(vms.ram_mb))
        & (state.free_storage >= need(vms.storage_mb))
        & (state.free_bw >= need(vms.bw_mbps))
        & (state.free_kv >= need(vms.kv_blocks))
    )


def slot_feasible(scn: Scenario, state: SimState, v: int | Tensor) -> Tensor:
    """[B, D, H] free VM slots (resources + unreserved cores) for row ``v``."""
    return resource_feasible(scn, state, v) & (
        state.free_cores >= _vm_need(scn.vms.cores, v))


def dc_capacity_mips(scn: Scenario) -> Tensor:
    """[B, D] total core-MIPS capacity of each datacenter's hosts."""
    hosts = scn.hosts
    return row_sum(torch.where(hosts.exists, hosts.cores.float() * hosts.mips, 0.0))


# SimState columns provision_due_vms writes (copied once, then in place)
_PLACEMENT_FIELDS = (
    "vm_host", "vm_dc", "vm_placed", "vm_failed", "vm_avail_t",
    "vm_migrations", "free_ram", "free_storage", "free_bw", "free_cores",
    "free_kv", "ram_cost", "storage_cost", "bw_cost",
)


def provision_due_vms(scn: Scenario, state: SimState) -> tuple[SimState, Tensor]:
    """Attempt placement for every due, unplaced, unfailed VM request.

    Returns ``(state', [B] i32 VMs placed this call)``.  Per VM row: a
    vectorised feasibility test over the ``[D, H]`` host table of every
    scenario row, then datacenter first (origin slot < peer slot by sensed
    load, federation only < origin stack) and host within it (first fit or
    best fit by leftover RAM; stacking is least-loaded under federation).
    """
    hosts, vms, pol, mkt = scn.hosts, scn.vms, scn.policy, scn.market
    B, D, H = hosts.cores.shape
    dev = hosts.cores.device
    rows = torch.arange(B, device=dev)
    dcs = torch.arange(D, device=dev)
    first_fit = torch.arange(H, device=dev).float()
    big = 1e9
    st = state.replace(**{
        name: getattr(state, name).clone() for name in _PLACEMENT_FIELDS})
    n_placed = torch.zeros(B, dtype=torch.int32, device=dev)

    for v in range(vms.n_vms):
        due = (
            (vms.request_t[:, v] <= st.t)
            & (~vms.pool[:, v] | st.pool_active[:, v])
            & ~st.vm_placed[:, v]
            & ~st.vm_failed[:, v]
            & vms.exists[:, v]
        )
        feasible = resource_feasible(scn, st, v)
        slot_ok = feasible & (st.free_cores >= vms.cores[:, v, None, None])
        stack_ok = feasible & ~pol.core_reserving[:, None, None]
        origin = vms.dc[:, v]
        is_origin = dcs == origin[:, None]
        dc_slot = slot_ok.any(-1)
        dc_stack = stack_ok.any(-1)
        dc_key = torch.where(
            is_origin & dc_slot,
            0.0,
            torch.where(
                dc_slot & pol.federation[:, None] & ~is_origin,
                1.0 + st.sensed_load + dcs.float() * 1e-4,
                torch.where(is_origin & dc_stack, 3.0, big),
            ),
        )
        dsel = dc_key.argmin(-1)
        found = due & (dc_key[rows, dsel] < big)
        use_slot = dc_slot[rows, dsel][:, None]

        cand = torch.where(use_slot, slot_ok[rows, dsel], stack_ok[rows, dsel])
        free_ram_d = st.free_ram[rows, dsel]
        slot_key = torch.where(
            pol.best_fit[:, None], free_ram_d - vms.ram_mb[:, v, None], first_fit)
        stack_key = torch.where(pol.federation[:, None], -free_ram_d, first_fit)
        host_key = torch.where(use_slot, slot_key, stack_key)
        hsel = torch.where(cand, host_key, torch.inf).argmin(-1)

        migrated = found & (dsel != origin)
        w = found.float()
        dsafe = torch.where(found, dsel, 0)
        hsafe = torch.where(found, hsel, 0)
        delay = pol.migration_fixed_s + vms.image_mb[:, v] / (
            pol.interdc_bw_mbps.clamp_min(1e-6))
        boot = torch.where(vms.pool[:, v], pol.migration_fixed_s, 0.0)

        st.vm_host[:, v] = torch.where(found, hsel.int(), st.vm_host[:, v])
        st.vm_dc[:, v] = torch.where(found, dsel.int(), st.vm_dc[:, v])
        st.vm_placed[:, v] |= found
        # an ordinary request nothing can host is rejected terminally
        st.vm_failed[:, v] |= due & ~found & ~st.vm_evicted[:, v]
        st.vm_avail_t[:, v] = torch.where(
            found, st.t + boot + torch.where(migrated, delay, 0.0),
            st.vm_avail_t[:, v])
        st.vm_migrations[:, v] += migrated.int()
        at = (rows, dsafe, hsafe)
        st.free_ram[at] += -w * vms.ram_mb[:, v]
        st.free_storage[at] += -w * vms.storage_mb[:, v]
        st.free_bw[at] += -w * vms.bw_mbps[:, v]
        st.free_cores[at] += -w * vms.cores[:, v]
        st.free_kv[at] += -w * vms.kv_blocks[:, v]
        # market: RAM + storage billed at creation (paper §3.3); a migrated
        # image crosses the inter-DC link and is billed as bandwidth
        st.ram_cost[rows, dsafe] += (
            w * vms.ram_mb[:, v] * mkt.cost_per_ram_mb[rows, dsafe])
        st.storage_cost[rows, dsafe] += (
            w * vms.storage_mb[:, v] * mkt.cost_per_storage_mb[rows, dsafe])
        st.bw_cost[rows, dsafe] += (
            migrated.float() * vms.image_mb[:, v] * mkt.cost_per_bw_mb[rows, dsafe])
        n_placed += found.int()
    return st, n_placed


def live_migrate(scn: Scenario, state: SimState, v: Tensor, dst_dc: Tensor,
                 ok: Tensor, host_ok: Tensor | None = None
                 ) -> tuple[SimState, Tensor]:
    """Commit one runtime VM move per scenario row (DESIGN.md §8): VM
    ``v[b]`` to datacenter ``dst_dc[b]`` where ``ok[b]``.

    Stop-and-copy within one event: the source slot is released first, a
    slot at the destination is taken at once (first fit, or best fit under
    ``Policy.best_fit``; ``host_ok`` [B, D, H] narrows the landing hosts),
    and the VM is unavailable until ``t + migration_fixed_s + image/bw``
    through ``vm_avail_t``.  Its cloudlets keep their progress; the image is
    billed on the destination's bandwidth meter.  Returns ``(state',
    [B] moved)``.  (The reference's topology branch is not ported.)
    """
    hosts, vms, pol, mkt = scn.hosts, scn.vms, scn.policy, scn.market
    B, D, H = hosts.cores.shape
    V = vms.n_vms
    dev = hosts.cores.device
    rows = torch.arange(B, device=dev)

    fits = slot_feasible(scn, state, v)[rows, dst_dc]                 # [B,H]
    if host_ok is not None:
        fits = fits & host_ok[rows, dst_dc]
    ram_v = _vm_need(vms.ram_mb, v)[:, :, 0]                           # [B,1]
    host_key = torch.where(pol.best_fit[:, None],
                           state.free_ram[rows, dst_dc] - ram_v,
                           torch.arange(H, device=dev).float())
    h = torch.where(fits, host_key, torch.inf).argmin(-1)
    found = ok & fits.any(-1)

    col = torch.arange(V, device=dev) == v[:, None]                    # [B,V]
    src_d = take(state.vm_dc, v[:, None])[:, 0].clamp(0, D - 1)
    # source releases first: the departing slot is free for this step's
    # creations
    state = _return_resources(scn, state, col & found[:, None])

    moving = col & found[:, None]
    w = found.float()
    dsafe = torch.where(found, dst_dc, 0)
    hsafe = torch.where(found, h, 0)
    image = take(vms.image_mb, v[:, None])[:, 0]
    delay = pol.migration_fixed_s + image / pol.interdc_bw_mbps.clamp_min(1e-6)
    at = (rows, dsafe, hsafe)

    def occupy(free: Tensor, need: Tensor) -> Tensor:
        free = free.clone()
        free[at] += -w * take(need, v[:, None])[:, 0]
        return free

    bw_cost = state.bw_cost.clone()
    bw_cost[rows, dsafe] += w * image * mkt.cost_per_bw_mb[rows, dsafe]
    state = state.replace(
        vm_dc=torch.where(moving, dst_dc[:, None].int(), state.vm_dc),
        vm_host=torch.where(moving, h[:, None].int(), state.vm_host),
        vm_avail_t=torch.where(moving, (state.t + delay)[:, None],
                               state.vm_avail_t),
        vm_migrations=state.vm_migrations + moving.int(),
        vm_mig_src=torch.where(moving, src_d[:, None].int(), state.vm_mig_src),
        free_ram=occupy(state.free_ram, vms.ram_mb),
        free_storage=occupy(state.free_storage, vms.storage_mb),
        free_bw=occupy(state.free_bw, vms.bw_mbps),
        free_cores=occupy(state.free_cores, vms.cores),
        free_kv=occupy(state.free_kv, vms.kv_blocks),
        bw_cost=bw_cost,
    )
    return state, found


def eligible_dispatch_vms(scn: Scenario, state: SimState) -> Tensor:
    """[B, V] VMs the broker may route service cloudlets to."""
    vms = scn.vms
    return (
        vms.exists & state.vm_placed & ~state.vm_failed & ~state.vm_released
        & (~vms.pool | state.pool_active)
    )


def dispatch_cloudlets(scn: Scenario, state: SimState) -> SimState:
    """Broker dispatch of submitted service-routed rows (``vm == -1``): the
    k-th new arrival of an event takes the k-th least-loaded eligible VM
    (mod the eligible count); with nothing eligible the rows wait."""
    cls, vms, pol = scn.cloudlets, scn.vms, scn.policy
    V, D = vms.n_vms, scn.hosts.n_dc
    t = state.t[:, None]
    due = cls.exists & (state.cl_vm < 0) & (cls.submit_t <= t)
    eligible = eligible_dispatch_vms(scn, state)
    n_elig = eligible.sum(-1, dtype=torch.int32)[:, None]

    outstanding = policies.vm_outstanding_mi(scn, state)
    cap = (vms.cores.float() * vms.mips).clamp_min(1e-9)
    load_key = torch.where(eligible, outstanding / cap, INF)
    # stable, as jnp.argsort: ties keep VM row order (FCFS is semantic)
    vm_order = torch.argsort(load_key, dim=-1, stable=True)

    k = torch.cumsum(due.int(), -1, dtype=torch.int32) - 1
    pick = torch.where(n_elig > 0, k % n_elig.clamp_min(1), 0)
    chosen = take(vm_order, pick).clamp(0, V - 1)

    ok = due & (n_elig > 0)
    bw = take(vms.bw_mbps, chosen).clamp_min(1e-6)
    stage_in = torch.where(cls.input_mb > 0, cls.input_mb / bw, 0.0)
    ready = t + stage_in
    vdc_chosen = take(state.vm_dc, chosen).clamp(0, D - 1)
    remote = (cls.input_dc >= 0) & (cls.input_dc != vdc_chosen)
    ready = torch.where(
        remote,
        t + cls.input_mb / pol.interdc_bw_mbps.clamp_min(1e-6)[:, None],
        ready)
    return state.replace(
        cl_vm=torch.where(ok, chosen.int(), state.cl_vm),
        cl_ready_t=torch.where(ok, ready, state.cl_ready_t),
    )


def demand_load(scn: Scenario, state: SimState) -> Tensor:
    """[B, D] ready-but-unfinished MIPS demand over DC capacity."""
    D = scn.hosts.n_dc
    vm_demand = policies.vm_demand_mips(scn, state)
    demand = segments.segment_sum(vm_demand, state.vm_dc.clamp(0, D - 1), D)
    return demand / dc_capacity_mips(scn).clamp_min(1e-9)


def sense_load(scn: Scenario, state: SimState) -> Tensor:
    """[B, D] Sensor reading: fraction of RAM capacity committed."""
    hosts = scn.hosts
    total = row_sum(torch.where(hosts.exists, hosts.ram_mb, 0.0))
    free = row_sum(torch.where(hosts.exists, state.free_ram, 0.0))
    return torch.where(total > 0, 1.0 - free / total, 1.0)

"""VM provisioning, federated placement, broker dispatch, host failures,
live migration and inter-DC transfers, batch-major.

The port of ``repro.core.provision``: VMs are placed in request order on the
first host (or best fit) whose RAM/storage/bandwidth (and, when
core-reserving, cores) fit, in the origin datacenter first and, with
federation on, in the least-loaded feasible peer (paper §4, Table 1).
``apply_outages`` commits host failure/repair edges (DESIGN.md §9),
``release_pool_vms`` the autoscaler's scale-down (§7) and ``live_migrate``
one coordinator move per row (§8).

Under a ``Scenario.topology`` (DESIGN.md §13) every inter-DC byte draws
fair-share bandwidth from the link ledger (``SimState.link_busy`` /
``link_share``): migrations open an image transfer on their link,
network stage-ins open in ``transfer_phase``, which also re-times the
transfers of links whose occupancy changed, and ``settle_transfers``
closes them.  The ledger's counts are integer scatters into ``[B, D, D]``
(exact in any order); no float of the ledger is built by a scatter.

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


def _link(scn: Scenario, src: Tensor, dst: Tensor) -> Tensor:
    """Flat ``[B, ...]`` index ``s * D + d`` of links into a row's
    ``[D, D]`` ledger (``src``, ``dst`` already clipped into range)."""
    return src.long() * scn.hosts.n_dc + dst.long()


def _at_link(x: Tensor, link: Tensor) -> Tensor:
    """``x[b, s, d]`` of a ``[B, D, D]`` tensor at ``[B, N]`` flat links."""
    return take(x.flatten(1), link)


def _add_links(busy: Tensor, link: Tensor, count: Tensor) -> Tensor:
    """``busy`` [B, D, D] i32 plus ``count`` [B, N] added at ``link``
    [B, N] (repeated links sum; an integer sum is exact in any order)."""
    B, D, _ = busy.shape
    rows = torch.arange(B, device=busy.device).unsqueeze(-1) * (D * D)
    flat = busy.reshape(-1).clone()
    segments.scatter_add_(flat, (link + rows).reshape(-1),
                          count.to(busy.dtype).reshape(-1))
    return flat.view(B, D, D)


def settle_transfers(scn: Scenario, state: SimState) -> SimState:
    """Close finished or cancelled transfers and free their link slots.

    Runs at the top of every event (topology only), before the instruments
    and phases: a transfer closes when its completion time has come (``<=
    t``) or was reset to INF in flight (the VM was evicted or released), so
    the same VM may open a fresh transfer in this event.  Bitwise a no-op
    when nothing closes.
    """
    if scn.topology is None:
        return state
    D = scn.hosts.n_dc
    t = state.t[:, None]
    vm_close = (state.vm_xfer_src >= 0) & (
        (state.vm_avail_t <= t) | (state.vm_avail_t >= INF / 2))
    cl_close = (state.cl_xfer_dst >= 0) & (
        (state.cl_ready_t <= t) | (state.cl_ready_t >= INF / 2))
    vm_link = _link(scn, state.vm_xfer_src.clamp(0, D - 1),
                    state.vm_xfer_dst.clamp(0, D - 1))
    cl_link = _link(scn, scn.cloudlets.input_dc.clamp(0, D - 1),
                    state.cl_xfer_dst.clamp(0, D - 1))
    busy = _add_links(state.link_busy, torch.cat([vm_link, cl_link], -1),
                      -torch.cat([vm_close, cl_close], -1).int())
    return state.replace(
        link_busy=busy,
        vm_xfer_src=torch.where(vm_close, -1, state.vm_xfer_src),
        vm_xfer_dst=torch.where(vm_close, -1, state.vm_xfer_dst),
        vm_xfer_rem=torch.where(vm_close, 0.0, state.vm_xfer_rem),
        vm_xfer_share=torch.where(vm_close, 0.0, state.vm_xfer_share),
        cl_xfer_dst=torch.where(cl_close, -1, state.cl_xfer_dst),
        cl_xfer_rem=torch.where(cl_close, 0.0, state.cl_xfer_rem),
        cl_xfer_share=torch.where(cl_close, 0.0, state.cl_xfer_share),
    )


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
# ... and under a topology, the image transfers it opens on the ledger
_LEDGER_FIELDS = (
    "link_busy", "vm_xfer_src", "vm_xfer_dst", "vm_xfer_rem", "vm_xfer_share",
)


def provision_due_vms(scn: Scenario, state: SimState) -> tuple[SimState, Tensor]:
    """Attempt placement for every due, unplaced, unfailed VM request.

    Returns ``(state', [B] i32 VMs placed this call)``.  Per VM row: a
    vectorised feasibility test over the ``[D, H]`` host table of every
    scenario row, then datacenter first (origin slot < peer slot by sensed
    load, federation only < origin stack) and host within it (first fit or
    best fit by leftover RAM; stacking is least-loaded under federation).

    Under a topology, peers are also ranked by their latency from the
    origin (normalised over the finite latencies: a disconnected peer gets
    a flat penalty and stays a last resort), a migrated image takes the
    fair share of its link with one more transfer on it, and the transfer
    opens on the ledger.
    """
    hosts, vms, pol, mkt, topo = (scn.hosts, scn.vms, scn.policy,
                                  scn.market, scn.topology)
    B, D, H = hosts.cores.shape
    dev = hosts.cores.device
    rows = torch.arange(B, device=dev)
    dcs = torch.arange(D, device=dev)
    first_fit = torch.arange(H, device=dev).float()
    big = 1e9
    written = _PLACEMENT_FIELDS + (() if topo is None else _LEDGER_FIELDS)
    st = state.replace(**{
        name: getattr(state, name).clone() for name in written})
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
        peer_score = st.sensed_load
        if topo is not None:
            # INF/INF would poison the whole key row with NaN
            lat = topo.latency_s[rows, origin.long()]                 # [B,D]
            lat_ok = torch.isfinite(lat)
            lat_max = torch.where(lat_ok, lat, 0.0).amax(-1, keepdim=True)
            peer_score = peer_score + torch.where(
                lat_ok, lat / lat_max.clamp_min(1e-9), 2.0)
        dc_key = torch.where(
            is_origin & dc_slot,
            0.0,
            torch.where(
                dc_slot & pol.federation[:, None] & ~is_origin,
                1.0 + peer_score + dcs.float() * 1e-4,
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
        if topo is not None:
            # fair share of the (origin, dsafe) link with this image on it:
            # an idle link's full bandwidth, bitwise the flat divisor
            link = (rows, origin.long(), dsafe)
            share0 = topo.bw_mbps[link] / (st.link_busy[link] + 1).float()
            delay = (pol.migration_fixed_s + topo.latency_s[link]
                     + vms.image_mb[:, v] / share0.clamp_min(1e-6))
        else:
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
        if topo is not None:
            # open the image transfer on the link ledger
            st.link_busy[link] += migrated.int()
            st.vm_xfer_src[:, v] = torch.where(migrated, origin,
                                               st.vm_xfer_src[:, v])
            st.vm_xfer_dst[:, v] = torch.where(migrated, dsafe.int(),
                                               st.vm_xfer_dst[:, v])
            st.vm_xfer_rem[:, v] = torch.where(migrated, vms.image_mb[:, v],
                                               st.vm_xfer_rem[:, v])
            st.vm_xfer_share[:, v] = torch.where(migrated, share0,
                                                 st.vm_xfer_share[:, v])
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
    billed on the destination's bandwidth meter.  Under a topology the
    image takes the fair share of its ``(src, dst)`` link with one more
    transfer on it, plus the link's latency, and opens on the ledger.
    Returns ``(state', [B] moved)``.
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
    ledger = {}
    if scn.topology is not None:
        topo = scn.topology
        link = (rows, src_d.long(), dsafe)
        share0 = topo.bw_mbps[link] / (state.link_busy[link] + 1).float()
        delay = (pol.migration_fixed_s + topo.latency_s[link]
                 + image / share0.clamp_min(1e-6))
        busy = state.link_busy.clone()
        busy[link] += found.int()
        ledger = dict(
            link_busy=busy,
            vm_xfer_src=torch.where(moving, src_d[:, None].int(),
                                    state.vm_xfer_src),
            vm_xfer_dst=torch.where(moving, dsafe[:, None].int(),
                                    state.vm_xfer_dst),
            vm_xfer_rem=torch.where(moving, image[:, None], state.vm_xfer_rem),
            vm_xfer_share=torch.where(moving, share0[:, None],
                                      state.vm_xfer_share),
        )
    else:
        delay = pol.migration_fixed_s + image / pol.interdc_bw_mbps.clamp_min(
            1e-6)
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
        **ledger,
    )
    return state, found


def eligible_dispatch_vms(scn: Scenario, state: SimState) -> Tensor:
    """[B, V] VMs the broker may route service cloudlets to."""
    vms = scn.vms
    return (
        vms.exists & state.vm_placed & ~state.vm_failed & ~state.vm_released
        & (~vms.pool | state.pool_active)
    )


def _locality_choice(scn: Scenario, state: SimState, eligible: Tensor,
                     queue_s: Tensor) -> Tensor:
    """[B, C] the VM of least ``queue seconds + estimated stage-in
    seconds`` for each cloudlet (``Policy.locality_dispatch``), the
    estimate taking the link's fair share with one more transfer on it.

    The ``[B, C, V]`` score is built in place in two temporaries (256 MiB
    each at 1,024 x 512 x 128): per-(source DC, VM) shares and latencies
    ``[B, D, V]`` first, gathered along the cloudlet's source DC.
    """
    topo, cls, vms = scn.topology, scn.cloudlets, scn.vms
    B, C = cls.input_dc.shape
    V, D = vms.n_vms, scn.hosts.n_dc
    vdc = state.vm_dc.clamp(0, D - 1).long()                          # [B,V]
    at = vdc[:, None, :].expand(B, D, V)
    share = (topo.bw_mbps.gather(2, at)
             / (state.link_busy.gather(2, at) + 1).float())           # [B,D,V]
    src = cls.input_dc.clamp(0, D - 1).long()[:, :, None].expand(B, C, V)
    est = share.gather(1, src).clamp_min_(1e-6)                       # [B,C,V]
    torch.div(cls.input_mb[:, :, None], est, out=est)
    score = topo.latency_s.gather(2, at).gather(1, src)               # [B,C,V]
    est.add_(score)
    # VM-local stage-in for rows without an input DC, into the second buffer
    torch.div(cls.input_mb[:, :, None],
              vms.bw_mbps.clamp_min(1e-6)[:, None, :], out=score)
    torch.where((cls.input_dc >= 0)[:, :, None], est, score, out=score)
    del est
    score.add_(queue_s[:, None, :])
    score.masked_fill_(~eligible[:, None, :], INF)
    return score.argmin(-1)


def dispatch_cloudlets(scn: Scenario, state: SimState) -> SimState:
    """Broker dispatch of submitted service-routed rows (``vm == -1``): the
    k-th new arrival of an event takes the k-th least-loaded eligible VM
    (mod the eligible count); with nothing eligible the rows wait.

    Under a topology, ``Policy.locality_dispatch`` rows take the VM of
    least queue plus estimated transfer time instead (data gravity against
    queue depth), and network rows (``input_dc >= 0``) keep an INF ready
    time: the transfer phase opens and prices their stage-in in this same
    event.  Without a topology a remote input bills the flat
    ``interdc_bw_mbps`` divisor."""
    cls, vms, pol = scn.cloudlets, scn.vms, scn.policy
    V, D = vms.n_vms, scn.hosts.n_dc
    t = state.t[:, None]
    due = cls.exists & (state.cl_vm < 0) & (cls.submit_t <= t)
    eligible = eligible_dispatch_vms(scn, state)
    n_elig = eligible.sum(-1, dtype=torch.int32)[:, None]

    outstanding = policies.vm_outstanding_mi(scn, state)
    cap = (vms.cores.float() * vms.mips).clamp_min(1e-9)
    queue_s = outstanding / cap
    load_key = torch.where(eligible, queue_s, INF)
    # stable, as jnp.argsort: ties keep VM row order (FCFS is semantic)
    vm_order = torch.argsort(load_key, dim=-1, stable=True)

    k = torch.cumsum(due.int(), -1, dtype=torch.int32) - 1
    pick = torch.where(n_elig > 0, k % n_elig.clamp_min(1), 0)
    chosen = take(vm_order, pick).clamp(0, V - 1)
    if scn.topology is not None:
        chosen = torch.where(pol.locality_dispatch[:, None],
                             _locality_choice(scn, state, eligible, queue_s),
                             chosen)

    ok = due & (n_elig > 0)
    bw = take(vms.bw_mbps, chosen).clamp_min(1e-6)
    stage_in = torch.where(cls.input_mb > 0, cls.input_mb / bw, 0.0)
    ready = t + stage_in
    if scn.topology is not None:
        ready = torch.where(cls.input_dc >= 0, INF, ready)
    else:
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


def _staging_due(scn: Scenario, state: SimState) -> Tensor:
    """[B, C] network stage-ins ready to open now: submitted, bound to a
    placed VM, neither in flight nor staged (topology only)."""
    cls = scn.cloudlets
    vmi = state.cl_vm.clamp(0, scn.vms.n_vms - 1)
    return (
        cls.exists
        & (cls.input_dc >= 0)
        & (state.cl_vm >= 0)
        & (state.cl_xfer_dst < 0)
        & (state.cl_ready_t >= INF / 2)
        & (cls.submit_t <= state.t[:, None])
        & take(state.vm_placed, vmi)
    )


def transfer_needed(scn: Scenario, state: SimState) -> Tensor:
    """[B] the transfer phase has something to do in this row."""
    return (_staging_due(scn, state).any(-1)
            | (state.vm_xfer_src >= 0).any(-1)
            | (state.cl_xfer_dst >= 0).any(-1))


def _retime(t: Tensor, done_t: Tensor, rem: Tensor, own: Tensor):
    """``(head, rem')`` of transfers whose share changes at clock ``t``:
    the remaining window ``done_t - t`` is a head of latency not yet
    elapsed followed by the byte tail ``rem / own``; ``rem'`` is the MB
    still to move."""
    own = own.clamp_min(1e-6)
    w = done_t - t
    tail = rem / own
    wb = torch.minimum(w, tail)
    head = w - wb
    return head, torch.where(wb < tail, own * wb, rem)


def transfer_phase(scn: Scenario, state: SimState) -> SimState:
    """Open due stage-ins and re-time the in-flight transfers of links
    whose occupancy changed (the fair-share recompute, DESIGN.md §13).

    ``link_share`` holds the Mbps granted at the last recompute, so
    ``fair_share(link_busy) != link_share`` finds exactly the links whose
    population changed since: settles, migration commits and the opens
    here.  Transfers on unchanged links stay bitwise as they are, which
    keeps uncontended topology runs identical to the flat path.  The
    re-timing is analytic: the new completion is ``t + head + rem' /
    share_new``, so k equal transfers on one link finish after the head
    plus k times the lone transfer's byte time.
    """
    topo, cls, vms = scn.topology, scn.cloudlets, scn.vms
    D = scn.hosts.n_dc
    t = state.t[:, None]

    # --- open due stage-ins, priced at the share after the opens ---
    opening = _staging_due(scn, state)
    vmi = state.cl_vm.clamp(0, vms.n_vms - 1)
    so = torch.where(opening, cls.input_dc.clamp(0, D - 1), 0)
    do = torch.where(opening, take(state.vm_dc, vmi).clamp(0, D - 1), 0)
    link_o = _link(scn, so, do)
    busy = _add_links(state.link_busy, link_o, opening.int())
    share_new = topo.fair_share(busy)                                 # [B,D,D]
    shr_o = _at_link(share_new, link_o)
    ready_o = (t + _at_link(topo.latency_s, link_o)
               + cls.input_mb / shr_o.clamp_min(1e-6))
    cl_ready_t = torch.where(opening, ready_o, state.cl_ready_t)
    cl_xfer_dst = torch.where(opening, do, state.cl_xfer_dst)
    cl_xfer_rem = torch.where(opening, cls.input_mb, state.cl_xfer_rem)
    cl_xfer_share = torch.where(opening, shr_o, state.cl_xfer_share)

    changed = share_new != state.link_share                           # [B,D,D]

    # in-flight VM images on changed links
    link_v = _link(scn, state.vm_xfer_src.clamp(0, D - 1),
                   state.vm_xfer_dst.clamp(0, D - 1))
    hit_v = (state.vm_xfer_src >= 0) & _at_link(changed, link_v)
    snew_v = _at_link(share_new, link_v).clamp_min(1e-6)
    head_v, rem_v = _retime(t, state.vm_avail_t, state.vm_xfer_rem,
                            state.vm_xfer_share)
    vm_avail_t = torch.where(hit_v, t + head_v + rem_v / snew_v,
                             state.vm_avail_t)

    # in-flight stage-ins on changed links (those just opened are priced)
    link_c = _link(scn, cls.input_dc.clamp(0, D - 1),
                   state.cl_xfer_dst.clamp(0, D - 1))
    hit_c = (state.cl_xfer_dst >= 0) & ~opening & _at_link(changed, link_c)
    snew_c = _at_link(share_new, link_c).clamp_min(1e-6)
    head_c, rem_c = _retime(t, state.cl_ready_t, state.cl_xfer_rem,
                            state.cl_xfer_share)

    return state.replace(
        link_busy=busy,
        link_share=share_new,
        vm_avail_t=vm_avail_t,
        vm_xfer_rem=torch.where(hit_v, rem_v, state.vm_xfer_rem),
        vm_xfer_share=torch.where(hit_v, snew_v, state.vm_xfer_share),
        cl_ready_t=torch.where(hit_c, t + head_c + rem_c / snew_c, cl_ready_t),
        cl_xfer_dst=cl_xfer_dst,
        cl_xfer_rem=torch.where(hit_c, rem_c, cl_xfer_rem),
        cl_xfer_share=torch.where(hit_c, snew_c, cl_xfer_share),
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

"""KV-cache-bound continuous batching: the LLM-serving phase (DESIGN.md §14),
batch-major.  The port of ``repro.core.kvserve``.

Per event: finished rows release their KV blocks, admitted rows commit
context growth, a VM whose committed blocks exceed its pool preempts its
youngest residents, and ready waiting rows are admitted FCFS while they fit.
``serving_bound`` stops the clock at the next block boundary.  Every write
is gated on the serving mask: scenarios without serving rows are untouched.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core import policies, segments
from repro_torch.core.entities import INF, Scenario, SimState
from repro_torch.core.segments import take

# token-count comparisons tolerate 0.1 token of float32 drift
TOKEN_EPS = 0.1


def is_serving(scn: Scenario) -> Tensor:
    """[B, C] existing token-generation rows."""
    cls = scn.cloudlets
    return cls.exists & (cls.prompt_tokens > 0.0)


def token_mi(scn: Scenario) -> Tensor:
    """[B, C] MI per generated token."""
    cls = scn.cloudlets
    return cls.length_mi / cls.max_new_tokens.clamp_min(1.0)


def generated_tokens(scn: Scenario, state: SimState) -> Tensor:
    """[B, C] tokens emitted so far (fractional between boundary events)."""
    cls = scn.cloudlets
    g = (cls.length_mi - state.rem_mi) / token_mi(scn).clamp_min(1e-9)
    return torch.minimum(g.clamp_min(0.0), cls.max_new_tokens)


def context_tokens(scn: Scenario, state: SimState) -> Tensor:
    """[B, C] prompt plus generated tokens."""
    return scn.cloudlets.prompt_tokens + generated_tokens(scn, state)


def blocks_needed(scn: Scenario, state: SimState) -> Tensor:
    """[B, C] KV blocks a serving row needs now: its filled blocks plus the
    open block its next token writes into."""
    bt = scn.policy.block_tokens.clamp_min(1.0)[:, None]
    ctx = context_tokens(scn, state)
    return torch.where(
        is_serving(scn), torch.floor((ctx + TOKEN_EPS) / bt) + 1.0, 0.0)


def serving_needed(scn: Scenario) -> Tensor:
    """[B] the scenario row carries serving rows at all (the phase's skip
    predicate; it reads the scenario only, so a driver evaluates it once)."""
    return is_serving(scn).any(-1)


def serving_phase(scn: Scenario, state: SimState) -> SimState:
    """One KV-block ledger sweep: release, growth commit, eviction,
    admission."""
    cls, vms = scn.cloudlets, scn.vms
    V = vms.n_vms
    srv = is_serving(scn)
    vmi = state.cl_vm.clamp(0, V - 1)
    fin = policies.cloudlet_finished(state)
    need = blocks_needed(scn, state)

    # 1 + 2: finished rows release; admitted rows commit context growth
    admitted = state.cl_admitted & ~fin
    cl_kv = torch.where(admitted, need, 0.0)

    # 3: per-VM overflow -> evict the minimal youngest suffix
    seg = torch.where(admitted, vmi, V)
    blocks = torch.where(admitted, cl_kv, 0.0)
    usage = segments.segment_sum(blocks, seg, V)
    over = (usage - vms.kv_blocks).clamp_min(0.0)
    prefix = segments.segment_prefix_sum(blocks, seg, V)
    younger = take(usage, vmi) - (prefix + blocks)
    evict = admitted & (younger < take(over, vmi) - 1e-6)

    # a preempted request keeps only its completed tokens' work
    tok = token_mi(scn)
    g_keep = torch.floor(generated_tokens(scn, state) + TOKEN_EPS)
    executed = cls.length_mi - state.rem_mi
    kept = torch.minimum(g_keep * tok, executed)
    new_rem = torch.where(evict, cls.length_mi - kept, state.rem_mi)

    admitted = admitted & ~evict
    cl_kv = torch.where(evict, 0.0, cl_kv)
    usage = usage - segments.segment_sum(torch.where(evict, blocks, 0.0), seg, V)

    # 4: FCFS admission among ready waiting rows on placed, booted VMs
    ready = policies.cloudlet_ready(scn, state)
    cand = (
        srv & ~fin & ~admitted & ~evict & ready
        & (state.cl_vm >= 0) & take(state.vm_placed, vmi)
        & (state.t[:, None] >= take(state.vm_avail_t, vmi))
    )
    seg_c = torch.where(cand, vmi, V)
    need_c = torch.where(cand, need, 0.0)
    prefix_c = segments.segment_prefix_sum(need_c, seg_c, V)
    admit = cand & (
        take(usage, vmi) + prefix_c + need <= take(vms.kv_blocks, vmi) + 1e-6)
    admitted = admitted | admit
    cl_kv = torch.where(admit, need, cl_kv)

    return state.replace(
        cl_admitted=admitted,
        cl_kv=cl_kv,
        rem_mi=new_rem,
        cl_rollback_mi=state.cl_rollback_mi + (new_rem - state.rem_mi),
    )


def serving_bound(scn: Scenario, state: SimState, rate: Tensor) -> Tensor:
    """[B] earliest block-boundary crossing among decoding rows (INF when
    nothing decodes)."""
    fin = policies.cloudlet_finished(state)
    occ = is_serving(scn) & state.cl_admitted & ~fin & (rate > 0)
    bt = scn.policy.block_tokens.clamp_min(1.0)[:, None]
    ctx = context_tokens(scn, state)
    nxt = (torch.floor((ctx + TOKEN_EPS) / bt) + 1.0) * bt
    to_go = (nxt - ctx).clamp_min(0.0)
    t_cross = state.t[:, None] + to_go * token_mi(scn) / rate.clamp_min(1e-9)
    return segments.min_where(t_cross, occ)

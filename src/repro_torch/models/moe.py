"""Mixture-of-Experts with top-k routing and a capacity bound: the port of
``repro.models.moe``'s local path.

One device: sort-based dispatch into an ``[E, capacity, D]`` buffer, the
expert SwiGLU as three batched products (``torch.bmm``), and a combine back
to the tokens.  The JAX package computes all of this with ``jnp``, outside
any Pallas kernel, so the port keeps it as PyTorch operations.  The
reference's ``_moe_shard_map`` (expert parallelism over a device mesh)
waits for ``dist/``.

Three choices keep the card's results repeatable and the reference's:

* **Top-k by a stable descending sort.**  ``jax.lax.top_k`` puts the lower
  expert first on a tie; ``torch.topk`` promises no order on CUDA.
* **Dispatch adds.**  A dropped token (past its expert's capacity) writes a
  zero row into slot 0 of its expert, as the reference's ``.at[].add``
  does; an indexed store would let that zero overwrite the token that
  holds slot 0, with an undefined winner.  ``index_put_`` with
  ``accumulate=True`` adds, and adding zero changes nothing.
* **The combine adds each token's K contributions in ascending expert
  order**, the order of the reference's scatter-add over the expert-sorted
  list, rounding to the compute dtype after each add, with no atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.models import layers


def init_moe(generator: torch.Generator, cfg) -> dict:
    """Random parameters on ``generator.device``, drawn in the reference's
    order: router, w_gate, w_up, w_down."""
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.n_experts, m.d_ff
    return {
        "router": layers.trunc_normal(generator, (D, E)),
        "w_gate": layers.trunc_normal(generator, (E, D, F_)),
        "w_up": layers.trunc_normal(generator, (E, D, F_)),
        "w_down": layers.trunc_normal(generator, (E, F_, D)),
    }


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    """Slots per expert for ``n_tokens`` tokens of one call, padded to 8."""
    cap = int(n_tokens * top_k / n_experts * factor) + 1
    return max(8, ((cap + 7) // 8) * 8)


def _route(xt: Tensor, router: Tensor, E: int, K: int):
    """Router math in f32: (gates ``[T, K]`` renormalised over the top K,
    experts ``[T, K]`` most probable first, lower index first on a tie,
    me ``[E]`` the mean probability, ce ``[E]`` the mean count chosen).
    The balance loss is ``E * sum(me * ce)``."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate_vals, expert_ids = probs.sort(dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[:, :K], expert_ids[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(0)
    ce = F.one_hot(expert_ids, E).float().sum(1).mean(0)
    return gate_vals, expert_ids, me, ce


def _dispatch_slots(expert_ids_flat: Tensor, n_segments: int, cap: int):
    """First come, first served slots within each expert (a stable sort and
    a prefix count): (order, experts sorted, slot, keep)."""
    order = torch.argsort(expert_ids_flat, stable=True)
    e_sorted = expert_ids_flat[order]
    seg = e_sorted.clamp(0, n_segments)
    start = torch.zeros(n_segments + 2, dtype=torch.int64,
                        device=e_sorted.device)
    start.index_add_(0, seg + 1, torch.ones_like(seg))
    offsets = start.cumsum(0)[:-1]
    slot = torch.arange(e_sorted.shape[0], device=e_sorted.device) \
        - offsets[seg]
    keep = (slot < cap) & (e_sorted < n_segments)
    return order, e_sorted, slot, keep


def _expert_ffn(params: dict, xe: Tensor) -> Tensor:
    """The SwiGLU of every expert over its slots: xe ``[E, C, D]``."""
    dt = xe.dtype
    g = torch.bmm(xe, params["w_gate"].to(dt))
    u = torch.bmm(xe, params["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, params["w_down"].to(dt))


def moe_apply(params: dict, cfg, x: Tensor) -> tuple[Tensor, Tensor]:
    """x ``[B, S, D]`` -> (out ``[B, S, D]``, the balance loss, a 0-d f32
    tensor).  The capacity comes from this call's ``T = B * S`` tokens."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, K = B * S, m.n_experts, m.top_k
    xt = x.reshape(T, D)
    dt = x.dtype

    gate_vals, expert_ids, me, ce = _route(xt, params["router"], E, K)
    aux = E * (me * ce).sum()
    cap = _capacity(T, E, K, m.capacity_factor)
    # each token's choices in ascending expert order: the slots are the
    # same (one entry per token and expert, sorted by token), and the
    # combine below then adds in the reference's order
    expert_ids, perm = expert_ids.sort(dim=-1)
    gate_vals = gate_vals.gather(-1, perm)
    flat_e = expert_ids.reshape(T * K)
    order, e_sorted, slot, keep = _dispatch_slots(flat_e, E, cap)
    t_sorted = torch.div(order, K, rounding_mode="floor")
    g_sorted = gate_vals.reshape(T * K)[order]
    slot_c = torch.where(keep, slot, 0)
    e_safe = e_sorted.clamp(0, E - 1)

    xe = torch.zeros((E, cap, D), dtype=dt, device=x.device)
    xe.index_put_((e_safe, slot_c),
                  torch.where(keep[:, None], xt[t_sorted], 0).to(dt),
                  accumulate=True)
    ye = _expert_ffn(params, xe)
    contrib = ye[e_safe, slot_c] * (g_sorted * keep)[:, None].to(dt)
    # back to token-major [T, K, D] (order is a permutation: no collisions)
    per_token = torch.empty_like(contrib).index_copy_(0, order, contrib)
    per_token = per_token.view(T, K, D)
    out = per_token[:, 0]
    for k in range(1, K):
        out = out + per_token[:, k]
    return out.reshape(B, S, D), aux

"""Mixture-of-Experts with top-k routing and a capacity bound: the port of
``repro.models.moe``.

One device: sort-based dispatch into an ``[E, capacity, D]`` buffer, the
expert SwiGLU as three batched products (``torch.bmm``), and a combine back
to the tokens.  The JAX package computes all of this with ``jnp``, outside
any Pallas kernel, so the port keeps it as PyTorch operations.  Inside an
``activation_shardings`` context, ``_moe_shard_map`` runs expert
parallelism over the mesh, one process per rank (``dist.spmd``).

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

from repro_torch.dist import act_sharding, spmd
from repro_torch.dist.sharding import P
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


def _expert_ffn(xe: Tensor, w_gate: Tensor, w_up: Tensor,
                w_down: Tensor) -> Tensor:
    """The SwiGLU of every expert over its slots: xe ``[E, C, D]``."""
    dt = xe.dtype
    g = torch.bmm(xe, w_gate.to(dt))
    u = torch.bmm(xe, w_up.to(dt))
    return torch.bmm(F.silu(g) * u, w_down.to(dt))


def _dispatch_combine(xt: Tensor, gate_vals: Tensor, expert_ids: Tensor,
                      first: int, n_experts: int, cap: int, ffn) -> Tensor:
    """Tokens ``xt [T, D]`` through experts ``first .. first + n_experts``
    (choices of other experts are dropped): dispatch into ``[n, cap, D]``,
    ``ffn`` of that buffer, and the combine ``[T, D]``."""
    T, D = xt.shape
    K = expert_ids.shape[1]
    dt = xt.dtype
    # each token's choices in ascending expert order: the slots are the
    # same (one entry per token and expert, sorted by token), and the
    # combine below then adds in the reference's order
    expert_ids, perm = expert_ids.sort(dim=-1)
    gate_vals = gate_vals.gather(-1, perm)
    flat_e = expert_ids.reshape(T * K) - first
    flat_e = torch.where((flat_e >= 0) & (flat_e < n_experts), flat_e,
                         n_experts)
    order, e_sorted, slot, keep = _dispatch_slots(flat_e, n_experts, cap)
    t_sorted = torch.div(order, K, rounding_mode="floor")
    g_sorted = gate_vals.reshape(T * K)[order]
    slot_c = torch.where(keep, slot, 0)
    e_safe = e_sorted.clamp(0, n_experts - 1)

    xe = torch.zeros((n_experts, cap, D), dtype=dt, device=xt.device)
    xe.index_put_((e_safe, slot_c),
                  torch.where(keep[:, None], xt[t_sorted], 0).to(dt),
                  accumulate=True)
    ye = ffn(xe)
    contrib = ye[e_safe, slot_c] * (g_sorted * keep)[:, None].to(dt)
    # back to token-major [T, K, D] (order is a permutation: no collisions)
    per_token = torch.empty_like(contrib).index_copy_(0, order, contrib)
    per_token = per_token.view(T, K, D)
    out = per_token[:, 0]
    for k in range(1, K):
        out = out + per_token[:, k]
    return out


def _moe_local(params: dict, cfg, x: Tensor) -> tuple[Tensor, Tensor]:
    """One device: every expert over every token of this call."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, K = B * S, m.n_experts, m.top_k
    xt = x.reshape(T, D)
    gate_vals, expert_ids, me, ce = _route(xt, params["router"], E, K)
    aux = E * (me * ce).sum()
    out = _dispatch_combine(
        xt, gate_vals, expert_ids, 0, E,
        _capacity(T, E, K, m.capacity_factor),
        lambda xe: _expert_ffn(xe, params["w_gate"], params["w_up"],
                               params["w_down"]))
    return out.reshape(B, S, D), aux


def _moe_shard_map(params: dict, cfg, x: Tensor, state
                   ) -> tuple[Tensor, Tensor]:
    """Expert parallelism over the active mesh (the reference's
    ``_moe_shard_map``): tokens sharded over the batch axes and replicated
    over ``model``, experts sharded E over ``model`` and F over ``data``.
    Each rank routes its tokens, dispatches those bound for its experts,
    runs them by one of two schedules, and the expert columns are summed
    over ``model`` (or reduce-scattered onto the sequence under sequence
    parallelism).

    * **weight-gather** (many tokens, training): all-gather the F blocks of
      the rank's experts over ``data``; tokens stay on their rank.
    * **token-gather** (few tokens, serving): all-gather the dispatch
      buffers over ``data``, run them against the rank's F block, and
      reduce-scatter the partial outputs back to their owners.

    The schedule with the smaller payload runs, by the reference's byte
    counts.  The collectives over F run on ``data``, the axis the weights'
    F is split over, which is the reference's batch axes on a 2-D mesh.
    Without a tensor-parallel axis, or with E not divisible by it or B by
    the batch axes, the local path runs, as in the reference."""
    mesh, rules, seq_par = state
    _moe_shard_map.schedule = "local"
    if rules.tp is None:                   # fsdp strategy: no EP columns
        return _moe_whole(params, cfg, x, mesh)
    m = cfg.moe
    tp, batch_axes = rules.tp, rules.batch
    ntp = spmd.axis_size(mesh, tp)
    ndp = spmd.axis_size(mesh, batch_axes)
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    if E % ntp != 0 or B % ndp != 0:
        return _moe_whole(params, cfg, x, mesh)
    E_loc = E // ntp
    T_loc = (B // ndp) * S
    C_d = _capacity(T_loc, E, K, m.capacity_factor)
    bspec = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    # under sequence parallelism the residual stream is split on S over
    # tp: the combine reduce-scatters straight into that layout
    sp_out = bool(seq_par) and S % ntp == 0
    weight_gather = (3 * E_loc * D * (m.d_ff // ndp) * ndp
                     < E_loc * C_d * ndp * D)
    _moe_shard_map.schedule = ("weight_gather" if weight_gather
                               else "token_gather")

    def local_fn(x_loc, router, wg, wu, wd):
        xt = x_loc.reshape(-1, D)
        gate_vals, expert_ids, me, ce = _route(xt, router, E, K)
        me = spmd.pmean(me, mesh, batch_axes)
        ce = spmd.pmean(ce, mesh, batch_axes)
        aux = E * (me * ce).sum()
        first = spmd.axis_index(mesh, tp) * E_loc

        def ffn(xe):
            if weight_gather:
                return _expert_ffn(xe, spmd.all_gather(wg, mesh, "data", 2),
                                   spmd.all_gather(wu, mesh, "data", 2),
                                   spmd.all_gather(wd, mesh, "data", 1))
            y = _expert_ffn(spmd.all_gather(xe, mesh, "data", 1), wg, wu, wd)
            return spmd.psum_scatter(y, mesh, "data", 1)

        out = _dispatch_combine(xt, gate_vals, expert_ids, first, E_loc,
                                C_d, ffn).reshape(x_loc.shape)
        out = (spmd.psum_scatter(out, mesh, tp, 1) if sp_out
               else spmd.psum(out, mesh, tp))
        return layers.remat_ckpt(out), aux

    return spmd.shard_map(
        local_fn, mesh,
        in_specs=(P(bspec, None, None), P(None, None), P(tp, None, "data"),
                  P(tp, None, "data"), P(tp, "data", None)),
        out_specs=(P(bspec, tp if sp_out else None, None), P()),
    )(x, params["router"], params["w_gate"], params["w_up"], params["w_down"])


_moe_shard_map.schedule = None    # the last call's: its schedule or "local"


def _moe_whole(params: dict, cfg, x: Tensor, mesh) -> tuple[Tensor, Tensor]:
    """The local path where expert parallelism does not apply: on
    ``DTensor``s (the sharded train step) each rank runs every expert over
    every token, from replicated inputs, through ``spmd.shard_map``."""
    if not act_sharding.is_dtensor(x):
        return _moe_local(params, cfg, x)
    keys = ("router", "w_gate", "w_up", "w_down")

    def whole(x_, *weights):
        return _moe_local(dict(zip(keys, weights)), cfg, x_)

    return spmd.shard_map(
        whole, mesh, in_specs=(P(None, None, None), P(None, None),
                               *(P(None, None, None),) * 3),
        out_specs=(P(None, None, None), P()),
    )(x, *(params[k] for k in keys))


def moe_apply(params: dict, cfg, x: Tensor) -> tuple[Tensor, Tensor]:
    """x ``[B, S, D]`` -> (out ``[B, S, D]``, the balance loss, a 0-d f32
    tensor).  The capacity comes from this call's ``T = B * S`` tokens (per
    batch shard under expert parallelism).  Inside an
    ``activation_shardings`` context the expert-parallel path runs."""
    state = act_sharding.current_state()
    if state is not None:
        return _moe_shard_map(params, cfg, x, state)
    return _moe_local(params, cfg, x)

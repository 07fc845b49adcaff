"""Decoder-only LM covering the dense, MoE, SSM, hybrid and vlm families: the
port of ``repro.models.lm``.

The parameter tree is the reference's: nested dicts, with the layer stack
under ``periods`` stacked on a leading ``n_periods`` axis, so that
``convert.params_from_arrays`` is a map over leaves and caches compare leaf
by leaf.  The reference scans over periods; the port loops over them in
Python.  Weights stay f32 and are cast to the compute dtype at each use, as
in the reference.

Ported: ``init_lm``, ``forward_hidden``, ``lm_loss``, ``lm_logits``,
``init_caches``, ``prefill`` and ``decode_step``, for attention and SSM
mixers with dense or MoE MLPs (or none, as in mamba2), and the vlm's
frontend embeddings, prepended to the token embeddings.  The MoE balance
loss is summed over the layers into ``forward_hidden``'s second output;
prefill and decode drop it, as the reference does.

Remat as the reference's ``jax.checkpoint``: with ``cfg.remat`` and grad
enabled, each period of ``forward_hidden`` and each chunk of ``lm_loss``
runs under ``torch.utils.checkpoint`` (``remat_call``), which keeps only
its inputs and recomputes the rest in the backward; under
``remat_policy="save_named"`` a period also keeps the values tagged
``layers.remat_ckpt``, as in the reference.  Prefill and decode never
checkpoint.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
from torch import Tensor

from repro_torch.core import resolve_device
from repro_torch.dist.act_sharding import is_dtensor, shard_act
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
from repro_torch.models.config import ModelConfig

AUX_LOSS_WEIGHT = 0.01
LOSS_CHUNK = 512


def _unstack(periods: dict, n: int) -> list[dict]:
    """The ``n`` periods' parameters (or caches), as views, from one
    ``unbind`` of each stacked leaf.  Under autograd the backward of an
    unbind stacks the periods' gradients in one op, where a select per
    period scatters each into zeros of the whole stack, which autograd then
    adds up (n full-size fills and adds per leaf)."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in periods.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _stack(trees: list[dict]) -> dict:
    """The trees' leaves stacked on a new leading axis.  A single tree's
    leaves become views with that axis, not copies: one period of
    jamba at full width is 53 GB of f32 weights, and a copy would not fit
    the card beside it."""
    if len(trees) == 1:
        return {k: _stack([v]) if isinstance(v, dict) else v[None]
                for k, v in trees[0].items()}
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_period(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One period's parameters, drawn per sub-layer in the reference's
    order: mixer, then MLP."""
    p = {}
    dev = generator.device
    for i in range(cfg.period):
        sub: dict = {"norm1": layers.init_rms_norm(cfg.d_model, dev)}
        sub["mixer"] = (attn.init_attention(generator, cfg)
                        if cfg.mixer_kind(i) == "attn"
                        else ssm.init_ssm(generator, cfg))
        mk = cfg.mlp_kind(i)
        if mk != "none":
            sub["norm2"] = layers.init_rms_norm(cfg.d_model, dev)
            sub["mlp"] = (moe.init_moe(generator, cfg) if mk == "moe" else
                          layers.init_mlp(generator, cfg.d_model, cfg.d_ff))
        p[f"sub{i}"] = sub
    return p


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``generator.device``, drawn from it in order."""
    params = {
        "embed": layers.init_embed(generator, cfg.vocab, cfg.d_model),
        "final_norm": layers.init_rms_norm(cfg.d_model, generator.device),
        "periods": _stack([_init_period(generator, cfg)
                           for _ in range(cfg.n_periods)]),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.trunc_normal(generator, (cfg.d_model, cfg.vocab))
    return params


# ---------------------------------------------------------------------------
# forward (full-sequence trunk)
# ---------------------------------------------------------------------------

def _save_named_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of ``layers.remat_ckpt`` (the reference's
    ``save_only_these_names("remat_ckpt")``); recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.repro_torch.remat_ckpt.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(cfg: ModelConfig, fn, *args, save_named: bool = False):
    """``fn(*args)``, checkpointed when ``cfg.remat`` is on and grad is
    enabled: the forward keeps ``args`` alone and the backward runs ``fn``
    again (non-reentrant; the models draw no random numbers, so no RNG state
    is kept).  Each checkpointed call adds one to ``remat_call.calls``.

    With ``save_named`` (the LM trunk's periods) and ``cfg.remat_policy ==
    "save_named"``, the checkpoint also keeps the values ``fn`` tags with
    ``layers.remat_ckpt``, as the reference's ``jax.checkpoint`` with
    ``save_only_these_names("remat_ckpt")`` does: the mixer's output, the
    dense MLP's and the expert-parallel MoE's combine.  It is a selective
    checkpoint (``create_selective_checkpoint_contexts``) whose policy
    saves the tag op's outputs; each tag is a copy, and the replay takes
    the saved copy instead of running the op again.  Everything else is
    recomputed, so the gradients are bitwise those of ``"none"``."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy not in ("none", "save_named"):
        raise ValueError(f"{cfg.name}: remat_policy={cfg.remat_policy!r}: "
                         "'none' | 'save_named'")
    remat_call.calls += 1
    if save_named and cfg.remat_policy == "save_named":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return torch.utils.checkpoint.checkpoint(
            layers.tagging(fn), *args, use_reentrant=False,
            preserve_rng_state=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_named_policy))
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


remat_call.calls = 0


def _mlp_block(cfg: ModelConfig, i: int, sub: dict, x: Tensor):
    """x plus sub-layer i's MLP of its norm, and the MoE balance loss (None
    for a dense MLP or none)."""
    mk = cfg.mlp_kind(i)
    if mk == "none":
        return x, None
    h = layers.rms_norm(x, sub["norm2"], cfg.norm_eps)
    if mk == "moe":
        h, aux = moe.moe_apply(sub["mlp"], cfg, h)
        return x + h, aux
    return x + layers.remat_ckpt(layers.mlp(sub["mlp"], h)), None


def _apply_period(cfg: ModelConfig, pp: dict, x: Tensor, positions):
    """One period of the trunk: (x, the sum of its MoE balance losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = shard_act(x, ("batch", "seq", None))
    for i in range(cfg.period):
        sub = pp[f"sub{i}"]
        h = layers.rms_norm(x, sub["norm1"], cfg.norm_eps)
        if cfg.mixer_kind(i) == "attn":
            h = attn.attention(sub["mixer"], cfg, h, positions, causal=True,
                               window=cfg.layer_window(i))
        else:
            h = ssm.ssm_apply(sub["mixer"], cfg, h)
        # the mixer's output is a partial sum over "model" (its output
        # projection splits the contraction): reduced here, before the
        # MLP's norm, which would otherwise run on the partial sums
        x = shard_act(x + layers.remat_ckpt(h), ("batch", "seq", None))
        x, a = _mlp_block(cfg, i, sub, x)
        if a is not None:
            aux = aux + a
        x = shard_act(x, ("batch", "seq", None))
    return x, aux


def _embed_inputs(params, cfg: ModelConfig, tokens: Tensor,
                  frontend_embeds: Tensor | None) -> Tensor:
    """Token embeddings, after the frontend's embeddings ``[B, F, D]`` where
    the family has a frontend (vlm: the patch embeddings)."""
    x = layers.embed(params["embed"], tokens, cfg.compute_dtype)
    if cfg.family == "vlm" or cfg.n_frontend_tokens:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} needs frontend embeddings")
        x = torch.cat([frontend_embeds.to(cfg.compute_dtype), x], dim=1)
    return x


def forward_hidden(params: dict, cfg: ModelConfig, tokens: Tensor,
                   positions: Tensor | None = None,
                   frontend_embeds: Tensor | None = None
                   ) -> tuple[Tensor, Tensor]:
    """Returns (final hidden ``[B, S, D]``, aux loss); the aux loss is the
    sum of the MoE layers' balance terms (zero without MoE layers)."""
    x = shard_act(_embed_inputs(params, cfg, tokens, frontend_embeds),
                  ("batch", "seq", None))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pp in _unstack(params["periods"], cfg.n_periods):
        x, a = remat_call(cfg, _apply_period, cfg, pp, x, positions,
                          save_named=True)
        aux = aux + a
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _unembed_table(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def chunk_nll(hidden: Tensor, table: Tensor, labels: Tensor,
              softcap: float = 0.0) -> tuple[Tensor, Tensor]:
    """(sum of the cross-entropy over the labels ``>= 0``, their count) of
    one chunk of positions: the f32 logits ``[B, C, V]`` live only here,
    laid out over the batch and, on a mesh, the vocabulary over
    ``"model"``."""
    hidden = shard_act(hidden, ("batch", None, None))
    logits = shard_act(layers.unembed(hidden, table, softcap),
                       ("batch", None, "model"))
    if is_dtensor(logits):
        return _chunk_nll_sharded(logits, labels)
    return _nll_sum(logits, labels)


def _nll_sum(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """(sum of the cross-entropy over the labels ``>= 0``, their count)
    of whole rows of logits.  The sharded chunk runs these same operations
    in this order where its rows hold the whole vocabulary: the order in
    which the two uses of the logits are recorded decides the order in
    which autograd adds their gradients."""
    mask = labels >= 0
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = torch.where(mask, torch.logsumexp(logits, -1) - gold, 0.0)
    return nll.sum(), mask.sum()


def _chunk_nll_sharded(logits, labels):
    """``chunk_nll`` of a ``DTensor`` chunk under ``local_map``: each rank
    holds its batch rows and its slice of the vocabulary; the row maximum,
    the sum of exponentials and the gold logit are reduced over the ranks
    that split the vocabulary.  Returns the sum and the count, partial over
    the mesh dims that split the rows.

    DTensor's ``loss_parallel`` cannot stand in: torch 2.11 (the H100
    host's) takes only a one-dimensional mesh there, and the logits lie on
    the two- or three-dimensional production mesh (batch and vocabulary);
    torch 2.13 takes such a mesh and held tests/test_torch_train_sharded.py
    (gloo, (2, 2)), but chip_smoke.py's dry-run at 256 ranks raised."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist import spmd

    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    lp = tuple(logits.placements)
    for i, pl in enumerate(lp):
        if pl.is_partial() or (pl.is_shard() and pl.dim == 1):
            raise ValueError(f"the loss chunk's logits are {lp}: a partial "
                             "sum or split positions cannot run locally")
    vocab = [names[i] for i, pl in enumerate(lp)
             if pl.is_shard(2) and mesh.size(i) > 1]
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate() for pl in lp)
    out = tuple(Partial() if pl.is_shard(0) else Replicate() for pl in lp)
    group = spmd.axis_group(mesh, tuple(vocab)) if vocab else None
    split = spmd.axis_size(mesh, tuple(vocab)) if vocab else 1
    first = (spmd.axis_index(mesh, tuple(vocab)) * (logits.shape[-1] // split)
             if vocab else 0)

    def block(lg, lab):
        if group is None:
            return _nll_sum(lg, lab)
        mask = lab >= 0
        m = funcol.wait_tensor(funcol.all_reduce(
            lg.detach().amax(-1), "max", group))
        logz = spmd.sum_over(
            (lg - m[..., None]).exp().sum(-1), group).log() + m
        at = lab.long() - first
        mine = (at >= 0) & (at < lg.shape[-1])
        g = lg.gather(-1, at.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        gold = spmd.sum_over(torch.where(mine, g, 0.0), group)
        nll = torch.where(mask, logz - gold, 0.0)
        return nll.sum(), mask.sum()

    return local_map(block, out_placements=(out, out),
                     in_placements=(lp, rows), in_grad_placements=(lp, rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits,
                                                                 labels)


def chunked_loss(cfg: ModelConfig, hidden: Tensor, table: Tensor,
                 labels: Tensor, softcap: float = 0.0) -> Tensor:
    """Mean cross-entropy over the labels ``>= 0``, ``LOSS_CHUNK``
    positions at a time, each chunk through ``remat_call``."""
    tot = cnt = None
    for s0 in range(0, hidden.shape[1], LOSS_CHUNK):
        t, c = remat_call(cfg, chunk_nll, hidden[:, s0:s0 + LOSS_CHUNK],
                          table, labels[:, s0:s0 + LOSS_CHUNK], softcap)
        tot, cnt = (t, c) if tot is None else (tot + t, cnt + c)
    if tot is None:
        return torch.zeros((), dtype=torch.float32, device=hidden.device)
    return tot / cnt.clamp_min(1)


def lm_loss(params: dict, cfg: ModelConfig, tokens: Tensor, labels: Tensor,
            positions: Tensor | None = None,
            frontend_embeds: Tensor | None = None) -> Tensor:
    """Mean next-token cross-entropy over the labels ``>= 0`` (-100 =
    masked), plus ``AUX_LOSS_WEIGHT`` times the aux loss.  The logits are
    made ``LOSS_CHUNK`` positions at a time, as in the reference, so the
    whole ``[B, S, V]`` tensor never exists at once in the forward; the
    reference pads the last chunk with masked labels, which adds nothing."""
    hidden, aux = forward_hidden(params, cfg, tokens, positions,
                                 frontend_embeds)
    return (chunked_loss(cfg, hidden, _unembed_table(params, cfg), labels,
                         cfg.final_softcap)
            + AUX_LOSS_WEIGHT * aux)


def lm_logits(params, cfg, tokens, positions=None, frontend_embeds=None):
    """Full logits ``[B, S, V]`` (small models and tests only)."""
    hidden, _ = forward_hidden(params, cfg, tokens, positions,
                               frontend_embeds)
    return layers.unembed(hidden, _unembed_table(params, cfg), cfg.final_softcap)


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-period caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> dict:
    """Stacked per-period caches on ``device`` (``None``: the GPU), zeros:
    for an attention sub-layer k/v ``[n_periods, batch, Hk, max_len, Dh]``
    in the compute dtype; for an SSM sub-layer the conv window
    ``[n_periods, batch, W-1, conv_dim]`` in the compute dtype and the state
    ``[n_periods, batch, H, P, N]`` in f32."""
    device = resolve_device(device)
    dt = cfg.compute_dtype
    caches = {}
    for i in range(cfg.period):
        if cfg.mixer_kind(i) == "attn":
            shape = (cfg.n_periods, batch, cfg.n_kv_heads, max_len, cfg.d_head)
            caches[f"sub{i}"] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
        else:
            c = ssm.init_ssm_cache(cfg, batch, cfg.n_periods, dt, device)
            caches[f"sub{i}"] = {"conv": c["conv"], "state": c["ssm"]}
    return caches


def decode_step(params: dict, cfg: ModelConfig, caches: dict, token: Tensor,
                pos: Tensor) -> tuple[Tensor, dict]:
    """One decode step: logits ``[B, V]``, and the caches with this token
    written in (in place: the returned dict is ``caches``): k/v at ``pos``,
    the SSM conv window and state advanced by one step."""
    x = layers.embed(params["embed"], token, cfg.compute_dtype)  # [B,1,D]
    for pp, cache_p in zip(_unstack(params["periods"], cfg.n_periods),
                           _unstack(caches, cfg.n_periods)):
        for i in range(cfg.period):
            sub, cache = pp[f"sub{i}"], cache_p[f"sub{i}"]
            h = layers.rms_norm(x, sub["norm1"], cfg.norm_eps)
            if cfg.mixer_kind(i) == "attn":
                h, _ = attn.attention_decode(
                    sub["mixer"], cfg, h, cache["k"], cache["v"], pos,
                    window=cfg.layer_window(i))
            else:
                h, conv_s, ssm_s = ssm.ssm_decode(
                    sub["mixer"], cfg, h, cache["conv"], cache["state"])
                cache["conv"].copy_(conv_s)
                cache["state"].copy_(ssm_s)
            # as in _apply_period: the residual laid out over the batch
            x = shard_act(x + h, ("batch", "seq", None))
            x, _ = _mlp_block(cfg, i, sub, x)
            x = shard_act(x, ("batch", "seq", None))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x[:, 0], _unembed_table(params, cfg),
                            cfg.final_softcap)
    return logits, caches


def prefill(params: dict, cfg: ModelConfig, tokens: Tensor, max_len: int,
            positions: Tensor | None = None,
            frontend_embeds: Tensor | None = None) -> tuple[Tensor, dict]:
    """Process a prompt ``[B, S]`` (after the frontend embeddings, where the
    family has them): last-position logits ``[B, V]`` and the caches: k/v
    filled to ``S`` and zero-padded to ``max_len``, the SSM conv tail and
    final state."""
    x = _embed_inputs(params, cfg, tokens, frontend_embeds)
    B, S, _ = x.shape
    per_period = []
    for pp in _unstack(params["periods"], cfg.n_periods):
        cache_out = {}
        for i in range(cfg.period):
            sub = pp[f"sub{i}"]
            h = layers.rms_norm(x, sub["norm1"], cfg.norm_eps)
            if cfg.mixer_kind(i) == "attn":
                h, (kT, vT) = attn.attention_prefill(
                    sub["mixer"], cfg, h, positions,
                    window=cfg.layer_window(i))
                pad = (0, 0, 0, max_len - S)
                cache_out[f"sub{i}"] = {"k": torch.nn.functional.pad(kT, pad),
                                        "v": torch.nn.functional.pad(vT, pad)}
            else:
                h, conv_s, ssm_s = ssm.ssm_prefill(sub["mixer"], cfg, h)
                cache_out[f"sub{i}"] = {"conv": conv_s, "state": ssm_s}
            # as in _apply_period: the residual laid out over the batch
            x = shard_act(x + h, ("batch", "seq", None))
            x, _ = _mlp_block(cfg, i, sub, x)
            x = shard_act(x, ("batch", "seq", None))
        per_period.append(cache_out)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x[:, -1], _unembed_table(params, cfg),
                            cfg.final_softcap)
    return logits, _stack(per_period)

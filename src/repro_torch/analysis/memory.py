"""Analytic per-rank memory and HBM-traffic model: the port of
``repro.analysis.memory``, formula for formula.

The residency claim and the memory roofline term come from the exact
sharding layout (``param_pspec_tree`` / ``input_pspec_tree`` give each
leaf's shard fraction) plus a standard activation model:

Residency (train):
    f32 master params + AdamW mu/nu + f32 grad accumulator (4 x params_f32)
    + bf16 weight shard (cast live during compute)
    + remat residuals: one (B_loc, S, D) per layer-period
    + working set ~ 4 activations + logits chunk

Traffic per step (memory roofline term):
    weights   read (2 fwd incl. remat replay + 1 bwd) x microbatches x bf16
    optimizer read+write p/mu/nu f32 (6 x 4 x params)
    residuals write + read
    decode    weights bf16 + full KV/state read (+1/S write)

The shapes come from ``Model.param_specs`` and ``Model.input_specs`` (both
traced under ``FakeTensorMode``): nothing is allocated, at any size.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch import tree
from repro_torch.dist.sharding import (
    axis_sizes, input_pspec_tree, param_pspec_tree, rules_for_mesh)


def _shard_frac(spec, sizes: dict) -> float:
    f = 1.0
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            f /= sizes[a]
    return f


def sharded_bytes(shape_tree, spec_tree, mesh, dtype_bytes=None) -> float:
    """Bytes one rank holds of the leaves of ``shape_tree`` laid out by
    ``spec_tree``, at ``dtype_bytes`` a value (default: each leaf's own
    dtype)."""
    sizes = axis_sizes(mesh)
    total = 0.0
    for path, leaf in tree.leaves_with_path(shape_tree):
        spec = spec_tree
        for k in path:
            spec = spec[k]
        n = float(math.prod(leaf.shape)) if leaf.shape else 1.0
        b = dtype_bytes if dtype_bytes is not None else leaf.dtype.itemsize
        total += n * b * _shard_frac(spec, sizes)
    return total


@dataclasses.dataclass
class MemoryEstimate:
    residency_bytes: float
    traffic_bytes: float
    detail: dict

    def as_dict(self):
        return {
            "residency_bytes": self.residency_bytes,
            "traffic_bytes": self.traffic_bytes,
            **{f"detail_{k}": v for k, v in self.detail.items()},
        }


def _cache_shapes(model, shape):
    """The caches of ``shape``'s batch and length, as a decode step's
    ``input_specs`` gives them (``init_caches`` under ``FakeTensorMode``)."""
    return model.input_specs(dataclasses.replace(shape, kind="decode"))[
        "caches"]


def estimate(model, cfg, shape, mesh, microbatches: int = 1,
             sequence_parallel: bool = False,
             master_bf16: bool = False,
             moments_bf16: bool = False,
             strategy: str = "2d") -> MemoryEstimate:
    pshapes = model.param_specs()
    pspecs = param_pspec_tree(pshapes, mesh, strategy)
    p_f32 = sharded_bytes(pshapes, pspecs, mesh, 4)
    p_bf16 = sharded_bytes(pshapes, pspecs, mesh, 2)
    p_master = p_bf16 if master_bf16 else p_f32

    sizes = axis_sizes(mesh)
    rules = rules_for_mesh(mesh, strategy)
    batch_axes = [a for a in rules.batch if a in sizes]
    dp = int(math.prod(sizes[a] for a in batch_axes))
    tp = sizes.get("model", 1) if rules.tp else 1

    D = cfg.d_model
    act_dt = 2 if cfg.dtype == "bfloat16" else 4
    S = shape.seq_len

    if shape.kind == "train":
        b_loc = max(shape.global_batch // dp, 1) // max(microbatches, 1)
        b_loc = max(b_loc, 1)
        act = b_loc * S * D * act_dt
        layers = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)
        sp_div = tp if sequence_parallel else 1
        residuals = layers * act // sp_div
        # working set during one period's recompute: x, qkv/ssm proj, mlp
        # hidden (F/tp), flash accumulators (f32)
        width = max(
            cfg.d_ff // max(tp, 1) if cfg.d_ff else 0,
            (cfg.moe.d_ff if cfg.moe else 0),
            cfg.n_heads * cfg.d_head // max(tp, 1) * 2,
            D,
        )
        working = 4 * b_loc * S * width * act_dt + 2 * b_loc * S * D * 4
        logits_chunk = b_loc * 512 * max(cfg.vocab // tp, 1) * 4
        grads = (4 * p_f32 / 4) if microbatches > 1 else p_master  # f32 acc
        compute_copy = 0 if master_bf16 else p_bf16
        p_moments = 2 * (p_bf16 if moments_bf16 else p_f32)
        residency = (
            p_master + p_moments + grads + compute_copy
            + residuals + working + logits_chunk
        )
        traffic = (
            (2 * microbatches + 1) * p_bf16   # fwd + bwd + remat replay reads
            + 4 * p_f32 + 2 * p_master        # adam r/w moments + master
            + 3 * residuals * microbatches    # write + 2 reads per mb sweep
            + 4 * microbatches * act * 8      # working-set streaming (approx)
        )
        detail = dict(params_f32=p_f32, params_bf16=p_bf16,
                      params_master=p_master,
                      residuals=residuals, working=working,
                      logits_chunk=logits_chunk, local_microbatch=b_loc)
    elif shape.kind == "prefill":
        b_loc = max(shape.global_batch // dp, 1)
        act = b_loc * S * D * act_dt
        layers = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)
        cache_shapes = _cache_shapes(model, shape)
        cache_specs = input_pspec_tree({"caches": cache_shapes}, mesh,
                                       strategy)
        kv = sharded_bytes(cache_shapes, cache_specs["caches"], mesh)
        residency = p_bf16 + kv + 6 * act
        traffic = p_bf16 + kv + 4 * layers * act
        detail = dict(params_bf16=p_bf16, kv_cache=kv, act=act)
    else:  # decode
        cache_shapes = _cache_shapes(model, shape)
        cache_specs = input_pspec_tree({"caches": cache_shapes}, mesh,
                                       strategy)
        kv = sharded_bytes(cache_shapes, cache_specs["caches"], mesh)
        residency = p_bf16 + kv
        traffic = p_bf16 + kv  # read everything once per token
        detail = dict(params_bf16=p_bf16, kv_cache=kv)

    return MemoryEstimate(residency, traffic, detail)

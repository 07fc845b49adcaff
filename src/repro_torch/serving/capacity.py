"""KV-cache capacity planning: ModelConfig + HBM budget -> ``kv_blocks``.

The simulator treats KV-cache blocks as an abstract per-host capacity
dimension (``Hosts.kv_blocks``, DESIGN.md §14).  This module grounds that
number in a real checkpoint: a transformer's KV cache costs
``2 * n_attn_layers * n_kv_heads * d_head * bytes_per_elem`` bytes per
token (K and V), attention-free pattern positions (SSM mixers) cost
nothing, and a paged allocator hands the budget out in blocks of
``block_tokens`` tokens.  ``serving_scenario(kv_blocks=...)`` fed from
``kv_blocks_per_device`` turns "will a fleet of H100 replicas hold this
model's tail latency at rate r" into one campaign sweep.

The port's copy of ``repro.serving.capacity``: plain arithmetic on
``ModelConfig``.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def n_attn_layers(cfg: ModelConfig) -> int:
    """Layers that actually keep a KV cache (attention mixers; SSM pattern
    positions hold constant-size state instead and are excluded)."""
    period = cfg.period
    per_period = sum(
        1 for p in range(period) if cfg.mixer_kind(p) == "attn"
    )
    return cfg.n_periods * per_period


def kv_bytes_per_token(cfg: ModelConfig, *, cache_dtype: str | None = None) -> int:
    """Bytes of KV cache one token occupies across the whole stack."""
    elem = _DTYPE_BYTES[cache_dtype or cfg.dtype]
    return 2 * n_attn_layers(cfg) * cfg.n_kv_heads * cfg.d_head * elem


def kv_blocks_per_device(
    cfg: ModelConfig,
    hbm_bytes: float,
    *,
    block_tokens: int = 16,
    weight_bytes: float | None = None,
    reserve_frac: float = 0.1,
    cache_dtype: str | None = None,
) -> int:
    """Whole KV blocks a device can serve after weights and a working
    reserve.  ``weight_bytes`` defaults to the checkpoint's parameter count
    at the compute dtype; ``reserve_frac`` of HBM is held back for
    activations/fragmentation (vLLM's gpu_memory_utilization, inverted)."""
    if weight_bytes is None:
        weight_bytes = cfg.param_count() * _DTYPE_BYTES[cfg.dtype]
    budget = hbm_bytes * (1.0 - reserve_frac) - weight_bytes
    if budget <= 0:
        return 0
    per_block = kv_bytes_per_token(cfg, cache_dtype=cache_dtype) * block_tokens
    return int(budget // per_block)

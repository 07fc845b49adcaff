"""Model configuration schema covering the whole assigned architecture pool
(the port's copy of ``repro.models.config``).

One ``ModelConfig`` describes any of: dense GQA transformers (phi3, qwen3,
gemma2, internlm2, qwen2-vl), MoE transformers (qwen3-moe, granite-moe),
pure SSM (mamba2), hybrid SSM+attention+MoE (jamba), and encoder-decoder
(whisper).  Heterogeneous layer patterns (jamba's 1-attention-per-8, gemma2's
local/global alternation, jamba's MoE-every-other) are expressed as a
repeating *period*: the layer stack is ``n_layers / period`` repetitions of a
``period``-long pattern, which is what the scan-over-layers compiler path
iterates (one period = one scan step, keeping HLO size O(period) instead of
O(n_layers)).

The port drops ``attn_impl``: attention routes by the device its tensors lie
on (``kernels/ops.py``).  ``remat`` does what it does in the reference: while
a gradient is taken, each period of the LM trunk, each encoder and decoder
layer and each chunk of the loss is checkpointed (``lm.remat_call``, the
reference's ``jax.checkpoint``).  ``remat_policy="save_named"`` keeps, in
each checkpointed period, the values the reference tags ``remat_ckpt``
(a selective checkpoint, ``lm.remat_call``); no configuration uses it.
``scan_layers`` stays so that configurations read the same in both
packages, but has no effect: the port loops over periods in Python.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden width
    every: int = 1            # MoE replaces dense MLP on layers p % every == every-1
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128        # N
    head_dim: int = 64        # P
    n_groups: int = 1         # G (B/C projections shared per group)
    conv_width: int = 4
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 128          # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_ctx: int = 1500         # whisper: 30 s of audio -> 1500 frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                 # dense-MLP hidden width (MoE archs: unused or
    vocab: int                # the dense layers of a hybrid)
    d_head: int | None = None # default d_model // n_heads
    # --- attention variants ---
    rope_theta: float = 10_000.0
    qk_norm: bool = False                 # qwen3
    attn_softcap: float = 0.0             # gemma2 attention-logit softcap
    final_softcap: float = 0.0            # gemma2 final-logit softcap
    sliding_window: int | None = None     # window for "local" layers
    global_every: int = 0                 # 0: all layers global; k: layer
                                          # p%k==k-1 global, others local
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE (t,h,w)
    attn_every: int = 1                   # 1: attention every layer;
                                          # k: only p%k==k-1 (jamba); 0: none
    # --- substructures ---
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    frontend: Literal[None, "audio", "vision"] = None
    n_frontend_tokens: int = 0            # stub embeddings prepended (vlm)
    pos_embed: Literal["rope", "learned"] = "rope"  # whisper: learned absolute
    max_position: int = 0                 # learned-pos table size (0 = unused)
    # --- numerics / compile strategy ---
    tie_embeddings: bool = False
    dtype: str = "float32"                # activation/weight compute dtype
    remat: bool = True                    # checkpoint each scan period
    remat_policy: str = "none"            # "none" | "save_named": keep values
                                          # tagged remat_ckpt (e.g. the MoE
                                          # combine) out of the bwd replay
    scan_layers: bool = True
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_layers % self.period != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period={self.period}"
            )

    @property
    def period(self) -> int:
        p = 1
        for k in (self.attn_every, self.global_every,
                  self.moe.every if self.moe else 1):
            p = math.lcm(p, max(k, 1))
        return p

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    def mixer_kind(self, p: int) -> str:
        """'attn' | 'ssm' for pattern position p (within a period)."""
        if self.attn_every == 0:
            return "ssm"
        if self.ssm is not None and self.attn_every > 1:
            return "attn" if p % self.attn_every == self.attn_every - 1 else "ssm"
        return "attn"

    def mlp_kind(self, p: int) -> str:
        """'moe' | 'dense' | 'none' for pattern position p."""
        if self.ssm is not None and self.moe is None and self.attn_every == 0:
            return "none"                 # pure mamba2: the block IS the mixer
        if self.moe and p % self.moe.every == self.moe.every - 1:
            return "moe"
        return "dense"

    def layer_window(self, p: int) -> int | None:
        """Sliding window for pattern position p (None = global)."""
        if self.global_every == 0:
            return self.sliding_window
        is_global = p % self.global_every == self.global_every - 1
        return None if is_global else self.sliding_window

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k applies."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6ND roofline."""
        D, V = self.d_model, self.vocab
        kv_dim = self.n_kv_heads * self.d_head
        q_dim = self.n_heads * self.d_head
        per_period = 0
        for p in range(self.period):
            if self.mixer_kind(p) == "attn":
                per_period += D * (q_dim + 2 * kv_dim) + q_dim * D
            else:
                s = self.ssm
                di = s.d_inner(D)
                H = s.n_ssm_heads(D)
                bc = 2 * s.n_groups * s.d_state
                per_period += D * (2 * di + bc + H) + di * s.conv_width + di * D
            mk = self.mlp_kind(p)
            if mk == "dense":
                per_period += 3 * D * self.d_ff
            elif mk == "moe":
                per_period += self.moe.n_experts * 3 * D * self.moe.d_ff
                per_period += D * self.moe.n_experts  # router
            per_period += 2 * D  # two RMSNorm scales
        total = per_period * self.n_periods + D  # + final norm
        total += V * D + (0 if self.tie_embeddings else V * D)
        if self.encoder:
            # self-attn (no cross kv cost here: decoder owns cross-attn q/o,
            # encoder supplies k/v) + MLP + norms, per encoder layer
            enc = (D * (q_dim + 2 * kv_dim) + q_dim * D
                   + 3 * D * self.d_ff + 4 * D) * self.encoder.n_layers
            # decoder cross-attention adds q/k/v/o per decoder layer
            enc += (D * (q_dim + 2 * kv_dim) + q_dim * D + D) * self.n_layers
            total += enc
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.n_layers // self.moe.every
        expert_p = 3 * self.d_model * self.moe.d_ff
        inactive = moe_layers * (self.moe.n_experts - self.moe.top_k) * expert_p
        return int(full - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(applies?, reason-if-not) — the DESIGN.md §Arch-applicability rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention: 500k decode needs sub-quadratic mixing"
    return True, ""

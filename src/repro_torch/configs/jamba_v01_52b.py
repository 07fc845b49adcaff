"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba:attention 7:1 interleave (attention on layer 8k+7), MoE
16 experts top-2 on every other layer [arXiv:2403.19887].

Note (DESIGN.md §Arch-applicability): Jamba v0.1 uses Mamba-1 selective-scan
layers (d_state=16); we model them with the Mamba-2 SSD block (same state
size) since SSD is this framework's SSM substrate — the state/compute scaling
that matters for the roofline is identical.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab=65536, attn_every=8,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2),
        ssm=SSMConfig(d_state=16, head_dim=64, n_groups=1, conv_width=4,
                      expand=2),
        dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, attn_every=8,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, every=2,
                      capacity_factor=8.0),
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, conv_width=4,
                      expand=2, chunk=32),
        dtype=dtype, remat=False,
    )

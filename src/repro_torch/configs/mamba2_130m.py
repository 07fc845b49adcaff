"""mamba2-130m [ssm] — 24L d_model=768, attention-free, vocab=50280,
ssm_state=128, d_inner=1536 (24 SSD heads of dim 64) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,  # unused (no attn)
        d_ff=0, vocab=50280, attn_every=0,
        ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, conv_width=4,
                      expand=2),
        tie_embeddings=True, dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=256, attn_every=0,
        ssm=SSMConfig(d_state=32, head_dim=16, n_groups=1, conv_width=4,
                      expand=2, chunk=32),
        tie_embeddings=True, dtype=dtype, remat=False,
    )

"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064, RoPE + SwiGLU [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064, rope_theta=10_000.0, dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, dtype=dtype, remat=False,
    )

"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512 vocab=49155; 32 experts top-8, tied embeddings
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
        d_ff=512, vocab=49155,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff=512, every=1),
        tie_embeddings=True, dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=64, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, every=1,
                      capacity_factor=8.0),
        tie_embeddings=True, dtype=dtype, remat=False,
    )

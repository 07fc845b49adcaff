"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4, d_head=128)
expert d_ff=1536 vocab=151936; 128 experts top-8, qk-norm
[hf:Qwen/Qwen3-235B-A22B]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
        d_ff=1536, vocab=151936, rope_theta=1_000_000.0, qk_norm=True,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536, every=1),
        dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, qk_norm=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, every=1,
                      capacity_factor=8.0),
        dtype=dtype, remat=False,
    )

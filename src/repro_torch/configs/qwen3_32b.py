"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8, d_head=128)
d_ff=25600 vocab=151936, qk-norm [hf:Qwen/Qwen3-32B]."""
from repro_torch.models.config import ModelConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=25600, vocab=151936, rope_theta=1_000_000.0, qk_norm=True,
        dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, qk_norm=True, dtype=dtype, remat=False,
    )

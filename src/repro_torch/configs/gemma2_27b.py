"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16, d_head=128)
d_ff=36864 vocab=256000; local(4096-window)/global alternation + attention
and final logit softcaps, tied embeddings [arXiv:2408.00118]."""
from repro_torch.models.config import ModelConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
        d_ff=36864, vocab=256_000, rope_theta=10_000.0,
        sliding_window=4096, global_every=2,
        attn_softcap=50.0, final_softcap=30.0,
        tie_embeddings=True, dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, sliding_window=16, global_every=2,
        attn_softcap=50.0, final_softcap=30.0,
        tie_embeddings=True, dtype=dtype, remat=False,
    )

"""whisper-large-v3 [audio enc-dec] — 32+32L d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866; conv frontend STUBBED: input_specs() provides
precomputed frame embeddings [B, 1500, 1280] [arXiv:2212.04356].

Backbone notes: learned absolute positions (pos_embed="learned"); the
decoder position table is sized to the assigned decode shapes (32k), far
beyond whisper's native 448 — the assignment exercises the backbone, not
the ASR task. long_500k is skipped (quadratic attention).
"""
from repro_torch.models.config import EncoderConfig, ModelConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866,
        encoder=EncoderConfig(n_layers=32, n_ctx=1500),
        pos_embed="learned", max_position=32_768,
        tie_embeddings=True, dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        encoder=EncoderConfig(n_layers=2, n_ctx=32),
        pos_embed="learned", max_position=128,
        tie_embeddings=True, dtype=dtype, remat=False,
    )

"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8, d_head=128)
d_ff=29568 vocab=152064; M-RoPE (t/h/w sections 16/24/24), dynamic-resolution
vision frontend STUBBED: input_specs() provides 1024 patch embeddings
prepended to the text tokens [arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=29568, vocab=152064, rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        frontend="vision", n_frontend_tokens=1024,
        dtype=dtype,
    )


def smoke_config(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, mrope_sections=(2, 3, 3),
        frontend="vision", n_frontend_tokens=8,
        dtype=dtype, remat=False,
    )

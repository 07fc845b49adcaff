"""Config registry: every assigned architecture + the paper's own scenarios.

``get_config(arch_id)`` returns the exact published configuration;
``get_config(arch_id, smoke=True)`` returns the reduced same-family variant
used by the CPU smoke tests.  ``--arch <id>`` on every launcher resolves
through this registry.  The paper's own experiment scenarios (CloudSim
Figures 4/7-10, Table 1) live in repro_torch.core.scenarios and are re-exported
here for symmetry.

The port's copy of the JAX package's registry: the same plain data.  Every
architecture resolves here; ``models.build_model`` says which families the
port runs.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.core import scenarios as cloudsim_scenarios

ARCH_IDS = (
    "phi3-mini-3.8b",
    "qwen3-32b",
    "gemma2-27b",
    "internlm2-1.8b",
    "jamba-v0.1-52b",
    "whisper-large-v3",
    "mamba2-130m",
    "qwen3-moe-235b-a22b",
    "granite-moe-1b-a400m",
    "qwen2-vl-72b",
)

_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen3-32b": "qwen3_32b",
    "gemma2-27b": "gemma2_27b",
    "internlm2-1.8b": "internlm2_1_8b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "whisper-large-v3": "whisper_large_v3",
    "mamba2-130m": "mamba2_130m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def get_config(arch: str, *, smoke: bool = False, dtype: str | None = None) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    fn = mod.smoke_config if smoke else mod.config
    if dtype is not None:
        return fn(dtype=dtype)
    return fn()


__all__ = ["ARCH_IDS", "get_config", "cloudsim_scenarios"]

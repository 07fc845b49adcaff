"""PyTorch operators the port's model zoo dispatches per prefill and per
decode step, on the CPU.

    PYTHONPATH=src python scripts/count_model_ops.py

For each model that ``chip_smoke.py`` phase 6b drives (granite-moe at full
depth, jamba cut to one period, whisper at full depth, qwen2-vl cut to two
layers), builds its configuration with the same layer pattern, experts and
top-k but narrow widths (the count of operators does not depend on widths),
and counts the aten operators (``TorchDispatchMode``) of one
``Model.prefill`` of a 64-token prompt and of one ``Model.decode_step``
over 4 slots.  These are counts, not times: on a card most operators are
one kernel launch, and the host's enqueue of them is what a decode step
costs when the card waits on the host.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import EncoderConfig  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def narrow(arch: str, n_layers: int | None = None):
    """``arch``'s configuration (depth cut to ``n_layers`` if given) at
    widths small enough for the CPU: the same pattern, experts and top-k."""
    cfg = get_config(arch, dtype="float32")
    kw = dict(d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4),
              d_head=16, d_ff=64, vocab=256)
    if n_layers is not None:
        kw["n_layers"] = n_layers
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, d_ff=32)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, head_dim=16)
    if cfg.encoder:
        kw["encoder"] = EncoderConfig(n_layers=cfg.encoder.n_layers, n_ctx=64)
        kw["max_position"] = 256
    if cfg.mrope_sections:
        kw["mrope_sections"] = (2, 3, 3)
    return dataclasses.replace(cfg, **kw)


def count(cfg, prompt: int = 64, slots: int = 4) -> tuple[int, int]:
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, prompt), dtype=torch.long)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, cfg.encoder.n_ctx, cfg.d_model))
    if cfg.family == "vlm":
        batch["frontend_embeds"] = torch.zeros((1, 16, cfg.d_model))
    with torch.no_grad():
        with Count() as c_prefill:
            model.prefill(params, batch, prompt + 32)
        if cfg.family == "encdec":
            batch["frames"] = batch["frames"].expand(slots, -1, -1)
        batch["tokens"] = batch["tokens"].expand(slots, -1)
        if "frontend_embeds" in batch:
            batch["frontend_embeds"] = batch["frontend_embeds"].expand(
                slots, -1, -1)
        _, caches = model.prefill(params, batch, prompt + 32)
        token = torch.zeros((slots, 1), dtype=torch.long)
        pos = torch.full((slots,), prompt)
        with Count() as c_decode:
            model.decode_step(params, caches, token, pos)
    return c_prefill.n, c_decode.n


def main() -> None:
    for arch, layers in (("granite-moe-1b-a400m", None),
                         ("jamba-v0.1-52b", 8), ("whisper-large-v3", None),
                         ("qwen2-vl-72b", 2), ("internlm2-1.8b", None)):
        cfg = narrow(arch, layers)
        prefill, decode = count(cfg)
        print(f"{arch} ({cfg.n_layers} layers): aten operators per prefill "
              f"of 64 tokens {prefill}, per decode step of 4 slots {decode}")


if __name__ == "__main__":
    main()

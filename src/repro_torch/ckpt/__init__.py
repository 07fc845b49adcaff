"""repro_torch.ckpt — atomic checkpointing with async save (the reference's
layout)."""
from repro_torch.ckpt.checkpoint import AsyncSaver, latest_step, restore, save

__all__ = ["AsyncSaver", "latest_step", "restore", "save"]

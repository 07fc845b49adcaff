"""repro_torch.train — optimizer + microbatched train step (the port of
``repro.train``)."""
from repro_torch.train.optimizer import (
    OptConfig, adamw_init, adamw_update, cosine_schedule, global_norm)
from repro_torch.train.step import init_train_state, make_train_step

__all__ = [
    "OptConfig", "adamw_init", "adamw_update", "cosine_schedule",
    "global_norm", "init_train_state", "make_train_step",
]

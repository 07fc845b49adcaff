"""repro_torch.serving — continuous batching driven by the CloudSim policy
engine (the port of ``repro.serving``)."""
from repro_torch.serving.capacity import (
    kv_blocks_per_device,
    kv_bytes_per_token,
    n_attn_layers,
)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import (
    Request, SlotScheduler, choose_policy, queue_scenario)

__all__ = [
    "ServingEngine",
    "Request",
    "SlotScheduler",
    "choose_policy",
    "queue_scenario",
    "kv_blocks_per_device",
    "kv_bytes_per_token",
    "n_attn_layers",
]

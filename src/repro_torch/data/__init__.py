"""repro_torch.data — deterministic synthetic pipeline (the port's copy)."""
from repro_torch.data.pipeline import MarkovSource, ShardedLoader

__all__ = ["MarkovSource", "ShardedLoader"]

from repro_torch.checkpoint.async_writer import AsyncCheckpointer
from repro_torch.checkpoint.manager import CheckpointManager, CorruptCheckpointError

__all__ = ["AsyncCheckpointer", "CheckpointManager", "CorruptCheckpointError"]

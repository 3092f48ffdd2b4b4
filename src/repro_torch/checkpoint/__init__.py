from repro_torch.checkpoint.manager import CheckpointManager, CorruptCheckpointError

__all__ = ["CheckpointManager", "CorruptCheckpointError"]

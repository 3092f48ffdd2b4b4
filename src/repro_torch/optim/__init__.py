from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.optim.zero import zero1_rules, zero1_state_axes

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "constant",
    "global_norm",
    "warmup_cosine",
    "zero1_rules",
    "zero1_state_axes",
]

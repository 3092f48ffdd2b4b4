"""Published architecture configs (import side-effect: registration).

Ported so far: the dense family (mesh-paper, Qwen2-7B, Granite-3 8B,
Phi-3-medium 14B, Mistral-Large 123B) and the moe family (OLMoE-1B-7B,
Qwen1.5-MoE-A2.7B); the other families arrive with their model code."""

from repro_torch.configs.base import CONFIGS, ArchConfig, get_config
from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    mesh_paper,
    mistral_large_123b,
    olmoe_1b_7b,
    phi3_medium_14b,
    qwen2_7b,
    qwen2_moe_a27b,
)

__all__ = ["ArchConfig", "CONFIGS", "get_config"]

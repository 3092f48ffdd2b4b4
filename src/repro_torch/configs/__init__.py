"""Published architecture configs (import side-effect: registration).

Ported so far: mesh-paper and Qwen2-7B (dense) and OLMoE-1B-7B (moe); the
other families arrive with their model code."""

from repro_torch.configs.base import CONFIGS, ArchConfig, get_config
from repro_torch.configs import mesh_paper, olmoe_1b_7b, qwen2_7b  # noqa: F401

__all__ = ["ArchConfig", "CONFIGS", "get_config"]

"""Published architecture configs (import side-effect: registration).

All eleven of the reference: the dense family (mesh-paper, Qwen2-7B,
Granite-3 8B, Phi-3-medium 14B, Mistral-Large 123B), the moe family
(OLMoE-1B-7B, Qwen1.5-MoE-A2.7B), and RWKV-6 1.6B (ssm), Zamba2-1.2B
(hybrid), Pixtral-12B (vlm) and Whisper-medium (audio)."""

from repro_torch.configs.base import CONFIGS, SHAPES, ArchConfig, ShapeSpec, get_config
from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    mesh_paper,
    mistral_large_123b,
    olmoe_1b_7b,
    phi3_medium_14b,
    pixtral_12b,
    qwen2_7b,
    qwen2_moe_a27b,
    rwkv6_1b6,
    whisper_medium,
    zamba2_1b2,
)

# The ten architectures the dry runs sweep (mesh-paper is the paper's own).
ASSIGNED_ARCHS = (
    "olmoe-1b-7b",
    "qwen2-moe-a2.7b",
    "granite-3-8b",
    "phi3-medium-14b",
    "qwen2-7b",
    "mistral-large-123b",
    "rwkv6-1.6b",
    "whisper-medium",
    "zamba2-1.2b",
    "pixtral-12b",
)

__all__ = ["ASSIGNED_ARCHS", "ArchConfig", "CONFIGS", "SHAPES", "ShapeSpec", "get_config"]

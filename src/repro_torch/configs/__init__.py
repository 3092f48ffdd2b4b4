"""Published architecture configs (import side-effect: registration).

Only mesh-paper is ported so far; the other families arrive with their
model code."""

from repro_torch.configs.base import CONFIGS, ArchConfig, get_config
from repro_torch.configs import mesh_paper  # noqa: F401

__all__ = ["ArchConfig", "CONFIGS", "get_config"]

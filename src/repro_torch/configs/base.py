"""Architecture config system (port of `repro.configs.base`).

One frozen dataclass describes an architecture; each config module
instantiates `ArchConfig` with its published numbers and registers it, and
`reduced()` derives the CPU-test variant (same family and code paths, tiny
dims).  Only the fields the ported families read are kept; the dtype
properties return `torch.dtype`s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

__all__ = ["ArchConfig", "register", "get_config", "CONFIGS"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    arch_id: str
    family: str  # dense | moe (the families ported so far)
    source: str  # citation tag

    # transformer backbone
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # expert hidden dim (d_ff above = dense fallback/shared)
    router_aux_coef: float = 0.01

    # numerics / kernel levers
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    use_mesh_kernel: bool = False  # route GEMMs through the mesh kernel
    mesh_block_m: int = 0  # logical block shape overrides; 0 = (128,128,128)
    mesh_block_n: int = 0
    mesh_block_k: int = 0
    scramble_privacy: bool = False  # applies only to lm_forward (training)
    attn_chunk: int = 0  # >0: flash-style chunked attention (KV-chunk online
    # softmax) for train/prefill — kills the O(S^2) score materialization
    vocab_pad_multiple: int = 0  # pad embedding/lm_head rows (0 = exact)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.activation_dtype]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def reduced(self) -> "ArchConfig":
        """CPU-test variant: same family/code paths, tiny dims (identical to
        the reference's `reduced()` for the fields kept here)."""
        kv = max(1, min(self.num_kv_heads, 2))
        heads = max(kv, min(self.num_heads, 4))
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 8) if self.is_moe else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.is_moe else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=64 if self.is_moe else 0,
            param_dtype="float32",
            activation_dtype="float32",
        )


CONFIGS: Dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]) -> Callable[[], ArchConfig]:
    cfg = fn()
    CONFIGS[cfg.arch_id] = fn
    return fn


def get_config(arch_id: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    if arch_id not in CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[arch_id]()

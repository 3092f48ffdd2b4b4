"""Architecture config system (port of `repro.configs.base`).

One frozen dataclass describes an architecture; each config module
instantiates `ArchConfig` with its published numbers and registers it, and
`reduced()` derives the CPU-test variant (same family and code paths, tiny
dims).  The fields that no ported code reads are left out: those only the
reference's XLA lowering reads (`fused_dense_epilogue`, `scan_unroll`: the
port's dry run traces every layer, `launch/dryrun.py`) or nothing reads
(`is_encoder_decoder`, `has_decode`, `ssm_conv_dim`: the conv width is
`models.ssm._CONV_K`).  The dtype properties return `torch.dtype`s.

Shapes are separate (`ShapeSpec`): the four assigned input-shape cells.
`launch/dryrun.py` iterates ASSIGNED_ARCHS x SHAPES.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "register", "get_config", "CONFIGS"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
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

    # SSM / RWKV / hybrid
    ssm_state_size: int = 0
    ssm_num_heads: int = 0  # mamba2 heads (d_inner / head_p)
    ssm_expand: int = 2
    shared_attn_period: int = 0  # zamba2: shared attn block after every k SSM layers

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    dec_ratio: int = 8  # decoder len = enc len // dec_ratio for assigned shapes

    # VLM (pixtral)
    num_stub_patches: int = 0  # stub ViT frontend: precomputed patch embeddings

    # capability flag: a sub-quadratic path, so the dry run's long_500k cell
    # runs (launch/dryrun._cell_applicable)
    supports_long_context: bool = False

    # numerics / kernel levers
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat_policy: str = "dots"  # none | dots | full (models/transformer._remat)
    use_mesh_kernel: bool = False  # route GEMMs through the mesh kernel
    mesh_block_m: int = 0  # logical block shape overrides; 0 = (128,128,128)
    mesh_block_n: int = 0
    mesh_block_k: int = 0
    scramble_privacy: bool = False  # applies only to lm_forward (training)
    attn_chunk: int = 0  # >0: flash-style chunked attention (KV-chunk online
    # softmax) for train/prefill — kills the O(S^2) score materialization
    vocab_pad_multiple: int = 0  # pad embedding/lm_head rows (0 = exact)
    wkv_chunked: bool = False  # rwkv6: chunk-parallel GEMM-form WKV (exact)
    # instead of the per-token scan — see models/rwkv._wkv_chunked
    wkv_chunk: int = 16
    grad_accum: int = 1  # microbatch gradient accumulation (train_step); bounds
    # activation residency per pass (launch/dryrun.py, launch/hillclimb.py)

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

    def n_params_dense_blocks(self) -> int:
        """Rough parameter count (the reference's formula: its shared-expert
        term counts d_ff per shared expert, so it over-counts configs whose
        d_ff is the shared experts' fused width)."""
        d, L = self.d_model, self.num_layers
        hd = self.head_dim_
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.is_moe:
            ff = 3 * d * self.moe_d_ff * self.num_experts
            ff += 3 * d * self.d_ff * self.num_shared_experts
        else:
            ff = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ff) + emb

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.n_params_dense_blocks()
        d, L = self.d_model, self.num_layers
        hd = self.head_dim_
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ff = 3 * d * self.moe_d_ff * self.num_experts_per_tok
        ff += 3 * d * self.d_ff * self.num_shared_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ff) + emb

    def tuned(self, tp: int = 16) -> "ArchConfig":
        """The reference's production tuning: chunked (flash) attention for
        every attention-bearing family, vocab padding when the vocab does
        not divide `tp`, and the chunk-parallel WKV for the `ssm` family
        (RWKV), which has no attention."""
        kw: dict = {"wkv_chunked": True} if self.family == "ssm" else {"attn_chunk": 1024}
        if self.vocab_size % tp:
            kw["vocab_pad_multiple"] = 256
        return dataclasses.replace(self, **kw)

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
            ssm_state_size=min(self.ssm_state_size, 16) if self.ssm_state_size else 0,
            ssm_num_heads=min(self.ssm_num_heads, 4) if self.ssm_num_heads else 0,
            shared_attn_period=2 if self.shared_attn_period else 0,
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            num_stub_patches=min(self.num_stub_patches, 8),
            param_dtype="float32",
            activation_dtype="float32",
            remat_policy="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}

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

"""Feed-forward blocks (port of `repro.models.moe`, dense SwiGLU only; the
routed expert block arrives with the grouped-GEMM slice)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import PSpec, gemm

__all__ = ["swiglu", "swiglu_specs"]


def swiglu_specs(cfg, d_ff: int) -> Dict[str, PSpec]:
    d = cfg.d_model
    out_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    return {
        "wi": PSpec((d, 2 * d_ff), ("embed", "mlp"), 0.02),  # fused gate+up
        "wo": PSpec((d_ff, d), ("mlp", "embed"), out_scale),
    }


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    gate_up = gemm(x, p["wi"], cfg)
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    h = F.silu(gate) * up
    return gemm(h, p["wo"], cfg)

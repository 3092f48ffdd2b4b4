"""Shared building blocks: param specs, norms, RoPE, the config-routed GEMM.

Port of `repro.models.layers` (without `ShardCtx`, which comes with
tensor-parallel model code).  Each model family defines
a `param_specs(cfg)` tree whose leaves are `PSpec(shape, logical_axes,
scale, dtype, init)`; `init_params` materializes it from a
`torch.Generator` on an explicit device.  All GEMMs go through the
plan/execute API (`repro_torch.kernels.api`): `gemm` builds a typed
GemmSpec, `api.plan` resolves the backend once per logical shape
(cfg.use_mesh_kernel selects the mesh kernel), and the cached plan executes
per call; `grouped_gemm` does the same for the MoE experts' ragged
products.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import api as _api

__all__ = [
    "PSpec",
    "apply_rope",
    "dense",
    "gemm",
    "grouped_gemm",
    "init_params",
    "logical_axes_tree",
    "padded_vocab",
    "rmsnorm",
    "softmax_xent",
]


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declarative parameter: shape + logical axes + init scale."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    scale: float = 0.02
    dtype: Any = None  # filled from cfg.param_dtype at materialization
    init: str = "normal"  # normal | zeros | ones

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _map_specs(fn, specs):
    if isinstance(specs, PSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def init_params(
    generator: torch.Generator, specs, dtype: torch.dtype, *, device
) -> Any:
    """Materialize a PSpec tree into tensors on `device`.

    Normal leaves draw N(0, 1) in f32 from `generator` (which must live on
    `device`), in the tree's key order, then scale (in place, so a leaf's
    transient is its f32 draw) and cast — the reference's recipe, with
    torch's generator in place of JAX's keys.
    """
    def make(s: PSpec) -> torch.Tensor:
        dt = s.dtype or dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(s.scale).to(dt)

    return _map_specs(make, specs)


def logical_axes_tree(specs) -> Any:
    """Matching tree of logical-axis tuples, for `parallel.sharding`."""
    return _map_specs(lambda s: s.axes, specs)


def padded_vocab(cfg) -> int:
    """Embedding/lm_head row count, padded to cfg.vocab_pad_multiple (0 =
    exact).  Padded logits are masked out of argmax."""
    m = cfg.vocab_pad_multiple
    if not m:
        return cfg.vocab_size
    return ((cfg.vocab_size + m - 1) // m) * m


def gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
    mesh: Any = None,
    shard: Any = None,
) -> torch.Tensor:
    """Config-routed GEMM via plan/execute: the `torch` backend, or the mesh
    kernel (`cuda_mesh`) when cfg.use_mesh_kernel.

    The epilogue (y = act(xW + bias) + residual) is fused into the kernel on
    the mesh path and applied as plain ops on the torch backend — one call
    site, identical semantics.  Block shapes come from cfg.mesh_block_m/n/k
    when set (> 0).  Under autograd the plan runs its product as the op
    `repro_torch::gemm`, which the `dots` remat policy saves.

    With `shard` (a `kernels.api.ShardSpec`) and its device `mesh`, the
    plan is a ShardedPlan: the same per-shard product inside the
    ShardSpec's collective schedule, run by every rank of the mesh on the
    same global operands and returning the global result, so call sites do
    not change shape-wise.
    """
    backend = "cuda_mesh" if cfg.use_mesh_kernel else "torch"
    blocks = (cfg.mesh_block_m or None, cfg.mesh_block_n or None, cfg.mesh_block_k or None)
    spec = _api.GemmSpec.from_operands(
        x,
        w,
        epilogue=_api.Epilogue(
            bias=bias is not None,
            activation=activation,
            residual=residual is not None,
        ),
        out_dtype=x.dtype,
        blocks=blocks,
        shard=shard,
    )
    return _api.plan(spec, backend=backend, device=x.device, mesh=mesh)(
        x, w, bias=bias, residual=residual
    )


def grouped_gemm(
    tokens: torch.Tensor,  # (num_groups * rows_per_group, K), group-major
    group_offsets: torch.Tensor,  # (num_groups + 1,) cumulative valid-row counts
    weights: torch.Tensor,  # (num_groups, K, N) stacked per-group slabs
    cfg,
) -> torch.Tensor:
    """Config-routed grouped (ragged-batch) GEMM via plan/execute.

    The MoE expert path: row blocks of the capacity-layout `tokens` buffer
    multiply their group's (K, N) weight slab in ONE kernel (K5 on the
    `cuda_mesh` backend when cfg.use_mesh_kernel, else a segment-masked
    `bmm` on the `torch` backend), with rows past each group's size coming
    back zero.  Plans are cached per logical group shape exactly like
    `gemm`: every layer and step reuses one plan per expert projection.
    """
    backend = "cuda_mesh" if cfg.use_mesh_kernel else "torch"
    num_groups, kd, n = weights.shape
    blocks = (cfg.mesh_block_m or None, cfg.mesh_block_n or None, cfg.mesh_block_k or None)
    spec = _api.GemmSpec.for_groups(
        _api.GroupSpec(num_groups, tokens.shape[0] // num_groups),
        k=kd,
        n=n,
        dtype_a=tokens.dtype,
        dtype_b=weights.dtype,
        out_dtype=tokens.dtype,
        blocks=blocks,
    )
    return _api.plan(spec, backend=backend, device=tokens.device)(tokens, group_offsets, weights)


def dense(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg,
    b: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
    mesh: Any = None,
    shard: Any = None,
) -> torch.Tensor:
    """Dense projection with the fused epilogue: one kernel on the mesh path."""
    return gemm(x, w, cfg, bias=b, activation=activation, residual=residual, mesh=mesh,
                shard=shard)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) or (T,).  Rotate pairs (even, odd)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv  # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable mean token cross-entropy.  Returns (loss, acc)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(lf, dim=-1) == labels).float())
    return loss, acc

"""Plain-torch oracles for the mesh kernels (port of `repro.kernels.ref`).

They define the *semantics* the kernels are tested against; the kernels
define the *schedule*.  Products accumulate in float32 whatever the input
type (the reference's `preferred_element_type=jnp.float32` contract): inputs
are upcast first, so a bf16 product is exact and only the sum rounds.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.scramble import _scramble_perm_np, inverse_perm

__all__ = [
    "grouped_matmul_ref",
    "matmul_ref",
    "mesh_matmul_ref",
    "scramble_blocks_ref",
    "unscramble_blocks_ref",
]


def matmul_ref(
    a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """C = A @ B with f32 accumulation."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def mesh_matmul_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block_m: int,
    block_n: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Scrambled-output matmul: cell-block (i,j) of the result holds standard
    block sigma(i,j) of A @ B.  Requires a square (g x g) output block grid."""
    m, n = a.shape[0], b.shape[1]
    gm, gn = m // block_m, n // block_n
    if gm != gn:
        raise ValueError(f"scrambled output needs a square block grid, got {gm}x{gn}")
    c = matmul_ref(a, b, out_dtype)
    return scramble_blocks_ref(c, block_m=block_m, block_n=block_n)


def _permute_blocks(x: torch.Tensor, perm, block_m: int, block_n: int) -> torch.Tensor:
    """Output block (i, j) = input block perm[i*g + j] on the trailing dims."""
    m, n = x.shape[-2], x.shape[-1]
    g = m // block_m
    lead = x.shape[:-2]
    blocks = x.reshape(*lead, g, block_m, g, block_n).movedim(-2, -3)
    flat = blocks.reshape(*lead, g * g, block_m, block_n)
    idx = torch.as_tensor(perm, dtype=torch.long, device=x.device)
    out = flat.index_select(-3, idx).reshape(*lead, g, g, block_m, block_n)
    return out.movedim(-2, -3).reshape(*lead, m, n)


def scramble_blocks_ref(x: torch.Tensor, *, block_m: int, block_n: int) -> torch.Tensor:
    """Apply the paper's S at block granularity to the trailing 2 dims of x."""
    m, n = x.shape[-2], x.shape[-1]
    g = m // block_m
    if g != n // block_n or g * block_m != m or g * block_n != n:
        raise ValueError(f"(m={m}, n={n}) not a square grid of ({block_m},{block_n}) blocks")
    return _permute_blocks(x, _scramble_perm_np(g), block_m, block_n)


def unscramble_blocks_ref(x: torch.Tensor, *, block_m: int, block_n: int) -> torch.Tensor:
    """Inverse of scramble_blocks_ref."""
    g = x.shape[-2] // block_m
    return _permute_blocks(x, inverse_perm(_scramble_perm_np(g)), block_m, block_n)


def grouped_matmul_ref(
    tokens: torch.Tensor,  # (num_groups * rows_per_group, K), group-major
    sizes: torch.Tensor,  # (num_groups,) valid-row counts
    weights: torch.Tensor,  # (num_groups, K, N)
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Grouped (ragged-batch) matmul oracle: row r of the capacity-layout
    buffer multiplies its group's weight slab; rows at or beyond a group's
    size are zero regardless of their contents."""
    n_groups, k, n = weights.shape
    rpg = tokens.shape[0] // n_groups
    out_dtype = out_dtype or torch.promote_types(tokens.dtype, weights.dtype)
    z = torch.bmm(tokens.reshape(n_groups, rpg, k).float(), weights.float())
    valid = torch.arange(rpg, device=tokens.device)[None, :] < sizes[:, None]
    z = torch.where(valid[..., None], z, 0.0)
    return z.reshape(n_groups * rpg, n).to(out_dtype)

"""Differentiable kernel ops (port of the scramble half of `repro.kernels.ops`).

`scramble_blocks` applies S^k at block granularity through K3
(`kernels/scramble.py`) with a gradient: the permutation's linearization is
itself and its transpose is the inverse permutation, so the backward pass is
S^-k of the cotangent — the reference's `_scramble_pallas_vjp`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import scramble as _scramble

__all__ = ["scramble_blocks"]


class _ScrambleBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_m, block_n, k):
        ctx.opts = (block_m, block_n, k)
        return _scramble.scramble_blocks(x, block_m=block_m, block_n=block_n, k=k)

    @staticmethod
    def backward(ctx, g):
        block_m, block_n, k = ctx.opts
        dx = _ScrambleBlocks.apply(g, block_m, block_n, -k)
        return dx, None, None, None


def scramble_blocks(
    x: torch.Tensor, *, block_m: int = 128, block_n: int = 128, k: int = 1
) -> torch.Tensor:
    """S^k at block granularity on the trailing (m, n) dims, differentiable."""
    return _ScrambleBlocks.apply(x, block_m, block_n, k)

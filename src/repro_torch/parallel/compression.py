"""Int8 error-feedback gradient compression for the DP all-reduce (port of
`repro.parallel.compression`).

Each gradient tensor travels as int8 quantization levels plus one shared
f32 scale, and the quantization residual is carried into the next step's
gradient (error feedback: Seide et al. 2014; Karimireddy et al. 2019), so
the compression bias telescopes.

Semantics, per tensor, over the ranks of the DP axes:
    corrected = grad + error_state
    scale     = all_reduce_max(max|corrected|) / 127     (one scalar)
    q         = round(corrected / scale)  : int8          (half to even,
                                                            as jnp.round)
    summed    = all_reduce_sum(q as int32)                (an int8 sum
                                                            overflows)
    mean_grad = summed * scale / n_ranks
    new_error = corrected - q * scale                     (local residual)

The int32 sum is exact, so every rank gets the same mean.  SPMD in place
of `shard_map`: each process passes its own gradient and residual, and
the ranks of the DP axes (`collectives.axis_group`) reduce together.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import all_reduce, axis_group
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["compressed_pmean_tree", "compressed_psum_mean", "init_error_state"]


def init_error_state(grads: Any) -> Any:
    """Zero residual tree matching the gradient tree (f32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_psum_mean(
    g: torch.Tensor, e: torch.Tensor, axis_names=("data",), *, mesh=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor: (mean-of-grads approximation in g's dtype, new f32
    residual).  `mesh` None reduces over the default group."""
    group, n, _ = axis_group(mesh, axis_names)

    def reduce(x, op):
        return x if group is None else all_reduce(x, op, group)

    corrected = g.float() + e
    # One shared scale, so the ranks' int8 levels add up as fixed point.
    amax = reduce(corrected.abs().max(), dist.ReduceOp.MAX)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    summed = reduce(q.to(torch.int32), dist.ReduceOp.SUM)
    mean = summed.float() * scale / float(n)
    new_e = corrected - q.float() * scale
    return mean.to(g.dtype), new_e


def compressed_pmean_tree(grads: Any, errors: Any, axis_names=("data",), *, mesh=None):
    """Tree version; returns (mean grads, new error states)."""
    out = [compressed_psum_mean(g, e, axis_names, mesh=mesh)
           for g, e in zip(tree_leaves(grads), tree_leaves(errors))]
    return (tree_unflatten(grads, [m for m, _ in out]),
            tree_unflatten(grads, [e for _, e in out]))

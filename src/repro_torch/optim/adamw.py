"""AdamW on parameter trees, with global-norm clipping (port of
`repro.optim.adamw`).

State is {"m", "v", "count"} with f32 moments shaped like the params tree.
The arithmetic is the reference's: gradients clip by their global norm
first (and round back to their own dtype, as the reference's clip does),
moments and the step are computed in f32, weight decay skips tensors with
ndim < 2, and the result is cast to the parameter dtype once.  That is why
this is not `torch.optim.AdamW`, which rounds bf16 parameters differently.

Unlike the reference, which returns new trees, `adamw_update` writes the
new parameters and moments INTO the given tensors (no second copy of the
model and optimizer state on the card) and returns them.  Under a 'model'
axis each rank updates its blocks; only the norm needs the other ranks
(`global_norm(tree, blocks)`), the rest is elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Any) -> Any:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    count_dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=count_dev),
    }


def global_norm(tree: Any, blocks=None) -> torch.Tensor:
    """The f32 norm of every leaf of `tree`.  With `blocks` (an
    `interop.ModelBlocks`: `tree` is a rank's blocks under a 'model' axis),
    the norm of the global tree: the squares of each rank's own elements
    summed over 'model' by one f32 all-reduce, each replicated leaf or
    segment counted once; every 'model' rank gets the same value.  Under
    FSDP the data-cut leaves' sum is then summed over the DP axes."""
    if blocks is not None and blocks.data_group is not None:
        # FSDP: the data-cut leaves' squares are summed over the DP axes too.
        from repro_torch.parallel.collectives import all_reduce

        def over_model(own, rep):
            return (own if blocks.group is None else all_reduce(own, group=blocks.group)) + rep

        cut = all_reduce(over_model(*blocks.norm_squares(tree, data_cut=True)),
                         group=blocks.data_group)
        return torch.sqrt(over_model(*blocks.norm_squares(tree, data_cut=False)) + cut)
    if blocks is not None and blocks.group is not None:
        from repro_torch.parallel.collectives import all_reduce

        own, rep = blocks.norm_squares(tree)
        return torch.sqrt(all_reduce(own, group=blocks.group) + rep)
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:  # the reference's tree.reduce order
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float, blocks=None) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads, blocks)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(
    grads: Any,
    opt_state: Any,
    params: Any,
    lr: torch.Tensor,
    cfg: AdamWConfig = AdamWConfig(),
    blocks=None,
) -> Tuple[Any, Any, torch.Tensor]:
    """Returns (params, opt_state, pre-clip grad norm), updated in place.
    With `blocks` the trees are a rank's blocks (`global_norm`)."""
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, blocks)
    else:
        gnorm = global_norm(grads, blocks)
    count = opt_state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    def upd(g, m, v, p):
        gf = g.float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(gf))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:  # no weight decay on norms/biases/scalars
            step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))

    tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": count}, gnorm

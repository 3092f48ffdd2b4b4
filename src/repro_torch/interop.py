"""Parameters and train states carried between the JAX package and the port,
bit for bit.

`params_from_numpy(tree, device)` turns a nested dict of numpy arrays —
the reference's parameter tree after `jax.tree.map(np.asarray, params)`,
done by the caller — into the port's tensors, so both packages compute on
the same weights.  `train_state_from_numpy` does the same for a whole train
state (params, AdamW `m`/`v`/`count`, `step`), and `train_state_to_numpy`
goes back, so a port state can be handed to the reference;
`stack_ranks` stacks the data-parallel ranks' (1, *shape) residual slices
into the reference's (dp, *shape) layout.  `shard_params` cuts a full
parameter tree into this rank's blocks for tensor-parallel serving.  bfloat16 arrays arrive as `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses; they travel as their 16-bit patterns
(`view(np.uint16)`) and are reinterpreted as `torch.bfloat16`.  Neither
`jax` nor `ml_dtypes` is imported here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "shard_params", "stack_ranks", "train_state_from_numpy",
           "train_state_to_numpy"]


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy: the tensor owns it
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays (params, or any other tree) -> the same
    tree of tensors on `device` (cuda unless the caller names another)."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dev)

    return convert(tree)


def train_state_from_numpy(state: Any, device=None) -> Any:
    """The reference's train state {"params", "opt": {"m", "v", "count"},
    "step"} as numpy arrays -> the port's train state on `device`.  Raises
    ValueError for a tree of another layout, which `make_train_step` would
    only reject mid-step."""
    if (not isinstance(state, dict) or set(state) != {"params", "opt", "step"}
            or not isinstance(state["opt"], dict)
            or set(state["opt"]) != {"m", "v", "count"}):
        raise ValueError("not a train state {'params', 'opt': {'m', 'v', 'count'}, 'step'}")
    return params_from_numpy(state, device)


def train_state_to_numpy(state: Any) -> Any:
    """A port tree of tensors -> the same tree of numpy arrays.  bfloat16
    tensors come back as their uint16 bit patterns (the caller views them as
    its bfloat16 type, e.g. `ml_dtypes.bfloat16`)."""

    def convert(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().copy()

    return tree_map(convert, state)


def stack_ranks(trees) -> Any:
    """The ranks' trees of numpy arrays, in rank order, each leaf a (1,
    ...) slice (the compressed DP step's "err") -> one tree whose leaves
    are their concatenation on axis 0, the reference's (dp, ...) leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_ranks([t[k] for t in trees]) for k in first}
    return np.concatenate(trees, axis=0)


def shard_params(params: Any, model, ctx) -> Any:
    """This rank's blocks of the full parameter tree `params` (from the
    reference's init through `params_from_numpy`, or the port's own), laid
    out as the model code under `ctx` (a `models.layers.ShardCtx`) reads
    them.

    Each leaf is `shard_of` its `tree_shardings(model.logical_axes(), mesh,
    rules)` sharding (indivisible dims replicated), with these exceptions,
    where the port's layout is not the flat split of the dim:
      * 'heads' and 'kv_heads' dims (h * hd, kv * hd) split in whole heads,
        and replicate unless the head count divides the axis;
      * a fused [gate | up] dim (`moe.FUSED_GATE_UP`) gives each rank its
        slice of gate beside its slice of up, so the model's local split
        pairs them (a flat split would give rank 0 all of gate);
      * Mamba2's 'mlp' dims (`ssm.MAMBA_LAYOUT`: in_proj's [z | x | B | C |
        dt], conv_w / conv_b's [x | B | C], out_norm and out_proj's x) give
        each rank its whole SSM heads of z, x and dt, and B and C whole.
    Without a live mesh the tree comes back as it is.
    """
    from repro_torch.models.moe import FUSED_GATE_UP
    from repro_torch.models.ssm import MAMBA_LAYOUT, mamba_segments
    from repro_torch.parallel.sharding import named_sharding, shard_of

    if not ctx.active:
        return params
    cfg, hd = model.cfg, model.cfg.head_dim_
    rules, _, lay = ctx._resolved
    units = {"heads": (cfg.num_heads, hd), "kv_heads": (cfg.num_kv_heads, hd)}

    def segments(t, d, key):
        """[(kind, units, unit)] of a fused 'mlp' dim, or None."""
        if key in FUSED_GATE_UP:
            return [("heads", t.shape[d] // 2, 1)] * 2
        if cfg.family == "hybrid" and key in MAMBA_LAYOUT:
            return mamba_segments(cfg, key)
        return None

    def cut(t, axes, key):
        fused = [a == "mlp" and segments(t, d, key) is not None for d, a in enumerate(axes)]
        if not any(a in units for a in axes) and not any(fused):
            return shard_of(t, named_sharding(axes, ctx.mesh, rules, shape=t.shape), lay)
        for d, a in enumerate(axes):
            if a in units:
                n, unit = units[a]
                part = ctx.part(a, n)
                t = t.narrow(d, part.start * unit, part.size * unit)
            elif fused[d]:
                pieces, off = [], 0
                for kind, n, unit in segments(t, d, key):
                    part = ctx.part(a, n) if kind == "heads" else None
                    pieces.append(t.narrow(d, off, n * unit) if part is None
                                  else t.narrow(d, off + part.start * unit, part.size * unit))
                    off += n * unit
                t = torch.cat(pieces, dim=d)
            elif a is not None:
                part = ctx.part(a, t.shape[d])
                t = t.narrow(d, part.start, part.size)
        return t.contiguous()

    def walk(node, axes, key):
        if isinstance(node, dict):
            return {k: walk(v, axes[k], k) for k, v in node.items()}
        return cut(node, axes, key).clone()

    return walk(params, model.logical_axes(), None)

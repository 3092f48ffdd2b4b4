"""Parameters and train states carried between the JAX package and the port,
bit for bit.

`params_from_numpy(tree, device)` turns a nested dict of numpy arrays —
the reference's parameter tree after `jax.tree.map(np.asarray, params)`,
done by the caller — into the port's tensors, so both packages compute on
the same weights.  `train_state_from_numpy` does the same for a whole train
state (params, AdamW `m`/`v`/`count`, `step`), and `train_state_to_numpy`
goes back, so a port state can be handed to the reference;
`stack_ranks` stacks the data-parallel ranks' (1, *shape) residual slices
into the reference's (dp, *shape) layout.  bfloat16 arrays arrive as `ml_dtypes.bfloat16`, which
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

__all__ = ["params_from_numpy", "stack_ranks", "train_state_from_numpy", "train_state_to_numpy"]


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

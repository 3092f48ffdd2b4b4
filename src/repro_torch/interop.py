"""Parameters from the JAX package, carried into the port bit for bit.

`params_from_numpy(tree, device)` turns a nested dict of numpy arrays —
the reference's parameter tree after `jax.tree.map(np.asarray, params)`,
done by the caller — into the port's tensors, so both packages compute on
the same weights.  bfloat16 arrays arrive as `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses; they travel as their 16-bit patterns
(`view(np.uint16)`) and are reinterpreted as `torch.bfloat16`.  Neither
`jax` nor `ml_dtypes` is imported here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_numpy"]


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy: the tensor owns it
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays -> the same tree of tensors on `device`
    (cuda unless the caller names another)."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dev)

    return convert(tree)

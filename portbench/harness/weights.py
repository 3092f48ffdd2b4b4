"""Weights made by the benchmark from the seed, on the device, in the type
they are served in, one large call a stacked leaf.

The tree has the port's layout (`Model.specs()`: names, shapes, dtypes),
because that is the interface the system under test takes its weights
through; the values are the benchmark's own.  Matrices draw N(0, 0.02²);
an output projection (`wo`) N(0, (0.02 / sqrt(2 L))²), so the residual
stream keeps its scale over depth; norm gains 1 + N(0, 0.02²) and biases
N(0, 0.02²), so a program that skips either is seen.  The same seed gives
the same bits, so the reference draws the same weights again rather than
take anything the program has held.
"""

from __future__ import annotations

from typing import Any

import torch


def _scale(path: str, num_layers: int) -> float:
    if path.endswith(".wo"):
        return 0.02 / max(1.0, (2 * num_layers) ** 0.5)
    return 0.02


def make_params(specs: Any, cfg, seed: int, device) -> Any:
    """The weight tree of `specs` (a PSpec tree) drawn from `seed`."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        dtype = node.dtype or cfg.pdtype
        x = torch.randn(node.shape, generator=gen, device=device, dtype=dtype)
        if node.init == "ones":
            return x.mul_(0.02).add_(1.0)
        return x.mul_(0.02 if node.init == "zeros" else _scale(path, cfg.num_layers))

    return walk(specs, "")

"""PyTorch + CUDA port of the mesh-array system (`repro`), for NVIDIA Hopper.

The JAX package `repro` is the reference; this package mirrors its module
layout and names so each module's counterpart is easy to find, and imports
neither `jax` nor anything of `repro`.  Kernels that `repro` wrote in Pallas
for the TPU are hand-written CUDA C++ here (`csrc/`, built by
`kernels/_build.py` with `nvcc` for `sm_90a`); plain tensor code is PyTorch.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`): `resolve_device(None)` raises when no CUDA device is
present instead of quietly running on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names one.

    With no argument and no CUDA device this raises — the port never falls
    back to the CPU on its own; tests pass `device="cpu"` explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the port"
                " on the host explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available")
    return dev

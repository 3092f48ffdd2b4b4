"""The paper's scramble S^k at block granularity: CUDA kernel K3 + plain version.

Port of `repro.kernels.scramble_kernel` (`scramble_blocks_pallas`).  On a
square g x g grid of (block_m, block_n) blocks over the trailing two dims,

    output block (i, j) = input block perm[i*g + j],   perm = S^k

with S^k composed through the cycle decomposition (`power_perm`), so any
integer k costs the same; k < 0 unscrambles.  Leading dims are flattened
into one launch.  The op only moves data: kernel, plain version and the
reference agree bit for bit for every dtype.

`scramble_blocks` runs `scramble_blocks_torch` (one gather) on CPU tensors
and `scramble_blocks_cuda` (`csrc/scramble_blocks.cu`, see its header for
the design) on CUDA tensors, or raises; `scramble_blocks_cuda.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.scramble import _scramble_perm_np, power_perm
from repro_torch.kernels import _build
from repro_torch.kernels.ref import _permute_blocks

__all__ = [
    "scramble_blocks",
    "scramble_blocks_cuda",
    "scramble_blocks_torch",
    "scramble_perm_power",
]

# A CTA moves about this many bytes (a row chunk of one block).
_CTA_BYTES = 16 * 1024


@functools.lru_cache(maxsize=None)
def scramble_perm_power(g: int, k: int) -> np.ndarray:
    """S^k on a g x g block grid as a flat int32 gather table (cached: do not
    mutate)."""
    return power_perm(_scramble_perm_np(g), k).astype(np.int32)


def _grid(x: torch.Tensor, block_m: int, block_n: int) -> int:
    if x.dim() < 2 or block_m < 1 or block_n < 1:
        raise ValueError(f"need a >= 2D tensor and positive blocks, got {tuple(x.shape)}")
    m, n = x.shape[-2], x.shape[-1]
    g = m // block_m
    if g < 1 or g * block_m != m or g * block_n != n:
        raise ValueError(
            f"(m={m}, n={n}) is not a square g x g grid of ({block_m},{block_n}) blocks"
        )
    return g


def scramble_blocks_torch(
    x: torch.Tensor, *, block_m: int = 128, block_n: int = 128, k: int = 1
) -> torch.Tensor:
    """The plain version of K3: one block gather with S^k's table."""
    g = _grid(x, block_m, block_n)
    return _permute_blocks(x, scramble_perm_power(g, k), block_m, block_n)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("scramble_blocks").scramble_blocks_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    fn.restype = i32
    return fn


def _error_string(err: int) -> str:
    fn = _build.library("scramble_blocks").scramble_blocks_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


# S^k tables on the device, uploaded once per (g, k, device).
_PERM_DEV: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _perm_on(g: int, k: int, device: torch.device) -> torch.Tensor:
    key = (g, k, str(device))
    t = _PERM_DEV.get(key)
    if t is None:
        t = torch.as_tensor(scramble_perm_power(g, k), device=device)
        _PERM_DEV[key] = t
    return t


def scramble_blocks_cuda(
    x: torch.Tensor, *, block_m: int = 128, block_n: int = 128, k: int = 1
) -> torch.Tensor:
    """Launch K3 on a CUDA tensor (no fallback: a refused launch raises)."""
    if x.device.type != "cuda":
        raise ValueError(f"scramble_blocks_cuda takes a CUDA tensor, got {x.device}")
    g = _grid(x, block_m, block_n)
    lead = x.numel() // (x.shape[-2] * x.shape[-1])
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    if g * g >= 2**31 or max(x.shape[-2:]) * x.element_size() >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    x = x.contiguous()
    row_bytes = block_n * x.element_size()
    rows_per_cta = max(1, min(block_m, _CTA_BYTES // row_bytes))
    err = _kernel()(
        x.data_ptr(), out.data_ptr(), _perm_on(g, k, x.device).data_ptr(),
        lead, g, block_m, block_n, x.element_size(), rows_per_cta,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"scramble_blocks kernel launch failed: {_error_string(err)}")
    scramble_blocks_cuda.launches += 1
    return out


scramble_blocks_cuda.launches = 0


def scramble_blocks(
    x: torch.Tensor, *, block_m: int = 128, block_n: int = 128, k: int = 1
) -> torch.Tensor:
    """S^k on x's trailing (m, n) dims: the plain version on CPU tensors, K3 on
    CUDA tensors."""
    if x.device.type == "cpu":
        return scramble_blocks_torch(x, block_m=block_m, block_n=block_n, k=k)
    if x.device.type != "cuda":
        raise ValueError(f"scramble_blocks runs on cuda or cpu tensors, got {x.device}")
    return scramble_blocks_cuda(x, block_m=block_m, block_n=block_n, k=k)

"""RMSNorm with a fixed order of summation per row: CUDA kernel R1 + plain version.

A kernel of the port alone: the reference computes rmsnorm in XLA
(`repro.models.layers.rmsnorm`), and so did the port, in torch ops, until
it showed that PyTorch's CUDA reduction takes its launch shape, and so the
order in which it sums a row's squares, from the row count.  A row's
output then depended on how many rows were normalised beside it, and
decode was not batch-invariant: a 2-slot rank and the 4-slot single
process could part by one ulp.  R1 (`csrc/rmsnorm.cu`, see its header)
sums every row in one order fixed by d alone, so a row's output is the
same at 1 row or 4096.

`rmsnorm` runs `rmsnorm_torch` (the plain version, the body the port's
`layers.rmsnorm` had) on CPU and meta tensors (the dry runs' traces count
its ops), and on a CUDA tensor launches R1 inside `_RMSNorm` or raises:
there is no fallback.  `_RMSNorm`'s backward recomputes the plain version
under autograd and returns its gradient, as `flash_attention._FlashAttention`
does (a kernel launched through ctypes is invisible to autograd).
`rmsnorm_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from repro_torch.kernels import _build

__all__ = ["rmsnorm", "rmsnorm_cuda", "rmsnorm_torch"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_torch(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version: the reference's rmsnorm op for op."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("rmsnorm").rmsnorm_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = _build.library("rmsnorm").rmsnorm_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch R1 on CUDA tensors (no fallback: a refused launch raises)."""
    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(f"rmsnorm_cuda takes CUDA tensors on one device, got {x.device}"
                         f" and {gamma.device}")
    if x.dtype not in _DTYPE_CODES or gamma.dtype not in _DTYPE_CODES:
        raise ValueError(f"rmsnorm_cuda takes f32 or bf16, got {x.dtype} and {gamma.dtype}")
    d = x.shape[-1]
    if gamma.shape != (d,):
        raise ValueError(f"gamma of shape {tuple(gamma.shape)} for rows of {d}")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    err = _kernel()(
        x.data_ptr(), gamma.contiguous().data_ptr(), out.data_ptr(), rows, d,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[gamma.dtype], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: {_error_string(err)}")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


class _RMSNorm(torch.autograd.Function):
    """`forward_impl(x, gamma, eps)` forward (R1 on the card); the backward
    recomputes `rmsnorm_torch` under autograd and returns its gradient.
    The forward is an argument so that the backward runs on the CPU too."""

    @staticmethod
    def forward(ctx, x, gamma, eps: float, forward_impl: Callable = None):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return (forward_impl or rmsnorm_cuda)(x, gamma, eps)

    @staticmethod
    def backward(ctx, d_out):
        x, gamma = ctx.saved_tensors
        want = ctx.needs_input_grad[:2]
        x = x.detach().requires_grad_(want[0])
        gamma = gamma.detach().requires_grad_(want[1])
        inputs = [t for t, w in zip((x, gamma), want) if w]
        with torch.enable_grad():
            got = iter(torch.autograd.grad(rmsnorm_torch(x, gamma, ctx.eps), inputs, d_out))
        return (next(got) if want[0] else None), (next(got) if want[1] else None), None, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """rmsnorm over x's last dim: the plain version on CPU and meta tensors,
    R1 on CUDA tensors (gradients by recompute)."""
    if x.device.type in ("cpu", "meta"):
        return rmsnorm_torch(x, gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda, cpu or meta tensors, got {x.device}")
    return _RMSNorm.apply(x, gamma, eps)

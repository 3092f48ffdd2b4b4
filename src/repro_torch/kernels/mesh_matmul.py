"""Mesh-array GEMM: the CUDA kernel K1 behind one wrapper, plus its plain version.

Port of `repro.kernels.mesh_matmul` (`mesh_matmul_pallas`,
`mesh_matmul_pallas_batched`).  `mesh_matmul` computes, per batch element,

    C = act(A @ B + bias) + residual     (f32 accumulator, fused epilogue)

on the logical blocks (block_m, block_n, block_k): cell (i, j) walks its k
blocks in the staggered order (i + j + k) mod nk, and with `scramble_out`
computes standard block sigma(i, j) (bias column and residual block follow
it) so the output lands in the paper's scrambled arrangement.

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/mesh_matmul.cu`, see its header for the design) with the tile that
`tile_config` picks from the shapes, blocks and dtype, or raises; on a CPU
tensor it runs `mesh_matmul_torch`, the plain version, which repeats the
kernel's arithmetic block by block.  `mesh_matmul.launches` counts kernel
launches, `mesh_matmul.launches_by_config` the same launches per tile.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.scramble import _scramble_perm_np
from repro_torch.kernels import _build

__all__ = [
    "ACTIVATIONS",
    "GELU_A",
    "GELU_C",
    "TILE_CONFIGS",
    "TILE_SMEM_BYTES",
    "kernel_n",
    "mesh_matmul",
    "mesh_matmul_torch",
    "sigma_block_table",
    "tile_config",
]

# Epilogue activations, f32 in, f32 out; the tanh GELU (the reference's
# `jax.nn.gelu(approximate=True)` form, mesh_matmul.py:71-82).
GELU_C = 0.7978845608028654  # sqrt(2/pi)
GELU_A = 0.044715

ACTIVATIONS = {
    None: lambda x: x,
    "none": lambda x: x,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "silu": lambda x: x * torch.sigmoid(x),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + GELU_A * x * x * x))),
}
# Activation codes of csrc/mesh_matmul.cu (enum Act).
_ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "sigmoid": 3, "tanh": 4, "gelu": 5}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's decode tiles serve products up to this many rows.
_DECODE_ROWS = 16
# Tile configurations of csrc/mesh_matmul.cu (enum Config), by code.
TILE_CONFIGS = ("simt64", "simt_decode", "tc128", "f32_128", "tc_decode")
# Shared memory one CTA of each tile takes, in bytes (csrc/mesh_matmul.cu):
# the first SIMT tiles' static f32 tiles As[TK][TM + 1] and Bs[TK][TN]; tc128
# 4 stages of a 128x40 A and a 32x136 B bf16 tile; f32_128 two stages of a
# 16x132 A and a 16x128 B f32 tile; tc_decode 8 warps' rings of 4 stages of
# a 16x40 A and a 32x40 B bf16 tile.
TILE_SMEM_BYTES = {"simt64": 8256, "simt_decode": 20992, "tc128": 75776,
                   "f32_128": 33280, "tc_decode": 122880}


def tile_config(m: int, n: int, k: int, block_m: int, block_n: int, block_k: int,
                dtype: torch.dtype) -> str:
    """The kernel's tile for an (M, K) @ (K, N) product of `dtype` operands on
    (block_m, block_n, block_k) logical blocks.

    The new families copy 16-byte row chunks and never let a k step cross a
    logical block, so they need N, K and block_n in whole chunks and block_k
    a multiple of their k step (32 for the tensor-core tiles, 16 for the f32
    tile); the 128-wide tiles also need blocks at least 64 wide, the decode
    tile 16.  Everything else takes the first SIMT tiles.
    """
    if dtype == torch.bfloat16 and n % 8 == 0 and k % 8 == 0 and block_n % 8 == 0 \
            and block_k % 32 == 0:
        if m <= _DECODE_ROWS and block_n >= 16:
            return "tc_decode"
        if m > _DECODE_ROWS and min(block_m, block_n) >= 64:
            return "tc128"
    if dtype == torch.float32 and n % 4 == 0 and k % 4 == 0 and block_n % 4 == 0 \
            and block_k % 16 == 0 and min(block_m, block_n) >= 64:
        return "f32_128"
    return "simt_decode" if m <= _DECODE_ROWS else "simt64"


def kernel_n(n: int, block_n: int, dtype: torch.dtype, scramble_out: bool = False) -> int:
    """The N the kernel runs for a product of N columns.  The tensor-core and
    f32 tiles copy 16-byte row chunks of B, so the wrapper runs a ragged N
    (the shared-expert gate's N = 1) on zero weight columns, with zero bias
    and residual, and slices them off the output.  The padding stays inside
    the last logical block (block_n is whole chunks), so every cell keeps
    its k order; a scrambled output is block-aligned already."""
    chunk = 16 // dtype.itemsize
    if n % chunk and block_n % chunk == 0 and not scramble_out:
        return n + (-n) % chunk
    return n


@functools.lru_cache(maxsize=None)
def sigma_block_table(g: int) -> np.ndarray:
    """Flat standard block index (p*g + q) held at each mesh cell, row-major
    over cells — the table the kernel's scramble_out mode reads."""
    return _scramble_perm_np(g).astype(np.int32)


def _check(a, b, bias, residual, block_m, block_n, block_k, scramble_out, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"activation must be one of {sorted(k for k in ACTIVATIONS if k)},"
            f" got {activation!r}"
        )
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"blocks must be positive, got {(block_m, block_n, block_k)}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"operands must be both 2D or both 3D, got {a.shape} @ {b.shape}")
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    m, n = a.shape[-2], b.shape[-1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must have shape ({n},), got {tuple(bias.shape)}")
    want_res = tuple(a.shape[:-2]) + (m, n)
    if residual is not None and tuple(residual.shape) != want_res:
        raise ValueError(f"residual must have shape {want_res}, got {tuple(residual.shape)}")
    if scramble_out:
        if m % block_m or n % block_n:
            raise ValueError(
                f"scramble_out needs block-aligned M and N (got M={m}, N={n} with"
                f" blocks {block_m}x{block_n})"
            )
        if m // block_m != n // block_n:
            raise ValueError(
                f"scramble_out needs square block grid, got {m // block_m}x{n // block_n}"
            )


def _pad_to(x: torch.Tensor, multiple: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - (axis % x.dim())) + 1] = pad
    return torch.nn.functional.pad(x, widths)


def mesh_matmul_torch(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    stagger: bool = True,
    scramble_out: bool = False,
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version of K1: the same blocks, k order and epilogue in torch.

    Operands are zero-padded to block multiples (as the reference's `_mm_impl`
    does), upcast to f32, and every output cell accumulates the f32 product of
    one (block_m, block_k) x (block_k, block_n) block pair per k step in its
    staggered order; cells of one block row run as one batched product.  Rows
    never mix, so a row's result does not depend on how many rows the call
    has once M fits one block.
    """
    _check(a, b, bias, residual, block_m, block_n, block_k, scramble_out, activation)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    batched = a.dim() == 3
    a3 = a if batched else a[None]
    b3 = b if batched else b[None]
    r3 = None if residual is None else (residual if batched else residual[None])
    nb, m, k = a3.shape
    n = b3.shape[-1]
    bm, bn, bk = block_m, block_n, block_k
    nm, nn, nk = -(-m // bm), -(-n // bn), -(-k // bk)

    ap = _pad_to(_pad_to(a3, bm, 1), bk, 2).float()
    bp = _pad_to(_pad_to(b3, bk, 1), bn, 2).float()
    blocks_a = ap.reshape(nb, nm, bm, nk, bk).permute(0, 1, 3, 2, 4)  # (nb,nm,nk,bm,bk)
    blocks_b = bp.reshape(nb, nk, bk, nn, bn).permute(0, 1, 3, 2, 4)  # (nb,nk,nn,bk,bn)

    jj = torch.arange(nn, device=a.device)
    if scramble_out:
        flat = torch.as_tensor(sigma_block_table(nm), dtype=torch.long, device=a.device)
        p_of = (flat // nm).reshape(nm, nn)
        q_of = (flat % nm).reshape(nm, nn)
    else:
        p_of = torch.arange(nm, device=a.device)[:, None].expand(nm, nn)
        q_of = jj[None, :].expand(nm, nn)

    bias_blk = None
    if bias is not None:
        bias_blk = _pad_to(bias.float(), bn, 0).reshape(nn, bn)
    res_blk = None
    if r3 is not None:
        rp = _pad_to(_pad_to(r3.float(), bm, 1), bn, 2)
        res_blk = rp.reshape(nb, nm, bm, nn, bn).permute(0, 1, 3, 2, 4)  # (nb,nm,nn,bm,bn)

    act = ACTIVATIONS[activation]
    rows = []
    for i in range(nm):
        p, q = p_of[i], q_of[i]  # (nn,) standard block of each cell in row i
        acc = torch.zeros(nb, nn, bm, bn, dtype=torch.float32, device=a.device)
        for step in range(nk):
            kb = (i + jj + step) % nk if stagger else torch.full_like(jj, step)
            acc = acc + torch.matmul(blocks_a[:, p, kb], blocks_b[:, kb, q])
        if bias_blk is not None:
            acc = acc + bias_blk[q][None, :, None, :]
        acc = act(acc)
        if res_blk is not None:
            acc = acc + res_blk[:, p, q]
        rows.append(acc)
    out = torch.stack(rows, dim=1)  # (nb, nm, nn, bm, bn), cell-ordered
    out = out.permute(0, 1, 3, 2, 4).reshape(nb, nm * bm, nn * bn)[:, :m, :n]
    out = out.to(out_dtype)
    return out if batched else out[0]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it that starts on 16 bytes: the kernel reads
    operands in 16-byte chunks and the epilogue operands in pairs."""
    return t.clone() if t.data_ptr() % 16 else t


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("mesh_matmul").mesh_matmul_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [ptr] * 6 + [i32] * 8 + [i64] * 4 + [i32] * 5 + [ptr]
    fn.restype = i32
    return fn


def _error_string(err: int) -> str:
    fn = _build.library("mesh_matmul").mesh_matmul_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def mesh_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    stagger: bool = True,
    scramble_out: bool = False,
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    sigma: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C = epilogue(A @ B) on the mesh-array schedule; 2D or batched 3D.

    a: (M, K) @ b: (K, N), or a: (B, M, K) @ b: (B, K, N) with bias (N,)
    shared across the batch and residual (B, M, N).  Shapes need not divide
    the blocks, except that `scramble_out` needs a square, block-aligned
    output grid.  `sigma` is the plan's device copy of
    `sigma_block_table(g)`; without it the table is uploaded per call.
    CPU tensors run `mesh_matmul_torch`; CUDA tensors launch the kernel on
    `tile_config`'s tile for `kernel_n`'s N.
    """
    if a.device.type == "cpu":
        return mesh_matmul_torch(
            a, b, bias=bias, residual=residual, block_m=block_m, block_n=block_n,
            block_k=block_k, stagger=stagger, scramble_out=scramble_out,
            activation=activation, out_dtype=out_dtype,
        )
    out, config = _launch(
        a, b, bias=bias, residual=residual, block_m=block_m, block_n=block_n,
        block_k=block_k, stagger=stagger, scramble_out=scramble_out,
        activation=activation, out_dtype=out_dtype, sigma=sigma,
    )
    if config is not None:
        mesh_matmul.launches += 1
        mesh_matmul.launches_by_config[config] = mesh_matmul.launches_by_config.get(config, 0) + 1
    return out


mesh_matmul.launches = 0
mesh_matmul.launches_by_config = {}


def _launch(a, b, *, bias, residual, block_m, block_n, block_k, stagger, scramble_out,
            activation, out_dtype, sigma):
    """Launch K1 on CUDA tensors, uncounted: returns (out, tile config), the
    config None when the output is empty and nothing launched.  The
    wrapper counts its launches; the autotuner times candidates here, so
    the counts stay the products callers asked for."""
    if a.device.type != "cuda":
        raise ValueError(f"mesh_matmul runs on cuda or cpu tensors, got {a.device}")
    _check(a, b, bias, residual, block_m, block_n, block_k, scramble_out, activation)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(
            f"mesh_matmul kernel takes float32 or bfloat16 operands of one type and"
            f" output; got {a.dtype} @ {b.dtype} -> {out_dtype}"
        )
    operands = [b] + [t for t in (bias, residual, sigma) if t is not None]
    if any(t.device != a.device for t in operands):
        raise ValueError("mesh_matmul operands must be on one device")
    n = b.shape[-1]
    if kernel_n(n, block_n, a.dtype, scramble_out) != n:
        def pad(t):
            return None if t is None else _pad_to(t, 16 // a.element_size(), -1)

        out, config = _launch(
            a, pad(b), bias=pad(bias), residual=pad(residual), block_m=block_m,
            block_n=block_n, block_k=block_k, stagger=stagger, scramble_out=False,
            activation=activation, out_dtype=out_dtype, sigma=None,
        )
        return out[..., :n].contiguous(), config
    batched = a.dim() == 3
    nb = a.shape[0] if batched else 1
    m, k = a.shape[-2], a.shape[-1]
    out = torch.empty(*a.shape[:-2], m, n, dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out, None
    if max(m, n, k) >= 2**31 or math.prod(a.shape[:-2]) > 65535:
        raise ValueError(f"shape {tuple(a.shape)} @ {tuple(b.shape)} exceeds the kernel's grid")
    config = tile_config(m, n, k, block_m, block_n, block_k, a.dtype)
    a = _aligned(a.contiguous())
    b = _aligned(b.contiguous())
    # Epilogue operands travel as f32 (an exact upcast of bf16): the kernel
    # adds them to the f32 accumulator as the reference does.
    bias_f = None if bias is None else _aligned(bias.to(torch.float32).contiguous())
    res_f = None if residual is None else _aligned(residual.to(torch.float32).contiguous())
    g = m // block_m if scramble_out else 0
    if scramble_out and sigma is None:
        sigma = torch.as_tensor(sigma_block_table(g), device=a.device)
    if scramble_out and (sigma.dtype != torch.int32 or sigma.numel() != g * g):
        raise ValueError(f"sigma must be the int32 ({g * g},) table for a {g}x{g} grid")

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel()(
        a.data_ptr(), b.data_ptr(), ptr(bias_f), ptr(res_f), out.data_ptr(),
        ptr(sigma if scramble_out else None),
        nb, m, n, k, block_m, block_n, block_k, g,
        m * k if batched else 0, k * n if batched else 0,
        m * n if batched else 0, m * n if batched else 0,
        int(stagger), _ACT_CODES[activation], _DTYPE_CODES[a.dtype],
        _DTYPE_CODES[out_dtype], TILE_CONFIGS.index(config),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mesh_matmul kernel launch failed ({config}): {_error_string(err)}")
    return out, config

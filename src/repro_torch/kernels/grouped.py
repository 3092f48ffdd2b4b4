"""Grouped (ragged-batch) mesh GEMM: the CUDA kernel K5 behind one wrapper,
plus its plain version.

Port of `repro.kernels.grouped` (`grouped_mesh_matmul_pallas`).  Tokens
arrive group-major in the MoE capacity layout: a (G * rpg, K) buffer in which
group g owns rows [g * rpg, g * rpg + sizes[g]).  `grouped_mesh_matmul`
computes, for every row r of group g = r // rpg,

    out[r] = act(tokens[r] @ weights[g] + bias[g]) + residual[r]

with an f32 accumulator over the logical blocks (block_m, block_n, block_k),
cell (g, i, j) walking its k blocks in the staggered order
(g + i + j + k) mod nk, and rows at or past their group's size written as
exact zeros.  rpg must divide by block_m; K and N need not divide their
blocks.

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/grouped_matmul.cu`, see its header for the design) on the tile
`tile_config` picks, or raises; on a CPU tensor it runs
`grouped_mesh_matmul_torch`, the plain version, which repeats the kernel's
arithmetic block by block.  `grouped_mesh_matmul.launches` counts kernel
launches, `grouped_mesh_matmul.launches_by_config` the launches per tile.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mesh_matmul import (
    _ACT_CODES,
    _DTYPE_CODES,
    ACTIVATIONS,
    _aligned,
    _pad_to,
)

__all__ = ["TILE_CONFIGS", "grouped_mesh_matmul", "grouped_mesh_matmul_torch", "tile_config"]

# The kernel's decode tiles serve logical blocks up to this many rows.
_DECODE_ROWS = 16
# Tile configurations of csrc/grouped_matmul.cu (enum Config), by code.
TILE_CONFIGS = ("simt64", "simt_decode", "tc_rows32", "tc_decode")


def tile_config(n: int, k: int, block_m: int, block_n: int, block_k: int,
                dtype: torch.dtype) -> str:
    """The kernel's tile for (G * rpg, K) tokens of `dtype` against (G, K, N)
    weights on (block_m, block_n, block_k) logical blocks.

    The tensor-core tiles copy 16-byte row chunks and never let a 32-deep k
    step cross a logical block, so they need N, K and block_n in whole
    chunks and block_k a multiple of 32; the prefill row tile (128 columns)
    also needs block_n at least 64, the decode tile (32 columns) 16.
    Everything else, f32 operands included (the `_gmm` backward), takes the
    SIMT tiles.
    """
    if dtype == torch.bfloat16 and n % 8 == 0 and k % 8 == 0 and block_n % 8 == 0 \
            and block_k % 32 == 0:
        if block_m <= _DECODE_ROWS and block_n >= 16:
            return "tc_decode"
        if block_m > _DECODE_ROWS and block_n >= 64:
            return "tc_rows32"
    return "simt_decode" if block_m <= _DECODE_ROWS else "simt64"


def _check(tokens, sizes, weights, bias, residual, block_m, block_n, block_k, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"activation must be one of {sorted(k for k in ACTIVATIONS if k)},"
            f" got {activation!r}"
        )
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"blocks must be positive, got {(block_m, block_n, block_k)}")
    if tokens.dim() != 2 or weights.dim() != 3:
        raise ValueError(
            f"grouped operands are (G*rpg, K) tokens and (G, K, N) weights, got"
            f" {tuple(tokens.shape)} / {tuple(weights.shape)}"
        )
    rows, k = tokens.shape
    groups, k2, n = weights.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(tokens.shape)} @ {tuple(weights.shape)}")
    if rows % groups:
        raise ValueError(
            f"rows={rows} not divisible by num_groups={groups}"
            " (capacity layout requires equal static per-group bounds)"
        )
    if (rows // groups) % block_m:
        raise ValueError(f"rows_per_group={rows // groups} not divisible by block_m={block_m}")
    if tuple(sizes.shape) != (groups,) or sizes.dtype.is_floating_point:
        raise ValueError(f"sizes must be an integer ({groups},) tensor, got {sizes.dtype}"
                         f" {tuple(sizes.shape)}")
    if bias is not None and tuple(bias.shape) != (groups, n):
        raise ValueError(f"grouped bias must have shape ({groups}, {n}), got {tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (rows, n):
        raise ValueError(f"residual must have shape ({rows}, {n}), got {tuple(residual.shape)}")


def grouped_mesh_matmul_torch(
    tokens: torch.Tensor,
    sizes: torch.Tensor,
    weights: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    stagger: bool = True,
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version of K5: the same blocks, k order, epilogue and mask.

    K and N are zero-padded to block multiples, operands upcast to f32, and
    every cell (g, i, j) accumulates the f32 product of one block pair per k
    step in its staggered order; the cells of one block row of every group
    run as one batched product.  The epilogue runs on the f32 accumulator,
    then rows past each group's size are set to 0 (a select, so whatever the
    padding rows hold never reaches the output) and the result is cast.
    """
    _check(tokens, sizes, weights, bias, residual, block_m, block_n, block_k, activation)
    out_dtype = out_dtype or torch.promote_types(tokens.dtype, weights.dtype)
    rows = tokens.shape[0]
    groups, k, n = weights.shape
    rpg = rows // groups
    bm, bn, bk = block_m, block_n, block_k
    nm, nn, nk = rpg // bm, -(-n // bn), -(-k // bk)
    dev = tokens.device

    tp = _pad_to(tokens, bk, 1).float()
    wp = _pad_to(_pad_to(weights, bk, 1), bn, 2).float()
    blocks_a = tp.reshape(groups, nm, bm, nk, bk).permute(0, 1, 3, 2, 4)  # (G,nm,nk,bm,bk)
    blocks_b = wp.reshape(groups, nk, bk, nn, bn).permute(0, 1, 3, 2, 4)  # (G,nk,nn,bk,bn)
    gg = torch.arange(groups, device=dev)[:, None]
    jj = torch.arange(nn, device=dev)[None, :]
    bias_blk = None
    if bias is not None:
        bias_blk = _pad_to(bias.float(), bn, 1).reshape(groups, nn, 1, bn)
    res_blk = None
    if residual is not None:
        rp = _pad_to(residual.float(), bn, 1)
        res_blk = rp.reshape(groups, nm, bm, nn, bn).permute(0, 1, 3, 2, 4)  # (G,nm,nn,bm,bn)

    act = ACTIVATIONS[activation]
    out_rows = []
    for i in range(nm):
        acc = torch.zeros(groups, nn, bm, bn, dtype=torch.float32, device=dev)
        for step in range(nk):
            kb = (gg + i + jj + step) % nk if stagger else torch.full_like(gg + jj, step)
            acc = acc + torch.matmul(blocks_a[gg, i, kb], blocks_b[gg, kb, jj])
        if bias_blk is not None:
            acc = acc + bias_blk
        acc = act(acc)
        if res_blk is not None:
            acc = acc + res_blk[:, i]
        out_rows.append(acc)
    out = torch.stack(out_rows, dim=1)  # (G, nm, nn, bm, bn), cell-ordered
    out = out.permute(0, 1, 3, 2, 4).reshape(groups, rpg, nn * bn)[:, :, :n]
    valid = torch.arange(rpg, device=dev)[None, :] < sizes.to(dev)[:, None]
    out = torch.where(valid[..., None], out, 0.0)
    return out.reshape(rows, n).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("grouped_matmul").grouped_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = _build.library("grouped_matmul").grouped_matmul_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def grouped_mesh_matmul(
    tokens: torch.Tensor,
    sizes: torch.Tensor,
    weights: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    stagger: bool = True,
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out[r] = epilogue(tokens[r] @ weights[r // rpg]); zero past each
    group's size.  tokens (G*rpg, K), sizes (G,) integer, weights (G, K, N),
    bias (G, N), residual (G*rpg, N).  CPU tensors run
    `grouped_mesh_matmul_torch`; CUDA tensors launch the kernel on
    `tile_config`'s tile, which reads `sizes` on the device (no host
    sync)."""
    if tokens.device.type == "cpu":
        return grouped_mesh_matmul_torch(
            tokens, sizes, weights, bias=bias, residual=residual, block_m=block_m,
            block_n=block_n, block_k=block_k, stagger=stagger, activation=activation,
            out_dtype=out_dtype,
        )
    if tokens.device.type != "cuda":
        raise ValueError(f"grouped_mesh_matmul runs on cuda or cpu tensors, got {tokens.device}")
    _check(tokens, sizes, weights, bias, residual, block_m, block_n, block_k, activation)
    out_dtype = out_dtype or torch.promote_types(tokens.dtype, weights.dtype)
    if (tokens.dtype != weights.dtype or tokens.dtype not in _DTYPE_CODES
            or out_dtype not in _DTYPE_CODES):
        raise TypeError(
            "grouped_mesh_matmul kernel takes float32 or bfloat16 operands of one type and"
            f" output; got {tokens.dtype} @ {weights.dtype} -> {out_dtype}"
        )
    operands = [weights, sizes] + [t for t in (bias, residual) if t is not None]
    if any(t.device != tokens.device for t in operands):
        raise ValueError("grouped_mesh_matmul operands must be on one device")
    rows, k = tokens.shape
    groups, _, n = weights.shape
    out = torch.empty(rows, n, dtype=out_dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    if max(rows, n, k) >= 2**31 or groups > 65535 or rows // groups // block_m > 65535:
        raise ValueError(f"shape {tuple(tokens.shape)} @ {tuple(weights.shape)} exceeds the"
                         " kernel's grid")
    config = tile_config(n, k, block_m, block_n, block_k, tokens.dtype)
    tokens = _aligned(tokens.contiguous())
    weights = _aligned(weights.contiguous())
    sizes = sizes.to(torch.int32).contiguous()
    # Epilogue operands travel as f32 (an exact upcast of bf16): the kernel
    # adds them to the f32 accumulator as the reference does.
    bias_f = None if bias is None else bias.to(torch.float32).contiguous()
    res_f = None if residual is None else residual.to(torch.float32).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel()(
        tokens.data_ptr(), weights.data_ptr(), sizes.data_ptr(), ptr(bias_f), ptr(res_f),
        out.data_ptr(), groups, rows // groups, n, k, block_m, block_n, block_k,
        int(stagger), _ACT_CODES[activation], _DTYPE_CODES[tokens.dtype],
        _DTYPE_CODES[out_dtype], TILE_CONFIGS.index(config),
        torch.cuda.current_stream(tokens.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"grouped_mesh_matmul kernel launch failed ({config}): {_error_string(err)}"
        )
    grouped_mesh_matmul.launches += 1
    by_config = grouped_mesh_matmul.launches_by_config
    by_config[config] = by_config.get(config, 0) + 1
    return out


grouped_mesh_matmul.launches = 0
grouped_mesh_matmul.launches_by_config = {}

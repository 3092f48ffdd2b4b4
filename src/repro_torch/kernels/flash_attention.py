"""Flash attention (tiled online-softmax SDPA): the CUDA kernel K6 behind one
wrapper, plus its plain version.

Port of `repro.kernels.flash_attention` (`flash_attention_pallas`), the
HBM-optimal form of the chunked attention path (`models.attention.
_sdpa_chunked`): grouped-query SDPA, causal or full, that reads Q, K and V
once and writes O once, never holding a (Tq, Tk) score matrix.  Layout and
contract are the reference's:

  q    (B, Tq, H, hd)     H = KV * rep query heads
  k, v (B, Tk, KV, hd)
  out  (B, Tq, H, hd)     in q's type

`Tq * rep % block_q` and `Tk % block_k` must be 0 (ValueError otherwise).
The causal mask is the reference's, top-left aligned: query token t sees
keys 0..t + q_offset, so Tq and Tk may differ.  `q_offset` (default 0, the
reference's kernel) is where a context-parallel rank's query rows start in
the sequence: a rank holding tokens [o, o + Tq) attends them to keys
[0, o + Tq) with q_offset = o (`models.attention`, the 'seq_attn' rule).

On a CUDA tensor `flash_attention` launches the hand-written kernel
(`csrc/flash_attention.cu`, see its header for the design: bf16 on the
tensor cores, f32 on the FMA units) or raises; on a CPU tensor it runs
`flash_attention_torch`, the plain version: `_sdpa_chunked` (defined here,
the reference's `models.attention._sdpa_chunked` op for op) with chunk =
block_k.  K6 computes the same function and rounds where it does (f32
scores times hd**-0.5, probabilities rounded to the input type before the V
product, acc / l cast back); it walks the keys in its own 64-key tiles, so
it agrees with the plain version to rounding, not bit for bit.
`flash_attention.launches` counts kernel launches.

The Pallas kernel has no VJP: the reference differentiates the chunked
path by autodiff of `_sdpa_chunked`.  So on the card K6 runs inside
`_FlashAttention`, whose backward recomputes `_sdpa_chunked` in torch ops
and returns autograd's gradient of it, as `jax.checkpoint` recomputes its
scan body (a kernel launched through ctypes is invisible to autograd).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_torch"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128  # csrc/flash_attention.cu: kMaxHeadDim
# Head dims the kernels take: bf16 in whole 16-deep mma steps, f32 spread
# over 8 lanes of 16-byte loads.
_HEAD_DIM_STEP = {torch.bfloat16: 16, torch.float32: 8}


def _check(q, k, v, causal, block_q, block_k, q_offset=0):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention takes q (B, Tq, H, hd) and k, v (B, Tk, KV, hd), got"
            f" {tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}"
        )
    b, tq, h, hd = q.shape
    b2, tk, kvh, hd2 = k.shape
    if b != b2 or hd != hd2 or kvh == 0 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not group over k {tuple(k.shape)}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int, got {q_offset!r}")
    rows = tq * (h // kvh)
    if block_q < 1 or block_k < 1 or rows % block_q or tk % block_k:
        raise ValueError(
            f"(Tq*rep={rows}, Tk={tk}) not divisible by blocks ({block_q},{block_k})"
        )


def _sdpa_chunked(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool,
    chunk: int,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash-style attention: online softmax over KV chunks.

    Op for op the reference's `_sdpa_chunked`: per chunk, f32 scores of
    f32-upcast operands times hd**-0.5, the -1e30 causal where-mask, the
    (m, l, acc) recurrence in f32, probabilities cast to q's type before the
    V contraction (whose result is in q's type, as the reference's einsum
    gives), and acc / l cast back.  The reference's `lax.scan` is a Python
    loop; autograd differentiates it as `jax.grad` does the scan.  With
    `q_offset`, query token t is token t + q_offset of the sequence for the
    causal mask, as in `models.attention._sdpa` (the reference's chunked
    form has no offset; at 0 this is it).
    """
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    if tk % chunk:
        raise ValueError(f"Tk={tk} not divisible by chunk={chunk}")
    q5 = q.reshape(b, tq, kvh, rep, hd).float()
    scale = hd**-0.5
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset  # (Tq, 1)

    m = torch.full((b, kvh, rep, tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, rep, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, tq, kvh, rep, hd), dtype=torch.float32, device=q.device)
    for j in range(tk // chunk):
        kj = k[:, j * chunk : (j + 1) * chunk]
        vj = v[:, j * chunk : (j + 1) * chunk]
        s = torch.einsum("btkrd,bskd->bkrts", q5, kj.float()) * scale  # (B,KV,rep,Tq,C)
        if causal:
            kpos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
            s = torch.where((kpos <= qpos)[None, None, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkrts,bskd->btkrd", p.to(q.dtype), vj)
        acc = acc * corr.movedim(-1, 1)[..., None] + pv
        m = m_new
    out = acc / l.movedim(-1, 1)[..., None]
    return out.reshape(b, tq, h, hd).to(q.dtype)


def flash_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """The plain version of K6: `_sdpa_chunked` over chunks of block_k keys."""
    _check(q, k, v, causal, block_q, block_k, q_offset)
    return _sdpa_chunked(q, k, v, causal=causal, chunk=block_k, q_offset=q_offset)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = _build.library("flash_attention").flash_attention_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernel loads 16 bytes
    at a time)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch K6 on CUDA tensors (no fallback: a refused launch raises):
    bf16 runs the tensor-core kernel, f32 the SIMT kernel.  Shapes as
    `flash_attention`; no gradient (see `_FlashAttention`)."""
    _check(q, k, v, causal, 1, 1, q_offset)
    if any(t.device.type != "cuda" or t.device != q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention kernel takes float32 or bfloat16 q, k, v of one type, got"
            f" {q.dtype}/{k.dtype}/{v.dtype}"
        )
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    step = _HEAD_DIM_STEP[q.dtype]
    if hd > _MAX_HEAD_DIM or hd % step:
        raise ValueError(f"flash attention kernel takes {q.dtype} head_dim <= {_MAX_HEAD_DIM}"
                         f" and a multiple of {step}, got {hd}")
    if b * kvh > 65535 or tq * h >= 2**31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0 or tk == 0:
        return out.zero_()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq, tk, kvh, hd,
        h // kvh, int(causal), q_offset, hd**-0.5, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {_error_string(err)}")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """`forward_impl(q, k, v, causal)` forward (with `q_offset` bound in
    it); the backward recomputes the chunked recurrence (`_sdpa_chunked`,
    chunk `chunk`, the same `q_offset`) under autograd and returns its
    gradient — the reference's autodiff of the same function.  The forward
    is an argument so that the backward runs on the CPU too."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int, forward_impl: Callable,
                q_offset: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk, ctx.q_offset = causal, chunk, q_offset
        return forward_impl(q, k, v, causal)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _sdpa_chunked(q, k, v, causal=ctx.causal, chunk=ctx.chunk,
                                q_offset=ctx.q_offset)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), d_out)
        return dq, dk, dv, None, None, None, None


def _launch(q, k, v, causal, q_offset=0):
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """SDPA with traffic Q + K + V + O: CPU tensors run
    `flash_attention_torch`; CUDA tensors launch K6 inside `_FlashAttention`
    (gradients by recompute).  Meta tensors (the dry runs' trace,
    `launch/dryrun.py`) take the card's structure, `_FlashAttention` saving
    only q, k and v, with the plain chunked forward in the kernel's place."""
    _check(q, k, v, causal, block_q, block_k, q_offset)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, block_q=block_q, block_k=block_k,
                                     q_offset=q_offset)
    if q.device.type == "meta":
        forward = functools.partial(_plain_forward, chunk=block_k, q_offset=q_offset)
    elif q.device.type == "cuda":
        forward = functools.partial(_launch, q_offset=q_offset)
    else:
        raise ValueError(f"flash_attention runs on cuda, cpu or meta tensors, got {q.device}")
    return _FlashAttention.apply(q, k, v, causal, block_k, forward, q_offset)


def _plain_forward(q, k, v, causal, chunk, q_offset=0):
    return _sdpa_chunked(q, k, v, causal=causal, chunk=chunk, q_offset=q_offset)


flash_attention.launches = 0

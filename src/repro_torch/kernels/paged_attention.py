"""Paged-KV gather attention for continuous-batching decode.

Port of `repro.kernels.paged_attention`.  Every sequence's KV cache lives in
fixed-size pages of one shared pool per layer, named by the sequence's block
table, and decode attention reads K/V through the table.  Two impls sit
behind a capability door (`resolve_paged_impl`):

  cuda_paged    the hand-written CUDA kernel K4 (`csrc/paged_attention.cu`,
                see its header for the design): split-context decoding, one
                CTA per (slot, kv head, run of `split_pages` pages) with an
                online softmax per warp, then a combine of the per-split
                partials; no gathered copy of the context is made.  The
                split is chosen by `split_plan` from the table width and the
                SM count, never from `lengths`.  CUDA tensors only.
  torch_gather  `pool[block_table]` gather + masked softmax, op for op the
                reference's `paged_attention_xla` (and the port's
                `models.attention._sdpa`), so decode through pages equals
                decode against the dense cache **bitwise** on the same
                device.  Runs on any device; the plain version K4 is held
                against.

With no request the door resolves by the tensors' device: CUDA gives
`cuda_paged`, the CPU gives `torch_gather`.  Asking for `cuda_paged` with CPU
tensors raises `CapabilityError`, never a silent substitution.

Layout contract (single decode token per sequence slot):

  q             (S, H, hd)              one query token per slot
  k_pool/v_pool (P, page_size, KV, hd)  shared pools; page 0 is the
                                        scheduler's scratch page
  block_tables  (S, n_pages) int32      page ids per slot; unallocated -> 0
  lengths       (S,) int32              valid length INCLUDING the freshly
                                        written token (= pos + 1)
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.api import CapabilityError

__all__ = [
    "PAGED_ORDER",
    "gather_pages",
    "paged_attention",
    "paged_attention_cuda",
    "paged_attention_torch",
    "paged_impl_names",
    "register_paged_impl",
    "rep_chunks",
    "resolve_paged_impl",
    "split_plan",
]

_NEG_INF = -1e30
_MAX_REP = 8  # csrc/paged_attention.cu: kMaxRep, the most query rows of one split kernel
_MAX_HEAD_DIM = 128  # csrc/paged_attention.cu: kMaxHeadDim (one row per <= 32 lanes)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The split: at least one page per warp of a CTA, at most the kernel's
# shared block-table slice (kMaxSplitPages), and about this many CTAs per SM.
_MIN_SPLIT_PAGES = 4
_MAX_SPLIT_PAGES = 64
_CTAS_PER_SM = 4
# The combine keeps each split's (m, l) in shared memory, beside its own 8
# bytes (den_s, live_s): at most 48 KiB in all, so 6143 splits.
_MAX_SPLITS = (48 * 1024 - 8) // 8


def split_plan(n_pages: int, pairs: int, sm_count: int) -> tuple:
    """(split_pages, n_splits) of K4's grid for a block table `n_pages`
    wide and `pairs` = slots x kv heads: enough splits for about
    `_CTAS_PER_SM` CTAs on each of `sm_count` SMs, each split covering
    between `_MIN_SPLIT_PAGES` and `_MAX_SPLIT_PAGES` pages.  A function of
    shapes the host holds, so choosing it never waits for the device."""
    n_pages = max(1, n_pages)
    want = -(-_CTAS_PER_SM * sm_count // max(1, pairs))
    split_pages = -(-n_pages // want)
    split_pages = min(_MAX_SPLIT_PAGES, max(_MIN_SPLIT_PAGES, split_pages))
    return split_pages, -(-n_pages // split_pages)


def rep_chunks(rep: int) -> tuple:
    """(first row, rows) of each split-kernel launch over a KV head's `rep`
    query rows: chunks of `_MAX_REP` rows, then the rest (rep 12 runs as 8 +
    4).  Together they cover every row once, in order."""
    return tuple((r0, min(_MAX_REP, rep - r0)) for r0 in range(0, rep, _MAX_REP))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, ps, KV, hd) pool + (S, n) tables -> (S, n*ps, KV, hd) context."""
    s, n = block_tables.shape
    _, ps, kvh, hd = pool.shape
    return pool[block_tables.long()].reshape(s, n * ps, kvh, hd)


def _check(q, k_pool, v_pool, block_tables, lengths):
    s, h, hd = q.shape
    _, _, kvh, hd2 = k_pool.shape
    if hd != hd2:
        raise ValueError(f"head_dim mismatch: q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k/v pool mismatch: {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != s or tuple(lengths.shape) != (s,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths {tuple(lengths.shape)}"
            f" do not match {s} slots"
        )
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")


def paged_attention_torch(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Gathered-context SDPA, op for op the reference's `paged_attention_xla`.

    Scores are f32 products of f32-upcast operands, divided by sqrt(hd),
    -1e30 where-masked past `lengths`, softmaxed in f32, cast to q's type and
    contracted with V — the exact op sequence of `models.attention._sdpa`,
    so pool rows past a length (scratch page, unwritten slots) mask to
    exp -> 0.0 and contribute nothing.
    """
    _check(q, k_pool, v_pool, block_tables, lengths)
    s, h, hd = q.shape
    k = gather_pages(k_pool, block_tables)
    v = gather_pages(v_pool, block_tables)
    kvh = k.shape[2]
    rep = h // kvh
    q5 = q.reshape(s, 1, kvh, rep, hd)
    scores = torch.einsum("btkrd,bskd->bkrts", q5.float(), k.float()) / (hd**0.5)
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrts,bskd->btkrd", probs, v)
    return out.reshape(s, h, hd)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("paged_attention").paged_attention_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 9 + [i32] * 6 + [ptr, ptr] + [i32] * 3 + [ctypes.c_float, i32, ptr]
    fn.restype = i32
    return fn


def _error_string(err: int) -> str:
    fn = _build.library("paged_attention").paged_attention_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def paged_attention_cuda(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Launch K4 on CUDA tensors (no fallback: a refused launch raises).
    `paged_attention_cuda.launches` counts calls: the split kernel (once per
    chunk of `rep_chunks`) and its combine are one call.  The split kernel's
    shared memory is fixed (the split's table slice, at most
    `_MAX_SPLIT_PAGES` pages, and one (m, l, acc) per warp); the combine's
    holds (m, l) per split and 8 bytes of its own, which bounds the table
    width at 6143 splits of 64 pages."""
    return _launch(q, k_pool, v_pool, block_tables, lengths)[0]


def _launch(q, k_pool, v_pool, block_tables, lengths):
    """`paged_attention_cuda`, returning besides the output the per-split
    partials the combine merged: m (log2 units, -1e30 for an empty split),
    l and the unnormalized acc; acc of an empty split is left unwritten."""
    _check(q, k_pool, v_pool, block_tables, lengths)
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise CapabilityError("impl 'cuda_paged' needs all operands on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"cuda_paged takes float32 or bfloat16 q and pools of one type, got"
            f" {q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    s, h, hd = q.shape
    _, ps, kvh, _ = k_pool.shape
    rep = h // kvh
    vec = 16 // q.element_size()  # elements of one 16-byte load
    if hd > _MAX_HEAD_DIM or hd % vec:
        raise ValueError(
            f"cuda_paged supports head_dim <= {_MAX_HEAD_DIM}, a multiple of {vec} for"
            f" {q.dtype}; got hd={hd}"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out, None, None, None
    q = q.contiguous()
    k_pool = k_pool.contiguous()
    v_pool = v_pool.contiguous()
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("cuda_paged reads the pools with 16-byte loads; they must be"
                         " 16-byte aligned")
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    n_pages = bt.shape[1]
    split_pages, n_splits = split_plan(n_pages, s * kvh, _sm_count(q.device.index or 0))
    if n_splits > _MAX_SPLITS:
        raise ValueError(f"a {n_pages}-page table needs {n_splits} splits; the combine holds"
                         f" (m, l) of at most {_MAX_SPLITS} in shared memory")
    # Per-split partials (m, l and the unnormalized acc), merged by the
    # kernel's combine launch on the same stream.
    part_m = torch.empty(s, kvh, n_splits, rep, dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(s, kvh, n_splits, rep, hd, dtype=torch.float32, device=q.device)
    chunks = rep_chunks(rep)
    chunk_r0 = (ctypes.c_int * len(chunks))(*(r0 for r0, _ in chunks))
    chunk_n = (ctypes.c_int * len(chunks))(*(n for _, n in chunks))
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
        ln.data_ptr(), out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), s, n_pages, ps, kvh, hd, rep, chunk_r0, chunk_n, len(chunks),
        split_pages, n_splits, hd**-0.5, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: {_error_string(err)}")
    paged_attention_cuda.launches += 1
    return out, part_m, part_l, part_acc


paged_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# Capability door
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _PagedImpl:
    name: str
    fn: Callable
    # Device types the impl executes on (the port's counterpart of the
    # reference's `interpret` capability).
    devices: frozenset


_PAGED_REGISTRY: Dict[str, _PagedImpl] = {}

# Preference order when no impl is requested: the kernel first, the
# always-runnable gather last.
PAGED_ORDER = ("cuda_paged", "torch_gather")


def register_paged_impl(
    name: str, fn: Callable, *, devices, override: bool = False
) -> None:
    if name in _PAGED_REGISTRY and not override:
        raise ValueError(f"paged impl {name!r} already registered (pass override=True)")
    _PAGED_REGISTRY[name] = _PagedImpl(name, fn, frozenset(devices))


def paged_impl_names() -> List[str]:
    return list(_PAGED_REGISTRY)


def resolve_paged_impl(requested: Optional[str] = None, *, device="cpu") -> str:
    """The capability door: the requested impl, or the first one that runs on
    `device`.  Requesting an impl that cannot run there raises
    `CapabilityError`."""
    dev = torch.device(device).type
    if requested is not None:
        impl = _PAGED_REGISTRY.get(requested)
        if impl is None:
            raise ValueError(
                f"unknown paged impl {requested!r}; registered: {sorted(_PAGED_REGISTRY)}"
            )
        if dev not in impl.devices:
            raise CapabilityError(
                f"impl {requested!r} runs on {sorted(impl.devices)} tensors, got {dev!r}"
            )
        return requested
    for name in (*PAGED_ORDER, *_PAGED_REGISTRY):
        impl = _PAGED_REGISTRY.get(name)
        if impl is not None and dev in impl.devices:
            return name
    raise CapabilityError(f"no registered paged-attention impl runs on {dev!r}")


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Dispatch through the door, resolved by `q`'s device."""
    name = resolve_paged_impl(impl, device=q.device)
    return _PAGED_REGISTRY[name].fn(q, k_pool, v_pool, block_tables, lengths)


register_paged_impl("cuda_paged", paged_attention_cuda, devices={"cuda"})
register_paged_impl("torch_gather", paged_attention_torch, devices={"cpu", "cuda"})

"""GQA attention with RoPE and a KV cache, dense or paged.

Port of `repro.models.attention`: full causal attention (training) and
prefill (which also returns the fresh cache), single-token decode against a
dense cache, and single-token decode against a paged KV pool
(`attention_paged_decode`, the continuous-batching path).  With
cfg.attn_chunk > 0, a cache-free call whose length is a multiple of the
chunk (and longer than one) takes the flash path: `kernels.flash_attention`,
kernel K6 on the card and `_sdpa_chunked` on the CPU, causal or not (the
Whisper encoder's full attention).  Cross-attention (`cross_kv`) projects
only the queries and attends, unrotated and unmasked, over keys and values
the caller computed.  Sharding constraints (the reference's 'seq_attn' rule
among them) arrive with their slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import PSpec, apply_rope, dense

__all__ = [
    "attn_specs",
    "attention",
    "attention_paged_decode",
    "init_cache_shape",
    "Cache",
]

Cache = Dict[str, torch.Tensor]  # {"k": (B, T, KV, hd), "v": (B, T, KV, hd)}

_NEG_INF = -1e30


def attn_specs(cfg, *, prefix_scale: float = 1.0) -> Dict[str, PSpec]:
    d, hd = cfg.d_model, cfg.head_dim_
    h, kv = cfg.num_heads, cfg.num_kv_heads
    out_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    specs = {
        "wq": PSpec((d, h * hd), ("embed", "heads"), 0.02 * prefix_scale),
        "wk": PSpec((d, kv * hd), ("embed", "kv_heads"), 0.02 * prefix_scale),
        "wv": PSpec((d, kv * hd), ("embed", "kv_heads"), 0.02 * prefix_scale),
        "wo": PSpec((h * hd, d), ("heads", "embed"), out_scale),
    }
    if cfg.qkv_bias:
        specs["bq"] = PSpec((h * hd,), ("heads",), init="zeros")
        specs["bk"] = PSpec((kv * hd,), ("kv_heads",), init="zeros")
        specs["bv"] = PSpec((kv * hd,), ("kv_heads",), init="zeros")
    return specs


def init_cache_shape(cfg, batch: int, max_len: int) -> Dict[str, Tuple[int, ...]]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim_
    return {"k": (batch, max_len, kv, hd), "v": (batch, max_len, kv, hd)}


def _sdpa(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: Union[torch.Tensor, int] = 0,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query SDPA with f32 softmax; no KV-head materialized repeat.

    Op for op the reference's `_sdpa`: f32 scores of f32-upcast operands
    (`preferred_element_type=f32`), divided by sqrt(hd), -1e30 where-masks,
    f32 softmax, probabilities cast to q's type before the V contraction.
    """
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    q5 = q.reshape(b, tq, kvh, rep, hd)
    scores = torch.einsum("btkrd,bskd->bkrts", q5.float(), k.float()) / (hd**0.5)
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset  # (Tq, 1)
        kpos = torch.arange(tk, device=q.device)[None, :]
        mask = kpos <= qpos  # (Tq, Tk)
        scores = torch.where(mask[None, None, None], scores, _NEG_INF)
    if kv_valid_len is not None:
        kv_valid_len = torch.as_tensor(kv_valid_len, device=q.device)
        valid = torch.arange(tk, device=q.device)[None, :] < kv_valid_len
        scores = torch.where(
            valid[:, None, None, None] if valid.dim() == 2 else valid[None, None, None],
            scores,
            _NEG_INF,
        )
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrts,bskd->btkrd", probs, v)
    return out.reshape(b, tq, h, hd)


def attention_paged_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (S, 1, D) — one new token per sequence slot
    cfg,
    *,
    k_pool: torch.Tensor,  # (P, page_size, KV, hd) shared page pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (S, n_pages) int32
    positions: torch.Tensor,  # (S,) int32 — each slot's current length
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode against a paged KV pool.

    The new K/V lands in page `block_tables[s, pos // page_size]` at in-page
    offset `pos % page_size`, then the slot attends over its pages through
    `kernels.paged_attention`.  Unlike the reference, which returns updated
    pools, the port writes the token into `k_pool`/`v_pool` IN PLACE (one
    row per slot instead of a pool-sized copy per layer and tick).  A step
    that fails part way has written only the rows at each slot's current
    position, which a retry of the same step rewrites with the same values.
    Inactive slots (all-zero block table, position 0) write into page 0 —
    the scheduler's scratch page.  Returns (y (S, 1, D), (k_pool, v_pool)).
    """
    from repro_torch.kernels.paged_attention import paged_attention

    s, t, _ = x.shape
    if t != 1:
        raise ValueError(f"paged decode is single-token; got T={t}")
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    pos2 = positions[:, None]  # (S, 1) per-row positions for RoPE

    q = dense(x, p["wq"], cfg, p.get("bq")).reshape(s, 1, h, hd)
    k = dense(x, p["wk"], cfg, p.get("bk")).reshape(s, 1, kvh, hd)
    v = dense(x, p["wv"], cfg, p.get("bv")).reshape(s, 1, kvh, hd)
    q = apply_rope(q, pos2, cfg.rope_theta)
    k = apply_rope(k, pos2, cfg.rope_theta)

    ps = k_pool.shape[1]
    pos_l = positions.long()
    page = torch.gather(block_tables.long(), 1, (pos_l // ps)[:, None])
    flat = page[:, 0] * ps + pos_l % ps  # (S,) rows in the (P*ps, ...) view
    k_pool.view(-1, kvh, hd)[flat] = k[:, 0].to(k_pool.dtype)
    v_pool.view(-1, kvh, hd)[flat] = v[:, 0].to(v_pool.dtype)

    out = paged_attention(
        q.reshape(s, h, hd),
        k_pool,
        v_pool,
        block_tables,
        positions + 1,  # valid length includes the token just written
        impl=impl,
    ).reshape(s, 1, h, hd)
    return dense(out.reshape(s, 1, h * hd), p["wo"], cfg), (k_pool, v_pool)


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, T, D)
    cfg,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    use_rope: bool = True,
    cache: Optional[Cache] = None,
    cache_pos: Optional[int] = None,
    write_cache: bool = False,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (output (B, T, D), updated cache or None).

    Modes:
      cache=None, write_cache=False     full attention (causal unless told)
      cache=None, write_cache=True      prefill: returns fresh cache = (k, v)
      cache=..., cache_pos=p            decode: T new tokens at position p;
                                        the returned cache is a new tensor
      cross_kv=(k, v)                   cross-attention: only wq projects,
                                        nothing is rotated, no mask, plain
                                        `_sdpa`; the cache args are ignored
    """
    b, t, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if positions is None:
        start = cache_pos if cache_pos is not None else 0
        positions = torch.arange(t, device=x.device)[None, :] + start
        positions = positions.expand(b, t)

    q = dense(x, p["wq"], cfg, p.get("bq")).reshape(b, t, h, hd)
    if cross_kv is not None:
        k, v = cross_kv
        out = _sdpa(q, k, v, causal=False)
        return dense(out.reshape(b, t, h * hd), p["wo"], cfg), None
    k = dense(x, p["wk"], cfg, p.get("bk")).reshape(b, t, kvh, hd)
    v = dense(x, p["wv"], cfg, p.get("bv")).reshape(b, t, kvh, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache: Optional[Cache] = None
    if cache is not None:
        # Decode: write the T new keys at cache_pos, attend over the prefix.
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, cache_pos : cache_pos + t] = k.to(ck.dtype)
        cv[:, cache_pos : cache_pos + t] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        out = _sdpa(
            q, ck, cv, causal=True, q_offset=cache_pos, kv_valid_len=cache_pos + t
        )
    else:
        chunk = cfg.attn_chunk
        if chunk and t > chunk and t % chunk == 0:
            out = flash_attention(q, k, v, causal=causal, block_q=chunk, block_k=chunk)
        else:
            out = _sdpa(q, k, v, causal=causal)
        if write_cache:
            new_cache = {"k": k, "v": v}

    return dense(out.reshape(b, t, h * hd), p["wo"], cfg), new_cache

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
the caller computed.

Tensor parallelism (a `ShardCtx` with a live mesh; `HeadLayout`): wq, wk
and wv are column-parallel, so each process projects its own query heads
and kv heads, K4 and K6 run on them, and wo is row-parallel (f32 partials,
one all-reduce: `layers.dense_rows`).  Heads shard where their count
divides the 'model' axis and replicate otherwise, as the reference's
`_drop_indivisible` does; where the query heads shard and the kv heads do
not, every process holds all kv heads (the reference's replicated cache)
and its query head g reads global kv head g // rep.  With the 'seq_attn'
rule on 'model' the chunked path is context-parallel: q goes to a block of
query rows over all heads (first-wins takes 'model' from 'heads'), K and V
are gathered whole, each process attends its rows [o, o + T/M) to keys
[0, o + T/M) through K6 with q_offset = o, and the rows are gathered back.

A sequence-sharded KV cache (the 'kv_seq' rule on mesh axes of n ranks,
the reference's decode rules where the kv heads do not divide 'model',
and `SP_DECODE_RULES` for long contexts): a process holds positions
[r·T/n, (r+1)·T/n) of the dense decode cache (`cache_len`), and the owner
of a new position writes its keys.  Decode (`_decode_seq_sharded`) takes
each process's f32 partials over its slice (row max, sum of exponentials,
unnormalised output) and combines them exactly across the axes: an
all-reduce of the max, then of the rescaled sums and outputs, then the
division.  Where the query heads are cut along one of those axes (the kv
heads replicated while 'heads' is on 'model'), the process gathers q's
heads, combines for all of them and keeps its own for wo's row-parallel
product.  Cross-attention over a seq-sharded encoder output (Whisper's
decode, `cross_len`) combines the same way, unmasked.  The order of the
f32 sums differs from one softmax over the whole row, so the results
agree with the unsharded decode to rounding.  The paged server path has
no such layout (the reference's server has none either).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    NO_SHARD,
    Part,
    PSpec,
    ShardCtx,
    apply_rope,
    dense,
    dense_rows,
)
from repro_torch.parallel.sharding import PartitionSpec as P

__all__ = [
    "HeadLayout",
    "attn_specs",
    "attention",
    "attention_paged_decode",
    "cache_len",
    "head_layout",
    "kv_seq_ranks",
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


def _names(axes) -> Tuple[str, ...]:
    return () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))


def init_cache_shape(cfg, batch: int, max_len: int) -> Dict[str, Tuple[int, ...]]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim_
    return {"k": (batch, max_len, kv, hd), "v": (batch, max_len, kv, hd)}


def kv_seq_ranks(ctx: ShardCtx) -> int:
    """The ranks the 'kv_seq' rule cuts a cache's positions over (1: none)."""
    axes = ctx.axes_of("kv_seq")
    n = 1
    for a in _names(axes):
        n *= ctx.axis_size(a)
    return n


def cache_len(ctx: ShardCtx, length: int) -> int:
    """This process's length of a decode cache (or encoder output) of
    `length` positions under `ctx`: length / n where the 'kv_seq' rule
    cuts it over n ranks.  A length that does not divide raises
    ValueError (a sequence-sharded cache is read as n equal blocks)."""
    n = kv_seq_ranks(ctx)
    if length % n:
        raise ValueError(f"a cache of {length} positions does not split over the {n} ranks"
                         f" of 'kv_seq' ({ctx.axes_of('kv_seq')!r})")
    return length // n


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """Which heads this process holds under a `ShardCtx`.

    q          this process's `Part` of the query heads
    kv         its `Part` of the kv heads: the heads its projections and
               its dense KV cache hold (all of them where they replicate)
    read       the cache's heads (indices into `kv`'s block) its query
               heads attend, in order; the paged pools hold just these
    rep        query heads per read kv head
    """

    q: Part
    kv: Part
    read: Tuple[int, ...]
    rep: int

    @property
    def reads_all(self) -> bool:
        return self.read == tuple(range(self.kv.size))

    def select(self, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The `read` heads of `t`, whose dim `dim` holds the kv block."""
        if self.reads_all:
            return t
        lo = self.read[0]
        if self.read == tuple(range(lo, lo + len(self.read))):
            return t.narrow(dim, lo, len(self.read))
        return t.index_select(dim, torch.tensor(self.read, device=t.device))


def head_layout(cfg, ctx: ShardCtx = NO_SHARD) -> HeadLayout:
    """The `HeadLayout` of cfg's attention under `ctx` (module docstring)."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    rep = h // kvh
    qp, kvp = ctx.part("heads", h), ctx.part("kv_heads", kvh)
    if kvp.count > 1:
        if (qp.count, qp.axes) != (kvp.count, kvp.axes):
            raise NotImplementedError(f"kv heads sharded {kvp} where the query heads are {qp}")
        return HeadLayout(qp, kvp, tuple(range(kvp.size)), rep)
    if qp.count == 1:
        return HeadLayout(qp, kvp, tuple(range(kvh)), rep)
    q0, n = qp.start, qp.size
    if n % rep == 0:  # whole groups of rep query heads
        return HeadLayout(qp, kvp, tuple(range(q0 // rep, (q0 + n) // rep)), rep)
    if rep % n == 0:  # all of them inside one group
        return HeadLayout(qp, kvp, (q0 // rep,), n)
    return HeadLayout(qp, kvp, tuple((q0 + j) // rep for j in range(n)), 1)


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
    ctx: ShardCtx = NO_SHARD,
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
    the scheduler's scratch page.  Under a mesh the pools hold the kv heads
    this process's query heads read (`HeadLayout.read`).  Returns
    (y (S, 1, D), (k_pool, v_pool)).
    """
    from repro_torch.kernels.paged_attention import paged_attention

    s, t, d = x.shape
    if t != 1:
        raise ValueError(f"paged decode is single-token; got T={t}")
    h, hd = cfg.num_heads, cfg.head_dim_
    lay = head_layout(cfg, ctx)
    pos2 = positions[:, None]  # (S, 1) per-row positions for RoPE

    q = dense(x, p["wq"], cfg, p.get("bq")).reshape(s, 1, lay.q.size, hd)
    k = dense(x, p["wk"], cfg, p.get("bk")).reshape(s, 1, lay.kv.size, hd)
    v = dense(x, p["wv"], cfg, p.get("bv")).reshape(s, 1, lay.kv.size, hd)
    q = apply_rope(q, pos2, cfg.rope_theta)
    k = apply_rope(k, pos2, cfg.rope_theta)
    q = ctx.c(q, ("batch", "seq", "heads", "head_dim"), (None, 1, h, hd))

    ps, n_pool = k_pool.shape[1], k_pool.shape[2]
    pos_l = positions.long()
    page = torch.gather(block_tables.long(), 1, (pos_l // ps)[:, None])
    flat = page[:, 0] * ps + pos_l % ps  # (S,) rows in the (P*ps, ...) view
    k_pool.view(-1, n_pool, hd)[flat] = lay.select(k[:, 0], 1).to(k_pool.dtype)
    v_pool.view(-1, n_pool, hd)[flat] = lay.select(v[:, 0], 1).to(v_pool.dtype)

    out = paged_attention(
        q.reshape(s, lay.q.size, hd),
        k_pool,
        v_pool,
        block_tables,
        positions + 1,  # valid length includes the token just written
        impl=impl,
    ).reshape(s, 1, lay.q.size, hd)
    out = ctx.c(out, ("batch", "seq", "heads", "head_dim"), (None, 1, h, hd))
    y = dense_rows(out.reshape(s, 1, lay.q.size * hd), p["wo"], cfg, ctx, lay.q,
                   ("batch", "seq", "embed"), (None, 1, d))
    return y, (k_pool, v_pool)


def _seq_sharded_attend(q, k, v, cfg, ctx: ShardCtx, lay: HeadLayout, *, start: int,
                        q_pos: Optional[int]):
    """Attention of q (B, T, this process's query heads, hd) over keys and
    values that are this process's block of a sequence-sharded whole,
    positions [start, start + len) along the 'kv_seq' axes: the exact
    combine of the module docstring.  `q_pos` is the first query's
    position for a causal mask (None: unmasked, cross-attention).
    Returns (B, T, this process's query heads, hd) in q's type."""
    import torch.distributed as dist

    from repro_torch.parallel.collectives import all_reduce, axis_group

    b, t, _, hd = q.shape
    axes = ctx.axes_of("kv_seq")
    group = axis_group(ctx.mesh, axes)[0]
    h = cfg.num_heads
    take = lay.q.count > 1 and bool(set(_names(lay.q.axes)) & set(_names(axes)))
    if take:  # every query head against this block: gather them, keep ours at the end
        if lay.kv.count > 1:
            raise NotImplementedError("the kv heads cut along the 'kv_seq' axes")
        q = ctx.gather(q, ("batch", "seq", "heads", "head_dim"), (None, t, h, hd))
    else:
        k, v = lay.select(k), lay.select(v)
    kvh = k.shape[2]
    rep = q.shape[2] // kvh
    q5 = q.reshape(b, t, kvh, rep, hd)
    scores = torch.einsum("btkrd,bskd->bkrts", q5.float(), k.float()) / (hd**0.5)
    if q_pos is not None:
        kpos = torch.arange(start, start + k.shape[1], device=q.device)[None, :]
        qpos = torch.arange(t, device=q.device)[:, None] + q_pos
        scores = torch.where((kpos <= qpos)[None, None, None], scores, _NEG_INF)
    row_max = all_reduce(scores.detach().amax(dim=-1, keepdim=True), dist.ReduceOp.MAX, group)
    e = torch.exp(scores - row_max)
    total = all_reduce(e.sum(dim=-1, keepdim=True), group=group)
    acc = all_reduce(torch.einsum("bkrts,bskd->bkrtd", e, v.float()), group=group)
    out = (acc / total).to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, t, kvh * rep, hd)
    if take:
        out = out.narrow(2, lay.q.start, lay.q.size)
    return out


def _decode_seq_sharded(q, k, v, cache: Cache, cache_pos: int, cfg, ctx: ShardCtx,
                        lay: HeadLayout) -> Tuple[torch.Tensor, Cache]:
    """Decode against this process's block of a sequence-sharded cache:
    the process that holds a new position writes its keys and values, then
    `_seq_sharded_attend` (module docstring).  Returns (out, new cache)."""
    t = q.shape[1]
    n = cache["k"].shape[1]
    start = ctx.part("kv_seq", n * kv_seq_ranks(ctx)).start
    ck, cv = cache["k"].clone(), cache["v"].clone()
    lo, hi = max(cache_pos, start), min(cache_pos + t, start + n)
    if lo < hi:
        ck[:, lo - start:hi - start] = k[:, lo - cache_pos:hi - cache_pos].to(ck.dtype)
        cv[:, lo - start:hi - start] = v[:, lo - cache_pos:hi - cache_pos].to(cv.dtype)
    out = _seq_sharded_attend(q, ck, cv, cfg, ctx, lay, start=start, q_pos=cache_pos)
    return out, {"k": ck, "v": cv}


def _flash(q, k, v, cfg, ctx: ShardCtx, lay: HeadLayout, causal: bool, chunk: int):
    """The chunked path (K6 on the card): (out, the layout out is in).

    Unless the 'seq_attn' rule takes the query heads' mesh axis (or takes
    one while the heads replicate, their count not dividing it), K6 runs
    on this process's query heads and the kv heads they read.  If it does
    (first-wins: the heads replicate in that layout), context parallelism:
    this process's block [o, o + T/M) of the query rows over all heads
    (all rows where T does not divide), against every kv head and the keys
    up to its last row, at q_offset o; `out` comes back in that layout."""
    b, t, _, hd = q.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    axes = ("batch", "seq_attn", "heads", "head_dim")
    takes = ctx.axes_of("seq_attn")
    if takes is None or (lay.q.count > 1 and takes != lay.q.axes):
        q = ctx.c(q, axes, (None, t, h, hd))
        out = flash_attention(q, lay.select(k), lay.select(v), causal=causal, block_q=chunk,
                              block_k=chunk)
        return ctx.c(out, axes, (None, t, h, hd)), None
    rows = ctx.part("seq_attn", t)
    q = ctx.c(q, axes, (None, t, h, hd), src=P(None, None, lay.q.axes, None))
    k = ctx.gather(k, ("batch", "seq", "kv_heads", "head_dim"), (None, t, kvh, hd))
    v = ctx.gather(v, ("batch", "seq", "kv_heads", "head_dim"), (None, t, kvh, hd))
    keys = min(t, -(-(rows.start + rows.size) // chunk) * chunk) if causal else t
    out = flash_attention(q, k[:, :keys], v[:, :keys], causal=causal,
                          block_q=rows.size * (h // kvh), block_k=chunk, q_offset=rows.start)
    return ctx.c(out, axes, (None, t, h, hd)), P(None, rows.axes, None, None)


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, T, D)
    cfg,
    ctx: ShardCtx = NO_SHARD,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    use_rope: bool = True,
    cache: Optional[Cache] = None,
    cache_pos: Optional[int] = None,
    write_cache: bool = False,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cross_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (output (B, T, D), updated cache or None).

    Modes:
      cache=None, write_cache=False     full attention (causal unless told)
      cache=None, write_cache=True      prefill: returns fresh cache = (k, v)
      cache=..., cache_pos=p            decode: T new tokens at position p;
                                        the returned cache is a new tensor
      cross_kv=(k, v)                   cross-attention: only wq projects,
                                        nothing is rotated, no mask, plain
                                        `_sdpa`; the cache args are ignored;
                                        with `cross_len` (their whole
                                        length) k and v are this process's
                                        block along 'kv_seq'

    Under a mesh, x holds this process's batch rows, whole in D; the cache
    holds its kv heads (`HeadLayout.kv`), and under 'kv_seq' on mesh axes
    its block of positions (`cache_len`); the output is whole in D.
    """
    b, t, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    lay = head_layout(cfg, ctx)
    if positions is None:
        start = cache_pos if cache_pos is not None else 0
        positions = torch.arange(t, device=x.device)[None, :] + start
        positions = positions.expand(b, t)

    q = dense(x, p["wq"], cfg, p.get("bq")).reshape(b, t, lay.q.size, hd)
    if cross_kv is None:
        k = dense(x, p["wk"], cfg, p.get("bk")).reshape(b, t, lay.kv.size, hd)
        v = dense(x, p["wv"], cfg, p.get("bv")).reshape(b, t, lay.kv.size, hd)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = cross_kv
    q = ctx.c(q, ("batch", "seq", "heads", "head_dim"), (None, t, h, hd))

    new_cache: Optional[Cache] = None
    out_src = None  # the layout `out` is in, where it is not the heads'
    kv_axes = ("kv_batch", "kv_seq", "kv_heads", "head_dim")
    if cross_kv is not None and cross_len is not None and k.shape[1] != cross_len:
        start = ctx.part("kv_seq", cross_len).start
        out = _seq_sharded_attend(q, k, v, cfg, ctx, lay, start=start, q_pos=None)
    elif cross_kv is not None:
        out = _sdpa(q, lay.select(k), lay.select(v), causal=False)
    elif cache is not None and ctx.axes_of("kv_seq") is not None:
        out, new_cache = _decode_seq_sharded(q, k, v, cache, cache_pos, cfg, ctx, lay)
    elif cache is not None:
        # Decode: write the T new keys at cache_pos, attend over the prefix.
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, cache_pos : cache_pos + t] = k.to(ck.dtype)
        cv[:, cache_pos : cache_pos + t] = v.to(cv.dtype)
        ck = ctx.c(ck, kv_axes, (None, ck.shape[1], kvh, hd))
        cv = ctx.c(cv, kv_axes, (None, cv.shape[1], kvh, hd))
        new_cache = {"k": ck, "v": cv}
        out = _sdpa(q, lay.select(ck), lay.select(cv), causal=True, q_offset=cache_pos,
                    kv_valid_len=cache_pos + t)
    else:
        k = ctx.c(k, ("batch", "seq", "kv_heads", "head_dim"), (None, t, kvh, hd))
        v = ctx.c(v, ("batch", "seq", "kv_heads", "head_dim"), (None, t, kvh, hd))
        chunk = cfg.attn_chunk
        if chunk and t > chunk and t % chunk == 0:
            out, out_src = _flash(q, k, v, cfg, ctx, lay, causal, chunk)
        else:
            out = _sdpa(q, lay.select(k), lay.select(v), causal=causal)
        if write_cache:
            cache_len(ctx, t)  # a sequence-sharded cache must split evenly
            new_cache = {"k": ctx.c(k, kv_axes, (None, t, kvh, hd)),
                         "v": ctx.c(v, kv_axes, (None, t, kvh, hd))}

    out = ctx.c(out, ("batch", "seq", "heads", "head_dim"), (None, t, h, hd), src=out_src)
    y = dense_rows(out.reshape(b, t, lay.q.size * hd), p["wo"], cfg, ctx, lay.q,
                   ("batch", "seq", "embed"), (None, t, d))
    return y, new_cache

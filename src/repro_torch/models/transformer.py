"""Decoder-only transformer LM, dense and MoE families (port of
`repro.models.transformer`).

Layers are stacked on a leading (L,) axis, as in the reference, and run by
a Python loop over that axis where the reference uses `jax.lax.scan`.
Entry points: `lm_forward` (train), `lm_prefill`, `lm_decode` (dense
per-layer KV caches) and `lm_decode_paged` (paged KV pools, the
continuous-batching step).

The paper's scrambling system is an optional privacy transform of training:
with cfg.scramble_privacy, `lm_forward` scrambles the embedding output's
(T, D) block grid with S (kernel K3) and unscrambles it before the head —
square grids only.  The serving path never runs it.

`lm_forward` runs each layer under cfg.remat_policy (`_remat`): `none`
keeps every activation for the backward, `full` recomputes the whole layer
(`torch.utils.checkpoint`), and `dots`, the default, is the reference's
`checkpoint_dots_with_no_batch_dims` as it reads on its `xla` path, which
gives one answer whatever backend runs: the outputs of 2-D products with
no batch dim are saved (the dense projections, `layers.gemm`, and the
router's f32 product) and everything else is recomputed (norms, RoPE,
attention with its batched score products or K6, routing, and the grouped
expert products, which carry a group batch dim).  A selective-checkpoint
policy decides by the op the dispatcher sees, and K1 launches through
ctypes: so a dense plan runs its product as one op, `repro_torch::gemm`
(`kernels/api.py`), which the policy names beside `aten.mm`.

Every entry point takes a `ShardCtx` (default: none) and calls `ctx.c` at
the reference's sites.  Under a live ('data', 'model') mesh it serves
tensor-parallel: `tokens` are this process's batch rows (the serving steps
split the batch over 'data' where it divides, `ShardCtx.for_rows`), the
embedding is vocab-parallel (a masked lookup of this process's vocab rows,
then one all-reduce), the blocks are the column/row-parallel attention and
feed-forward of `attention` and `moe`, and the lm head is vocab-parallel:
`unembed` leaves the logits sharded over 'vocab' (the padded-vocab mask
on the global index), and the serving steps gather them where they take
the argmax.  Caches and page pools hold this process's rows and kv heads.
It trains tensor-parallel too: every collective `ShardCtx.c` issues
carries its adjoint backward (`parallel.collectives`), the loss reads the
vocab-sharded logits without gathering them (`layers.softmax_xent`), and
`train_step.make_train_step(ctx=)` seeds the backward with 1/M and sums
the replicated leaves' gradients over 'model'.

Megatron sequence parallelism (the 'seq_sp' rule on 'model', the
reference's `TRAIN_RULES`): the carrier between two layers, the tensor the
remat policies save, is this process's block of the sequence, (B, T/M, D)
(`ctx.c` at the reference's carrier site slices it), and each layer
all-gathers it whole where it starts (`seq_whole`), as the head does; the
gather's backward is a reduce-scatter, so no other gradient path is
needed.  A T that does not divide the axis replicates.  FSDP (a ctx with
`param_rules`): each layer's parameters are gathered from their blocks by
`ShardCtx.weights` inside the layer's body, so `full` and `dots` recompute
the gathers rather than keep the whole weights.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.kernels.ops import scramble_blocks
from repro_torch.models.attention import (
    attention,
    attention_paged_decode,
    attn_specs,
    cache_len,
    head_layout,
)
from repro_torch.models.layers import NO_SHARD, PSpec, ShardCtx, gemm, padded_vocab, rmsnorm
from repro_torch.models.moe import moe_block, moe_specs, swiglu, swiglu_specs

__all__ = [
    "block_apply",
    "block_apply_paged",
    "block_specs",
    "embed_tokens",
    "lm_decode",
    "lm_decode_paged",
    "lm_forward",
    "lm_prefill",
    "lm_specs",
    "paged_pool_specs",
    "seq_whole",
    "stack_specs",
    "top_weights",
    "layer_entry",
    "unembed",
]


def stack_specs(specs: Any, num: int) -> Any:
    """Prepend a stacked 'layers' dim to every PSpec leaf."""
    if isinstance(specs, PSpec):
        return PSpec((num,) + specs.shape, ("layers",) + specs.axes, specs.scale,
                     specs.dtype, specs.init)
    return {k: stack_specs(v, num) for k, v in specs.items()}


def block_specs(cfg) -> Dict[str, Any]:
    """One transformer block: attn + (SwiGLU | MoE) + 2 norms."""
    specs: Dict[str, Any] = {
        "ln1": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_specs(cfg),
    }
    if cfg.is_moe:
        specs["moe"] = moe_specs(cfg)
    else:
        specs["mlp"] = swiglu_specs(cfg, cfg.d_ff)
    return specs


def lm_specs(cfg) -> Dict[str, Any]:
    vpad = padded_vocab(cfg)
    specs: Dict[str, Any] = {
        "embed": PSpec((vpad, cfg.d_model), ("vocab", "embed"), 0.02),
        "blocks": stack_specs(block_specs(cfg), cfg.num_layers),
        "final_norm": PSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((cfg.d_model, vpad), ("embed", "vocab"), 0.02)
    return specs


def _layers(tree: Any, n: int) -> list:
    """The n layers of a stacked (n, ...) parameter tree, each leaf split
    once (`torch.unbind`): its backward stacks the layers' gradients in
    one op, where indexing each layer apart (`tree[i]`) adds a zero-filled
    (n, ...) gradient per layer, n^2 leaf sizes of traffic in all (the
    same values: the other terms are exact zeros)."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree))
    per = {k: _layers(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def embed_tokens(params, tokens: torch.Tensor, cfg, ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Vocab-parallel under a mesh: each process looks up the tokens in its
    rows of the table (0 elsewhere) and one all-reduce sums the blocks,
    exactly (one term is not 0)."""
    vp = ctx.part("vocab", padded_vocab(cfg))
    if vp.count == 1:
        x = params["embed"][tokens.long()]
    else:
        idx = tokens.long() - vp.start
        mine = (idx >= 0) & (idx < vp.size)
        rows = params["embed"][idx.clamp(0, vp.size - 1)]
        x = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
    x = x.to(cfg.adtype)
    return ctx.c(x, ("batch", "seq", "embed"), (None, tokens.shape[1], cfg.d_model),
                 partial=vp)


def unembed(params, x: torch.Tensor, cfg, ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = gemm(x, head.to(x.dtype), cfg)
    vpad = padded_vocab(cfg)
    vp = ctx.part("vocab", vpad)
    # Padded vocab rows (vocab_pad_multiple) never win argmax; the mask is
    # on the global vocab index.
    if vpad != cfg.vocab_size:
        mask = torch.arange(vp.start, vp.start + vp.size, device=x.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                         device=x.device))
    return ctx.c(logits, ("batch", "seq", "vocab"), (None, x.shape[1], vpad))


def block_apply(
    p: Dict[str, Any],
    x: torch.Tensor,
    cfg,
    ctx: ShardCtx = NO_SHARD,
    *,
    cache=None,
    cache_pos=None,
    write_cache: bool = False,
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Pre-norm block.  Returns (x, new_cache, aux); aux is the MoE block's
    {'lb_loss', 'router_z'} and empty for the dense family."""
    h, new_cache = attention(
        p["attn"],
        rmsnorm(x, p["ln1"], cfg.norm_eps),
        cfg,
        ctx,
        cache=cache,
        cache_pos=cache_pos,
        write_cache=write_cache,
    )
    x = x + h
    h2, aux = _ffn(p, x, cfg, ctx)
    return x + h2, new_cache, aux


def _ffn(p: Dict[str, Any], x: torch.Tensor, cfg, ctx: ShardCtx = NO_SHARD):
    """The block's feed-forward half on rmsnorm(x): (output, aux)."""
    if cfg.is_moe:
        return moe_block(p["moe"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg, ctx)
    return swiglu(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg, ctx), {}


def seq_whole(x: torch.Tensor, ctx: ShardCtx, t: int) -> torch.Tensor:
    """The (B, T, D) activation `x` whole along the sequence of length t:
    all-gathered over the 'seq_sp' axes where it is this process's block
    (a carrier of sequence parallelism), as it is otherwise."""
    part = ctx.part("seq_sp", t)
    if part.count == 1 or x.shape[1] == t:
        return x
    return ctx.c(x, ("batch", "seq", "embed"), (None, t, x.shape[2]),
                 src=(None, part.axes, None))


def top_weights(params, spec_fn, cfg, ctx: ShardCtx, stacked=("blocks",)):
    """(params, specs): `params` with every entry but the `stacked` layer
    trees gathered into the activation layout (`ShardCtx.weights`), and the
    model's PSpec tree `spec_fn(cfg)` for `layer_entry`.  Without FSDP,
    `params` as they are and None."""
    if not ctx.fsdp:
        return params, None
    specs = spec_fn(cfg)
    top = {k: v for k, v in params.items() if k not in stacked}
    return {**params, **ctx.weights(top, specs)}, specs


def layer_entry(lp, x: torch.Tensor, ctx: ShardCtx, t: int, specs, stack: str = "blocks"):
    """Where a layer of the `stack` starts, inside its (remat) body: its
    parameters `lp` in the activation layout (FSDP's per-layer gathers;
    `specs` from `top_weights`) and its input `x` whole along the sequence
    of length t (`seq_whole`).  Both gathers are recomputed, not saved."""
    if specs is not None:
        lp = ctx.weights(lp, specs[stack])
    return lp, seq_whole(x, ctx, t)


# The ops whose outputs `dots` saves: 2-D products with no batch dim (the
# dense plan as one op, and plain 2-D products such as the router's).
_DOTS_SAVED = (torch.ops.repro_torch.gemm.default, torch.ops.aten.mm.default,
               torch.ops.aten.addmm.default)


def _remat(fn, policy: str):
    """`fn` under the remat policy: none | dots | full (module docstring).
    Recompute runs only where autograd records; no layer draws random
    numbers, so no RNG state is kept."""
    if policy == "none":
        return fn
    if policy == "dots":
        kw = dict(context_fn=functools.partial(create_selective_checkpoint_contexts,
                                               list(_DOTS_SAVED)))
    elif policy == "full":
        kw = {}
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run


def _maybe_scramble(x: torch.Tensor, cfg, inverse: bool = False) -> torch.Tensor:
    """Paper scrambling system on (T, D) activation block grids (square only)."""
    if not cfg.scramble_privacy:
        return x
    t, d = x.shape[-2], x.shape[-1]
    bm, bn = 128, 128
    if t % bm or d % bn or t // bm != d // bn:
        return x  # non-square grid: scrambling skipped (demo feature)
    return scramble_blocks(x, block_m=bm, block_n=bn, k=-1 if inverse else 1)


def lm_forward(params, tokens: torch.Tensor, cfg, ctx: ShardCtx = NO_SHARD):
    """Train/eval forward: (B, T) int32 -> (logits (B, T, V), aux dict)."""
    t = tokens.shape[1]
    params, specs = top_weights(params, lm_specs, cfg, ctx)
    x = embed_tokens(params, tokens, cfg, ctx)
    x = _maybe_scramble(x, cfg)
    x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, lp):
        lp, x = layer_entry(lp, x, ctx, t, specs)
        y, _, aux = block_apply(lp, x, cfg, ctx)
        y = ctx.c(y, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))  # SP remat carrier
        # A dense block has no router: its entries are zeros, as in the
        # reference's per-layer aux stack.
        return y, torch.stack([aux.get("lb_loss", zero), aux.get("router_z", zero)])

    body = _remat(body, cfg.remat_policy)
    aux_stack = []
    for lp in _layers(params["blocks"], cfg.num_layers):
        x, aux_vec = body(x, lp)
        aux_stack.append(aux_vec)
    x = _maybe_scramble(seq_whole(x, ctx, t), cfg, inverse=True)
    logits = unembed(params, x, cfg, ctx)
    aux_mean = torch.stack(aux_stack).mean(dim=0)
    return logits, {"lb_loss": aux_mean[0], "router_z": aux_mean[1]}


def lm_prefill(params, tokens: torch.Tensor, cfg, ctx: ShardCtx = NO_SHARD):
    """Prefill: returns (logits (B, T, V), stacked caches (L, B, T, KV, hd))."""
    t = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg, ctx)
    ks, vs = [], []
    for lp in _layers(params["blocks"], cfg.num_layers):
        x, cache, _ = block_apply(lp, seq_whole(x, ctx, t), cfg, ctx, write_cache=True)
        x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
        ks.append(cache["k"])
        vs.append(cache["v"])
    logits = unembed(params, seq_whole(x, ctx, t), cfg, ctx)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def lm_decode(
    params,
    tokens: torch.Tensor,  # (B, T_new) — usually T_new = 1
    caches,  # stacked (L, B, T_max, KV, hd) {"k","v"}
    pos: int,  # current length
    cfg,
    ctx: ShardCtx = NO_SHARD,
):
    """One decode step against per-layer KV caches; returns (logits, caches)."""
    x = embed_tokens(params, tokens, cfg, ctx)
    ks, vs = [], []
    for i, lp in enumerate(_layers(params["blocks"], cfg.num_layers)):
        layer_cache = {"k": caches["k"][i], "v": caches["v"][i]}
        x, new_cache, _ = block_apply(lp, x, cfg, ctx, cache=layer_cache, cache_pos=int(pos))
        ks.append(new_cache["k"])
        vs.append(new_cache["v"])
    logits = unembed(params, x, cfg, ctx)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def block_apply_paged(
    p: Dict[str, Any],
    x: torch.Tensor,  # (S, 1, D)
    cfg,
    ctx: ShardCtx = NO_SHARD,
    *,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """`block_apply`'s decode branch against a paged KV pool."""
    h, pools = attention_paged_decode(
        p["attn"],
        rmsnorm(x, p["ln1"], cfg.norm_eps),
        cfg,
        ctx,
        k_pool=k_pool,
        v_pool=v_pool,
        block_tables=block_tables,
        positions=positions,
        impl=impl,
    )
    x = x + h
    h2, _ = _ffn(p, x, cfg, ctx)
    return x + h2, pools


def lm_decode_paged(
    params,
    tokens: torch.Tensor,  # (S, 1) — one token per sequence slot
    pools,  # {"k","v"}: (L, P, page_size, KV, hd) shared page pools
    block_tables: torch.Tensor,  # (S, n_pages) int32
    positions: torch.Tensor,  # (S,) int32 per-slot lengths
    cfg,
    ctx: ShardCtx = NO_SHARD,
    *,
    impl: Optional[str] = None,
):
    """One continuous-batching decode step: every slot advances one token
    against its own block-table pages.  The new K/V rows are written into
    `pools` in place (see `attention_paged_decode`).  Returns
    (logits (S, 1, V), pools)."""
    x = embed_tokens(params, tokens, cfg, ctx)
    for i, lp in enumerate(_layers(params["blocks"], cfg.num_layers)):
        x, _ = block_apply_paged(
            lp,
            x,
            cfg,
            ctx,
            k_pool=pools["k"][i],
            v_pool=pools["v"][i],
            block_tables=block_tables,
            positions=positions,
            impl=impl,
        )
    logits = unembed(params, x, cfg, ctx)
    return logits, pools


def paged_pool_specs(cfg, num_pages: int, page_size: int,
                     ctx: ShardCtx = NO_SHARD) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Stacked page pools for the serving scheduler (one per layer), as
    {name: (shape, dtype)}; under a mesh, of the kv heads this process's
    query heads read (`attention.HeadLayout.read`)."""
    kv, hd = len(head_layout(cfg, ctx).read), cfg.head_dim_
    shp = (cfg.num_layers, num_pages, page_size, kv, hd)
    return {"k": (shp, cfg.adtype), "v": (shp, cfg.adtype)}


def decode_cache_specs(cfg, batch: int, max_len: int,
                       ctx: ShardCtx = NO_SHARD) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Stacked dense KV cache shapes, as {name: (shape, dtype)}; under a
    mesh, of this process's kv heads (`attention.HeadLayout.kv`) and,
    under 'kv_seq', its block of the positions (`attention.cache_len`)."""
    kv, hd = head_layout(cfg, ctx).kv.size, cfg.head_dim_
    shp = (cfg.num_layers, batch, cache_len(ctx, max_len), kv, hd)
    return {"k": (shp, cfg.adtype), "v": (shp, cfg.adtype)}

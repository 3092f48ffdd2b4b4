"""Whisper-medium backbone (arXiv:2212.04356): encoder-decoder transformer
(port of `repro.models.whisper`).

The conv/mel frontend is a stub: the batch carries precomputed frame
embeddings (B, T_enc, D), projected by `frame_proj`.  Encoder: blocks of
full (non-causal) self-attention, no cache; with cfg.attn_chunk its long
inputs take the chunked path (kernel K6, non-causal, on the card).
Decoder: causal self-attention with a KV cache, and cross-attention over the
encoder output.  As in the reference, the cross K/V are recomputed from
`enc_out` on every decode step (`_cross_kv`, dense with biases), and the
decode state carries `enc_out` itself.  RoPE gives positions in both stacks
(the reference's adaptation of Whisper's learned absolute embeddings);
cross-attention rotates nothing.

Tensor parallelism (a `ShardCtx` with a live mesh), SPMD by hand: the
attention and SwiGLU blocks are the dense family's (column-parallel q, k,
v and wi, row-parallel wo); the encoder runs its non-causal attention (K6
on the card) on this process's heads; `_cross_kv` projects this process's
kv heads of the cross K/V; frame_proj stays replicated.  The decoder's
token lookup is `transformer.embed_tokens`' vocab-parallel one (a masked
lookup of this process's rows, one all-reduce: bitwise the full table's
take), and the head is vocab-parallel.  The decode state's self-attention
caches hold this process's kv heads; `enc_out` stays whole.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.attention import (
    attention,
    attn_specs,
    cache_len,
    head_layout,
    kv_seq_ranks,
)
from repro_torch.models.layers import (
    NO_SHARD,
    PSpec,
    ShardCtx,
    dense,
    gemm,
    padded_vocab,
    rmsnorm,
)
from repro_torch.models.moe import swiglu, swiglu_specs
from repro_torch.models.transformer import (
    _layers,
    embed_tokens,
    layer_entry,
    seq_whole,
    stack_specs,
    top_weights,
    unembed,
)

__all__ = [
    "whisper_specs",
    "whisper_forward",
    "whisper_prefill",
    "whisper_decode",
    "whisper_cache_specs",
]


def _enc_block_specs(cfg):
    return {
        "ln1": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_specs(cfg),
        "mlp": swiglu_specs(cfg, cfg.d_ff),
    }


def _dec_block_specs(cfg):
    return {
        "ln1": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln_x": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_specs(cfg),
        "xattn": attn_specs(cfg),
        "mlp": swiglu_specs(cfg, cfg.d_ff),
    }


def whisper_specs(cfg) -> Dict[str, Any]:
    return {
        # frontend stub: a single projection applied to precomputed frames
        "frame_proj": PSpec((cfg.d_model, cfg.d_model), ("embed", "embed"), 0.02),
        "enc_blocks": stack_specs(_enc_block_specs(cfg), cfg.enc_layers),
        "enc_norm": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "embed": PSpec((padded_vocab(cfg), cfg.d_model), ("vocab", "embed"), 0.02),
        "dec_blocks": stack_specs(_dec_block_specs(cfg), cfg.dec_layers),
        "final_norm": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": PSpec((cfg.d_model, padded_vocab(cfg)), ("embed", "vocab"), 0.02),
    }


def _encode(params, frames, cfg, ctx: ShardCtx = NO_SHARD, specs=None):
    """frames: (B, T_enc, D) precomputed embeddings (stub frontend); `specs`
    from `top_weights` under FSDP."""
    t, d = frames.shape[1], cfg.d_model
    x = gemm(frames.to(cfg.adtype), params["frame_proj"].to(cfg.adtype), cfg)
    x = ctx.c(x, ("batch", "frames", "embed"), (None, t, d))
    x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, d))
    for lp in _layers(params["enc_blocks"], cfg.enc_layers):
        lp, x = layer_entry(lp, x, ctx, t, specs, "enc_blocks")
        h, _ = attention(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, ctx,
                         causal=False)
        x = x + h
        x = x + swiglu(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
        x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, d))
    return rmsnorm(seq_whole(x, ctx, t), params["enc_norm"], cfg.norm_eps)


def _cross_kv(lp, enc_out, cfg, ctx: ShardCtx = NO_SHARD):
    """Cross-attention K/V of one decoder layer from the encoder output:
    under a mesh, of this process's kv heads."""
    b, t, _ = enc_out.shape
    kvh, hd = head_layout(cfg, ctx).kv.size, cfg.head_dim_
    xa = lp["xattn"]
    k = dense(enc_out, xa["wk"], cfg, xa.get("bk")).reshape(b, t, kvh, hd)
    v = dense(enc_out, xa["wv"], cfg, xa.get("bv")).reshape(b, t, kvh, hd)
    return k, v


def _decode_stack(params, tokens, enc_out, cfg, ctx: ShardCtx = NO_SHARD, *, cache=None,
                  pos=None, write_cache=False, enc_len=None, specs=None):
    """The decoder over `enc_out`: whole, or with `enc_len` (its whole
    length) this process's block along 'kv_seq' (the decode state's);
    `specs` from `top_weights` under FSDP."""
    t = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg, ctx)
    x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
    ks, vs = [], []
    for i, lp in enumerate(_layers(params["dec_blocks"], cfg.dec_layers)):
        lp, x = layer_entry(lp, x, ctx, t, specs, "dec_blocks")
        kvc = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
        h, new_kv = attention(
            lp["attn"],
            rmsnorm(x, lp["ln1"], cfg.norm_eps),
            cfg,
            ctx,
            cache=kvc,
            cache_pos=pos,
            write_cache=write_cache,
        )
        x = x + h
        h, _ = attention(lp["xattn"], rmsnorm(x, lp["ln_x"], cfg.norm_eps), cfg, ctx,
                         cross_kv=_cross_kv(lp, enc_out, cfg, ctx), cross_len=enc_len)
        x = x + h
        x = x + swiglu(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
        x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
        if new_kv is not None:
            ks.append(new_kv["k"])
            vs.append(new_kv["v"])
    logits = unembed(params, seq_whole(x, ctx, t), cfg, ctx)
    return logits, ({"k": torch.stack(ks), "v": torch.stack(vs)} if ks else None)


def whisper_forward(params, batch: Dict[str, torch.Tensor], cfg, ctx: ShardCtx = NO_SHARD):
    """batch: {"frames": (B, T_enc, D), "tokens": (B, T_dec)} -> (logits, aux)."""
    params, specs = top_weights(params, whisper_specs, cfg, ctx,
                                stacked=("enc_blocks", "dec_blocks"))
    enc_out = _encode(params, batch["frames"], cfg, ctx, specs)
    logits, _ = _decode_stack(params, batch["tokens"], enc_out, cfg, ctx, specs=specs)
    return logits, {}


def whisper_prefill(params, batch, cfg, ctx: ShardCtx = NO_SHARD):
    """Returns (logits, state) with the state carrying enc_out and the
    decoder's self-attention KV caches."""
    enc_out = _encode(params, batch["frames"], cfg, ctx)
    logits, caches = _decode_stack(params, batch["tokens"], enc_out, cfg, ctx,
                                   write_cache=True)
    t_enc = enc_out.shape[1]
    cache_len(ctx, t_enc)  # a sequence-sharded state must split evenly
    enc_out = ctx.c(enc_out, ("kv_batch", "kv_seq", "embed"), (None, t_enc, cfg.d_model))
    return logits, {"enc_out": enc_out, "k": caches["k"], "v": caches["v"]}


def whisper_decode(params, tokens, state, pos, cfg, ctx: ShardCtx = NO_SHARD):
    cache = {"k": state["k"], "v": state["v"]}
    enc_out = state["enc_out"]
    logits, new_kv = _decode_stack(params, tokens, enc_out, cfg, ctx, cache=cache,
                                   pos=int(pos), enc_len=enc_out.shape[1] * kv_seq_ranks(ctx))
    return logits, {"enc_out": state["enc_out"], "k": new_kv["k"], "v": new_kv["v"]}


def whisper_cache_specs(cfg, batch: int, enc_len: int, max_dec_len: int,
                        ctx: ShardCtx = NO_SHARD):
    """Decode state as {name: (shape, dtype)}; under a mesh the caches hold
    this process's kv heads, and under 'kv_seq' the caches and enc_out its
    block of their positions (enc_out stays whole in D)."""
    kv, hd = head_layout(cfg, ctx).kv.size, cfg.head_dim_
    L = cfg.dec_layers
    t = cache_len(ctx, max_dec_len)
    return {
        "enc_out": ((batch, cache_len(ctx, enc_len), cfg.d_model), cfg.adtype),
        "k": ((L, batch, t, kv, hd), cfg.adtype),
        "v": ((L, batch, t, kv, hd), cfg.adtype),
    }

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

from repro_torch.models.attention import attention, attn_specs, head_layout
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
    _no_model_training,
    embed_tokens,
    stack_specs,
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


def _encode(params, frames, cfg, ctx: ShardCtx = NO_SHARD):
    """frames: (B, T_enc, D) precomputed embeddings (stub frontend)."""
    t, d = frames.shape[1], cfg.d_model
    x = gemm(frames.to(cfg.adtype), params["frame_proj"].to(cfg.adtype), cfg)
    x = ctx.c(x, ("batch", "frames", "embed"), (None, t, d))
    for lp in _layers(params["enc_blocks"], cfg.enc_layers):
        h, _ = attention(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, ctx,
                         causal=False)
        x = x + h
        x = x + swiglu(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
        x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, d))
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


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
                  pos=None, write_cache=False):
    t = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg, ctx)
    ks, vs = [], []
    for i, lp in enumerate(_layers(params["dec_blocks"], cfg.dec_layers)):
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
                         cross_kv=_cross_kv(lp, enc_out, cfg, ctx))
        x = x + h
        x = x + swiglu(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
        x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
        if new_kv is not None:
            ks.append(new_kv["k"])
            vs.append(new_kv["v"])
    logits = unembed(params, x, cfg, ctx)
    return logits, ({"k": torch.stack(ks), "v": torch.stack(vs)} if ks else None)


def whisper_forward(params, batch: Dict[str, torch.Tensor], cfg, ctx: ShardCtx = NO_SHARD):
    """batch: {"frames": (B, T_enc, D), "tokens": (B, T_dec)} -> (logits, aux)."""
    _no_model_training(ctx)
    enc_out = _encode(params, batch["frames"], cfg, ctx)
    logits, _ = _decode_stack(params, batch["tokens"], enc_out, cfg, ctx)
    return logits, {}


def whisper_prefill(params, batch, cfg, ctx: ShardCtx = NO_SHARD):
    """Returns (logits, state) with the state carrying enc_out and the
    decoder's self-attention KV caches."""
    _no_model_training(ctx)
    enc_out = _encode(params, batch["frames"], cfg, ctx)
    logits, caches = _decode_stack(params, batch["tokens"], enc_out, cfg, ctx,
                                   write_cache=True)
    return logits, {"enc_out": enc_out, "k": caches["k"], "v": caches["v"]}


def whisper_decode(params, tokens, state, pos, cfg, ctx: ShardCtx = NO_SHARD):
    cache = {"k": state["k"], "v": state["v"]}
    logits, new_kv = _decode_stack(params, tokens, state["enc_out"], cfg, ctx, cache=cache,
                                   pos=int(pos))
    return logits, {"enc_out": state["enc_out"], "k": new_kv["k"], "v": new_kv["v"]}


def whisper_cache_specs(cfg, batch: int, enc_len: int, max_dec_len: int,
                        ctx: ShardCtx = NO_SHARD):
    """Decode state as {name: (shape, dtype)}; under a mesh the caches hold
    this process's kv heads and enc_out stays whole."""
    kv, hd = head_layout(cfg, ctx).kv.size, cfg.head_dim_
    L = cfg.dec_layers
    return {
        "enc_out": ((batch, enc_len, cfg.d_model), cfg.adtype),
        "k": ((L, batch, max_dec_len, kv, hd), cfg.adtype),
        "v": ((L, batch, max_dec_len, kv, hd), cfg.adtype),
    }

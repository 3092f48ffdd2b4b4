"""Pixtral-12B backbone: a mistral-nemo-style decoder behind a stub ViT
frontend (port of `repro.models.vlm`).

The frontend is a stub: the batch carries precomputed patch embeddings
(B, P, D), which are projected (`patch_proj`) and prepended to the text
embeddings.  Logits cover the text positions only; the KV caches span
patches + text, so decode positions count from the start of that stream.
Decode is the transformer's (`lm_decode`, and `lm_decode_paged` on the
continuous-batching path, and `decode_cache_specs` over patches + text):
patches only change prefill, so the registry uses the transformer's.
Under a `ShardCtx` the batch carries this process's rows, patches
included, and the blocks and head are the transformer's tensor-parallel
ones; `patch_proj` replicates.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.layers import NO_SHARD, PSpec, ShardCtx, gemm
from repro_torch.models.transformer import (
    _layers,
    block_apply,
    embed_tokens,
    layer_entry,
    lm_specs,
    seq_whole,
    top_weights,
    unembed,
)

__all__ = ["vlm_specs", "vlm_forward", "vlm_prefill"]


def vlm_specs(cfg) -> Dict[str, Any]:
    specs = lm_specs(cfg)
    specs["patch_proj"] = PSpec((cfg.d_model, cfg.d_model), ("embed", "embed"), 0.02)
    return specs


def _embed_multimodal(params, batch, cfg, ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """concat(project(patch_embeds), embed(tokens)) -> (B, P+T, D)."""
    patches = gemm(batch["patches"].to(cfg.adtype), params["patch_proj"].to(cfg.adtype), cfg)
    patches = ctx.c(patches, ("batch", "patches", "embed"), (None, *patches.shape[1:]))
    text = embed_tokens(params, batch["tokens"], cfg, ctx)
    return torch.cat([patches, text], dim=1)


def vlm_forward(params, batch: Dict[str, torch.Tensor], cfg, ctx: ShardCtx = NO_SHARD):
    """batch: {"patches": (B, P, D), "tokens": (B, T)} -> (text logits, aux).
    Causal over the concatenated stream."""
    params, specs = top_weights(params, vlm_specs, cfg, ctx)
    x = _embed_multimodal(params, batch, cfg, ctx)
    t = x.shape[1]
    x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
    for lp in _layers(params["blocks"], cfg.num_layers):
        lp, x = layer_entry(lp, x, ctx, t, specs)
        x, _, _ = block_apply(lp, x, cfg, ctx)
        x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
    n_patches = batch["patches"].shape[1]
    return unembed(params, seq_whole(x, ctx, t)[:, n_patches:], cfg, ctx), {}


def vlm_prefill(params, batch, cfg, ctx: ShardCtx = NO_SHARD):
    """Returns (text logits, stacked caches (L, B, P+T, KV, hd))."""
    x = _embed_multimodal(params, batch, cfg, ctx)
    t = x.shape[1]
    ks, vs = [], []
    for lp in _layers(params["blocks"], cfg.num_layers):
        x, cache, _ = block_apply(lp, seq_whole(x, ctx, t), cfg, ctx, write_cache=True)
        x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
        ks.append(cache["k"])
        vs.append(cache["v"])
    n_patches = batch["patches"].shape[1]
    logits = unembed(params, seq_whole(x, ctx, t)[:, n_patches:], cfg, ctx)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

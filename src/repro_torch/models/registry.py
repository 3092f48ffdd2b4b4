"""Uniform model API the launch/serve layer talks to (port of
`repro.models.registry`, all six families).

`get_model(cfg)` returns a `Model` with a family-independent interface:
  init(generator, device)                 parameter tree (1 source: PSpec)
  logical_axes()                          its logical axes, for sharding
  forward(params, batch, ctx)             train/eval logits
  loss(params, batch, ctx)                scalar loss + metrics (on a
                                          rank's blocks under a mesh: its
                                          vocab-sharded logits are read
                                          without a gather)
  prefill / decode + decode_state_specs   dense-cache serving path
  paged_decode + paged_pool_specs         continuous-batching path (dense,
                                          moe, vlm)
  abstract_params / batch_specs /         meta tensors + logical axes for
  decode_input_specs                      the dry runs (no storage)

Every compute method takes a `ShardCtx` (default: none), as in the
reference, and every family runs tensor-parallel under it: dense, moe and
vlm through `models.transformer`, ssm through `models.rwkv`, hybrid
through `models.ssm` and audio through `models.whisper`, each on the rows
it is given (the serving steps split the batch over 'data').
`decode_state_specs(batch, max_len, ctx)` gives this process's block of
the decode state under `ctx`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import rwkv, ssm, transformer, vlm, whisper
from repro_torch.models.layers import (
    NO_SHARD,
    ShardCtx,
    abstract_params,
    init_params,
    logical_axes_tree,
    padded_vocab,
    softmax_xent,
)

__all__ = ["Model", "get_model"]


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    _specs: Callable
    _forward: Callable
    _prefill: Callable
    _decode: Callable
    _state_specs: Callable  # (cfg, batch, max_len, ctx) -> {name: (shape, dtype)}
    _paged_decode: Optional[Callable] = None

    # -- parameters ---------------------------------------------------------
    def specs(self):
        return self._specs(self.cfg)

    def init(self, generator: torch.Generator, device=None):
        """Random parameters from `generator` on `device` (cuda unless the
        caller names another; the generator must live on that device)."""
        return init_params(generator, self.specs(), self.cfg.pdtype,
                           device=resolve_device(device))

    def abstract_params(self):
        """The parameter tree as meta tensors (shapes and dtypes only)."""
        return abstract_params(self.specs(), self.cfg.pdtype)

    def logical_axes(self):
        return logical_axes_tree(self.specs())

    # -- compute ------------------------------------------------------------
    def forward(self, params, batch: Dict[str, torch.Tensor], ctx: ShardCtx = NO_SHARD):
        return self._forward(params, batch, self.cfg, ctx)

    def loss(self, params, batch, ctx: ShardCtx = NO_SHARD):
        logits, aux = self.forward(params, batch, ctx)
        # Under a mesh the logits are this process's vocab columns.
        vocab = ctx.part("vocab", padded_vocab(self.cfg))
        loss, acc = softmax_xent(logits, batch["labels"], vocab, ctx)
        if self.cfg.is_moe:
            loss = loss + self.cfg.router_aux_coef * aux["lb_loss"] + 1e-3 * aux["router_z"]
        metrics = {"loss": loss, "accuracy": acc, **aux}
        return loss, metrics

    def prefill(self, params, batch: Dict[str, torch.Tensor], ctx: ShardCtx = NO_SHARD):
        return self._prefill(params, batch, self.cfg, ctx)

    def decode(self, params, tokens, state, pos, ctx: ShardCtx = NO_SHARD):
        return self._decode(params, tokens, state, pos, self.cfg, ctx)

    def decode_state_specs(self, batch: int, max_len: int, ctx: ShardCtx = NO_SHARD):
        """This process's block of the decode state for `batch` rows (its
        rows where the caller split them) under `ctx`."""
        return self._state_specs(self.cfg, batch, max_len, ctx)

    # -- paged serving (continuous batching) ---------------------------------
    @property
    def supports_paged(self) -> bool:
        return self._paged_decode is not None

    def paged_decode(self, params, tokens, pools, block_tables, positions,
                     ctx: ShardCtx = NO_SHARD, *, impl: Optional[str] = None):
        """One continuous-batching decode step against paged KV pools."""
        if self._paged_decode is None:
            raise NotImplementedError(f"family {self.cfg.family!r} has no paged decode path")
        return self._paged_decode(
            params, tokens, pools, block_tables, positions, self.cfg, ctx, impl=impl
        )

    def paged_pool_specs(self, num_pages: int, page_size: int, ctx: ShardCtx = NO_SHARD):
        if self._paged_decode is None:
            raise NotImplementedError(f"family {self.cfg.family!r} has no paged decode path")
        return transformer.paged_pool_specs(self.cfg, num_pages, page_size, ctx)

    # -- dry-run input specs --------------------------------------------------
    def batch_specs(self, shape: ShapeSpec) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Training/prefill inputs of the global batch as meta tensors, and
        their logical axes (the reference's `batch_specs`)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(shp, dt=torch.int32):
            return torch.empty(shp, dtype=dt, device="meta")

        if cfg.family == "audio":
            dec = s // cfg.dec_ratio
            specs = {"frames": meta((b, s, cfg.d_model), cfg.adtype),
                     "tokens": meta((b, dec)), "labels": meta((b, dec))}
            axes = {"frames": ("batch", "frames", "embed"), "tokens": ("batch", "seq"),
                    "labels": ("batch", "seq")}
        elif cfg.family == "vlm":
            specs = {"patches": meta((b, cfg.num_stub_patches, cfg.d_model), cfg.adtype),
                     "tokens": meta((b, s)), "labels": meta((b, s))}
            axes = {"patches": ("batch", "patches", "embed"), "tokens": ("batch", "seq"),
                    "labels": ("batch", "seq")}
        else:
            specs = {"tokens": meta((b, s)), "labels": meta((b, s))}
            axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        return specs, axes

    def decode_input_specs(self, shape: ShapeSpec):
        """The serve step's inputs as meta tensors: (tokens (B, 1), the
        global decode state, pos (), the state's logical axes), the
        reference's `decode_input_specs`."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
        pos = torch.empty((), dtype=torch.int32, device="meta")
        state = {k: torch.empty(shp, dtype=dt, device="meta")
                 for k, (shp, dt) in self.decode_state_specs(b, s).items()}
        kv = ("layers", "kv_batch", "kv_seq", "kv_heads", "head_dim")
        if cfg.family == "audio":
            axes = {"enc_out": ("kv_batch", "kv_seq", "embed"), "k": kv, "v": kv}
        elif cfg.family == "ssm":
            axes = {"wkv": ("layers", "batch", "heads", None, None),
                    "tm_shift": ("layers", "batch", "embed"),
                    "cm_shift": ("layers", "batch", "embed")}
        elif cfg.family == "hybrid":
            axes = {"h": ("layers", "batch", "heads", None, "state"),
                    "conv": ("layers", "batch", None, "mlp"), "kv_k": kv, "kv_v": kv}
        else:
            axes = {"k": kv, "v": kv}
        return tokens, state, pos, axes


def _lm_forward(params, batch, cfg, ctx):
    return transformer.lm_forward(params, batch["tokens"], cfg, ctx)


def _lm_prefill(params, batch, cfg, ctx):
    return transformer.lm_prefill(params, batch["tokens"], cfg, ctx)


def _rwkv_forward(params, batch, cfg, ctx):
    return rwkv.rwkv_forward(params, batch["tokens"], cfg, ctx)


def _rwkv_prefill(params, batch, cfg, ctx):
    return rwkv.rwkv_prefill(params, batch["tokens"], cfg, ctx)


def _zamba_forward(params, batch, cfg, ctx):
    return ssm.zamba_forward(params, batch["tokens"], cfg, ctx)


def _zamba_prefill(params, batch, cfg, ctx):
    return ssm.zamba_prefill(params, batch["tokens"], cfg, ctx)


def get_model(cfg: ArchConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe"):
        return Model(
            cfg,
            transformer.lm_specs,
            _lm_forward,
            _lm_prefill,
            transformer.lm_decode,
            transformer.decode_cache_specs,
            _paged_decode=transformer.lm_decode_paged,
        )
    if fam == "ssm":
        return Model(
            cfg,
            rwkv.rwkv_specs,
            _rwkv_forward,
            _rwkv_prefill,
            rwkv.rwkv_decode,
            lambda c, b, m, ctx: rwkv.rwkv_state_specs(c, b, ctx),
        )
    if fam == "hybrid":
        return Model(
            cfg,
            ssm.zamba_specs,
            _zamba_forward,
            _zamba_prefill,
            ssm.zamba_decode,
            ssm.zamba_state_specs,
        )
    if fam == "audio":
        return Model(
            cfg,
            whisper.whisper_specs,
            whisper.whisper_forward,
            whisper.whisper_prefill,
            whisper.whisper_decode,
            lambda c, b, m, ctx: whisper.whisper_cache_specs(c, b, m, m // c.dec_ratio, ctx),
        )
    if fam == "vlm":
        return Model(
            cfg,
            vlm.vlm_specs,
            vlm.vlm_forward,
            vlm.vlm_prefill,
            transformer.lm_decode,
            lambda c, b, m, ctx: transformer.decode_cache_specs(c, b, m + c.num_stub_patches, ctx),
            # vlm decode is structurally lm_decode (patches only affect
            # prefill); the scheduler offsets positions by num_stub_patches.
            _paged_decode=transformer.lm_decode_paged,
        )
    raise ValueError(f"unknown family {fam!r}")

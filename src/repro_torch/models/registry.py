"""Uniform model API the launch/serve layer talks to (port of
`repro.models.registry`, all six families).

`get_model(cfg)` returns a `Model` with a family-independent interface:
  init(generator, device)                 parameter tree (1 source: PSpec)
  logical_axes()                          its logical axes, for sharding
  forward(params, batch)                  train/eval logits
  loss(params, batch)                     scalar loss + metrics
  prefill / decode + decode_state_specs   dense-cache serving path
  paged_decode + paged_pool_specs         continuous-batching path (dense,
                                          moe, vlm)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv, ssm, transformer, vlm, whisper
from repro_torch.models.layers import init_params, logical_axes_tree, softmax_xent

__all__ = ["Model", "get_model"]


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    _specs: Callable
    _forward: Callable
    _prefill: Callable
    _decode: Callable
    _state_specs: Callable  # (batch, max_len) -> {name: (shape, dtype)}
    _paged_decode: Optional[Callable] = None

    # -- parameters ---------------------------------------------------------
    def specs(self):
        return self._specs(self.cfg)

    def init(self, generator: torch.Generator, device=None):
        """Random parameters from `generator` on `device` (cuda unless the
        caller names another; the generator must live on that device)."""
        return init_params(generator, self.specs(), self.cfg.pdtype,
                           device=resolve_device(device))

    def logical_axes(self):
        return logical_axes_tree(self.specs())

    # -- compute ------------------------------------------------------------
    def forward(self, params, batch: Dict[str, torch.Tensor]):
        return self._forward(params, batch, self.cfg)

    def loss(self, params, batch):
        logits, aux = self.forward(params, batch)
        loss, acc = softmax_xent(logits, batch["labels"])
        if self.cfg.is_moe:
            loss = loss + self.cfg.router_aux_coef * aux["lb_loss"] + 1e-3 * aux["router_z"]
        metrics = {"loss": loss, "accuracy": acc, **aux}
        return loss, metrics

    def prefill(self, params, batch: Dict[str, torch.Tensor]):
        return self._prefill(params, batch, self.cfg)

    def decode(self, params, tokens, state, pos):
        return self._decode(params, tokens, state, pos, self.cfg)

    def decode_state_specs(self, batch: int, max_len: int):
        return self._state_specs(self.cfg, batch, max_len)

    # -- paged serving (continuous batching) ---------------------------------
    @property
    def supports_paged(self) -> bool:
        return self._paged_decode is not None

    def paged_decode(self, params, tokens, pools, block_tables, positions, *,
                     impl: Optional[str] = None):
        """One continuous-batching decode step against paged KV pools."""
        if self._paged_decode is None:
            raise NotImplementedError(f"family {self.cfg.family!r} has no paged decode path")
        return self._paged_decode(
            params, tokens, pools, block_tables, positions, self.cfg, impl=impl
        )

    def paged_pool_specs(self, num_pages: int, page_size: int):
        if self._paged_decode is None:
            raise NotImplementedError(f"family {self.cfg.family!r} has no paged decode path")
        return transformer.paged_pool_specs(self.cfg, num_pages, page_size)


def _lm_forward(params, batch, cfg):
    return transformer.lm_forward(params, batch["tokens"], cfg)


def _lm_prefill(params, batch, cfg):
    return transformer.lm_prefill(params, batch["tokens"], cfg)


def _rwkv_forward(params, batch, cfg):
    return rwkv.rwkv_forward(params, batch["tokens"], cfg)


def _rwkv_prefill(params, batch, cfg):
    return rwkv.rwkv_prefill(params, batch["tokens"], cfg)


def _zamba_forward(params, batch, cfg):
    return ssm.zamba_forward(params, batch["tokens"], cfg)


def _zamba_prefill(params, batch, cfg):
    return ssm.zamba_prefill(params, batch["tokens"], cfg)


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
            lambda c, b, m: rwkv.rwkv_state_specs(c, b),
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
            lambda c, b, m: whisper.whisper_cache_specs(c, b, m, m // c.dec_ratio),
        )
    if fam == "vlm":
        return Model(
            cfg,
            vlm.vlm_specs,
            vlm.vlm_forward,
            vlm.vlm_prefill,
            transformer.lm_decode,
            lambda c, b, m: transformer.decode_cache_specs(c, b, m + c.num_stub_patches),
            # vlm decode is structurally lm_decode (patches only affect
            # prefill); the scheduler offsets positions by num_stub_patches.
            _paged_decode=transformer.lm_decode_paged,
        )
    raise ValueError(f"unknown family {fam!r}")

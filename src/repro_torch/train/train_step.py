"""Serving steps (port of the serving half of `repro.train.train_step`).

The training step, optimizer and gradient accumulation arrive with the
training slice.  PyTorch runs eagerly, so a step is a plain function where
the reference returns a function for `jax.jit`.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(model: Model) -> Callable:
    @torch.inference_mode()
    def prefill_step(params, batch):
        logits, state = model.prefill(params, batch)
        # next token from the last position — the serving handoff
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, state

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    @torch.inference_mode()
    def serve_step(params, tokens, state, pos):
        logits, new_state = model.decode(params, tokens, state, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, new_state

    return serve_step

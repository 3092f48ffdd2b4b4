"""Train and serve step factories (port of `repro.train.train_step`).

`make_train_step(model, schedule, ...)` returns a (state, batch) ->
(state, metrics) function: gradients of `model.loss` by autograd,
global-norm clipping and AdamW with a schedule, optionally over microbatches
(`grad_accum`).  State = {"params", "opt", "step"}, the reference's layout.
PyTorch runs eagerly, so a step is a plain function where the reference
returns one for `jax.jit`; the step updates the state's parameter and
moment tensors in place (see `optim.adamw`) and returns the same state.
The compressed data-parallel step arrives with the distribution slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["init_train_state", "make_prefill_step", "make_serve_step", "make_train_step"]


def init_train_state(model: Model, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters (from `generator`, on `device`: cuda unless the
    caller names another), zero AdamW moments and step 0."""
    params = model.init(generator, resolve_device(device))
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"params": params, "opt": adamw_init(params), "step": step}


def make_train_step(
    model: Model,
    schedule: Callable[[torch.Tensor], torch.Tensor],
    adamw_cfg: AdamWConfig = AdamWConfig(),
    grad_accum: int = 1,
) -> Callable:
    """grad_accum > 1: the batch splits on its leading dim into that many
    microbatches, run one after another into an f32 gradient sum, as the
    reference's scan does; the step then uses their mean."""

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True,
                                       materialize_grads=True)
        return tree_unflatten(params, flat), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if grad_accum == 1:
            grads, metrics = grads_of(params, batch)
        else:
            size = next(iter(batch.values())).shape[0] // grad_accum
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            mstack = []
            for i in range(grad_accum):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                g, m = grads_of(params, mb)
                tree_map(lambda a, x: a.add_(x.float()), gsum, g)
                mstack.append(m)
            grads = tree_map(lambda g: g / grad_accum, gsum)
            metrics = {k: torch.stack([m[k] for m in mstack]).mean() for k in mstack[0]}
        lr = schedule(state["opt"]["count"])
        new_params, new_opt, gnorm = adamw_update(grads, state["opt"], params, lr, adamw_cfg)
        metrics = {**metrics, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step


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

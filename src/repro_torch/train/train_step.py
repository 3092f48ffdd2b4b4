"""Train and serve step factories (port of `repro.train.train_step`).

`make_train_step(model, schedule, ...)` returns a (state, batch) ->
(state, metrics) function: gradients of `model.loss` by autograd,
global-norm clipping and AdamW with a schedule, optionally over microbatches
(`grad_accum`).  State = {"params", "opt", "step"}, the reference's layout.
PyTorch runs eagerly, so a step is a plain function where the reference
returns one for `jax.jit`; the step updates the state's parameter and
moment tensors in place (see `optim.adamw`) and returns the same state.

Data parallelism, SPMD (one process per rank; `mesh` a DeviceMesh whose
'batch' axes, ('pod', 'data') by the rules, hold the ranks):
`make_train_step(..., mesh=)` is the torch form of the reference's pjit
step on a ("data", "model") mesh with model = 1.  Every rank gets the same
global batch and takes its contiguous rows; the gradients and metrics are
all-reduced in f32 into the global batch's, each rank weighted by its row
count, which is exact for the token-mean loss even when the rows do not
divide by the ranks (MoE routes the global batch: `moe.global_routing`);
then clipping and AdamW run on every rank, so the parameters stay bitwise
equal across ranks.  Tensor parallelism (`make_train_step(..., ctx=)`, a `ShardCtx` on a
('data', 'model') mesh, the reference's `ctx` argument): the state holds
this rank's blocks (`interop.shard_params`), `model.loss` runs under the
ctx on this data rank's rows, and its backward is seeded with 1/M (M the
'model' axis's size): the loss is computed alike on every 'model' rank,
and every collective's backward is its adjoint (`parallel.collectives`),
so a rank's gradient of its own block is the true one and its gradient of
a replicated leaf is a share.  The shares are summed over 'model' in f32
(`interop.ModelBlocks.reduce_replicated`: whole replicated leaves and
Mamba2's B and C segments, nothing sharded), then every gradient over
'data' as above; clipping takes the global norm of the blocks
(`optim.global_norm(tree, blocks)`).  With M = 1 the seed is 1 and
nothing is summed over 'model', so the single-process and data-parallel
steps are bitwise what they were.  FSDP (a ctx with `param_rules`, the
reference's `PARAM_RULES`): the state holds this rank's (data x model)
blocks, the model gathers each layer's weights over the DP axes and the
gather's backward reduce-scatters their gradients, so the backward is
seeded with this rank's share of the microbatch over M (the weight the
DP step applies after it), and only the leaves every DP rank holds whole
are all-reduced over 'data' (`ModelBlocks.data_cut`).  `make_dp_train_step_compressed` is the reference's
shard_map step with the int8 error-feedback all-reduce
(`parallel.compression`): its state carries "err", each rank's own
residual as a (1, *shape) slice of the reference's (dp, *shape) leaves
(`interop.stack_ranks` stacks the ranks' slices).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.interop import model_blocks
from repro_torch.models import moe
from repro_torch.models.layers import NO_SHARD, ShardCtx, padded_vocab
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel.collectives import (
    all_reduce,
    axis_group,
    mesh_groups,
    raise_together,
)
from repro_torch.parallel.compression import compressed_pmean_tree, init_error_state
from repro_torch.parallel.sharding import logical_to_physical
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "abstract_train_state",
    "init_dp_train_state_compressed",
    "init_train_state",
    "make_dp_train_step_compressed",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
]


def init_train_state(model: Model, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters (from `generator`, on `device`: cuda unless the
    caller names another), zero AdamW moments and step 0."""
    params = model.init(generator, resolve_device(device))
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"params": params, "opt": adamw_init(params), "step": step}


def abstract_train_state(model: Model) -> Dict[str, Any]:
    """The train state as meta tensors (the dry runs' abstract state): the
    parameters, f32 AdamW moments, and the int32 count and step."""
    params = model.abstract_params()

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    def i32():
        return torch.empty((), dtype=torch.int32, device="meta")

    return {"params": params,
            "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params), "count": i32()},
            "step": i32()}


def _grads_of(model: Model, params, batch, ctx: ShardCtx = NO_SHARD, seed=None):
    """Gradients of model.loss at `params` (leaf dtypes) under `ctx`, its
    backward seeded with `seed` (None: 1), and its metrics."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = model.loss(params, batch, ctx)
        flat = torch.autograd.grad(
            loss, leaves, None if seed is None else torch.full_like(loss, seed),
            allow_unused=True, materialize_grads=True)
    return tree_unflatten(params, flat), {k: v.detach() for k, v in metrics.items()}


def _on_device(batch, params) -> Dict[str, torch.Tensor]:
    dev = tree_leaves(params)[0].device
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _apply(state, grads, metrics, schedule, adamw_cfg, blocks=None):
    """Clip, AdamW at the schedule's lr, step + 1: (state, metrics)."""
    params = state["params"]
    lr = schedule(state["opt"]["count"])
    args = (grads, state["opt"], params, lr, adamw_cfg) + (() if blocks is None else (blocks,))
    new_params, new_opt, gnorm = adamw_update(*args)
    metrics = {**metrics, "grad_norm": gnorm, "lr": lr}
    return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics


def _dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the logical 'batch' axis maps to (the DP axes)."""
    axes = logical_to_physical(("batch",), mesh)[0]
    return () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))


def _row_range(rows: int, ranks: int, idx: int) -> Tuple[int, int]:
    """Rank idx's contiguous rows of `rows`, as torch.tensor_split cuts them
    (the first rows % ranks ranks take one more)."""
    base, extra = divmod(rows, ranks)
    lo = idx * base + min(idx, extra)
    return lo, lo + base + (idx < extra)


def _reduce_metrics(metrics: Dict[str, torch.Tensor], weight: float, group):
    """sum over ranks of weight x metric, in f32, by one all-reduce."""
    names = sorted(metrics)
    vec = torch.stack([metrics[k].float() for k in names]) * weight
    if group is not None:
        vec = all_reduce(vec, group=group)
    return dict(zip(names, vec.unbind()))


def make_train_step(
    model: Model,
    schedule: Callable[[torch.Tensor], torch.Tensor],
    adamw_cfg: AdamWConfig = AdamWConfig(),
    ctx: ShardCtx = NO_SHARD,
    grad_accum: int = 1,
    mesh=None,
) -> Callable:
    """The step of this process (module docstring); with `ctx` on a mesh
    (the reference's argument) or `mesh`, this rank's step on the global
    batch: data-parallel over the mesh's 'batch' axes, tensor-parallel
    over 'model' (ctx only; `mesh=` alone runs the model without a ctx, as
    the data-parallel callers do).  grad_accum > 1 splits the global
    batch on its leading dim into that many microbatches, run one after
    another into an f32 gradient sum, as the reference's scan does (under
    pjit too: each rank takes its rows of each microbatch); the step then
    uses their mean.  On one rank the gradients are the single-process
    ones, in the leaf dtypes without accumulation.  A rank whose local
    computation raises makes every rank of the mesh raise before the
    gradients' all-reduces (`collectives.raise_together` over each mesh
    axis).  `step.grads(params, batch)` returns the global batch's
    gradients (of this rank's blocks) and metrics alone; `step.blocks` is
    the `interop.ModelBlocks` of a 'model' axis, else None.

    MoE under several ranks routes the global batch through
    `moe.global_routing`, a process-wide setting rather than an argument of
    `model.loss`: the `dots` remat policy recomputes moe_block during the
    backward on autograd's device thread, outside any argument or
    thread-local state of this call, so the setting spans the whole of
    `_grads_of` and is restored after it."""
    if ctx.mesh is not None:
        if mesh is not None and mesh is not ctx.mesh:
            raise ValueError("make_train_step: ctx= and mesh= name different meshes")
        mesh = ctx.mesh
    group, ranks, idx = (None, 1, 0) if mesh is None else axis_group(mesh, _dp_axes(mesh))
    blocks = model_blocks(model, ctx)
    every = mesh_groups(mesh)
    seed = None if blocks is None else 1.0 / blocks.size
    fsdp = blocks is not None and blocks.data_group is not None

    def grads(params, batch):
        """The global batch's gradients (on every rank) and metrics."""
        batch = _on_device(batch, params)
        total = next(iter(batch.values())).shape[0]
        if total // grad_accum < ranks:
            raise ValueError(f"a global batch of {total} rows in {grad_accum} microbatches"
                             f" leaves a rank of {ranks} without rows")
        dev = tree_leaves(params)[0].device
        acc, macc, error = None, None, None
        try:
            for mb in range(grad_accum):
                m_lo, m_hi = _row_range(total, grad_accum, mb)
                lo, hi = _row_range(m_hi - m_lo, ranks, idx)
                local = {k: v[m_lo + lo:m_lo + hi] for k, v in batch.items()}
                c = NO_SHARD if ctx.mesh is None else ctx.for_rows(m_hi - m_lo)
                w = (hi - lo) / (m_hi - m_lo)  # this rank's share of the microbatch
                with moe.global_routing(group, m_hi - m_lo):
                    g, m = _grads_of(model, params, local, c, seed * w if fsdp else seed)
                if ranks == 1 and grad_accum == 1 and blocks is None:
                    return g, m
                part = tree_map(lambda x: x.float() if fsdp else x.float() * w, g)
                acc = part if acc is None else tree_map(torch.add, acc, part)
                mw = {k: v.float() * w for k, v in m.items()}
                macc = mw if macc is None else {k: macc[k] + mw[k] for k in mw}
                del g, part
        except Exception as e:  # noqa: BLE001 - re-raised on every rank below
            error = e
        raise_together(error, every, dev)
        if blocks is not None:  # the replicated leaves' shares, summed over 'model'
            blocks.reduce_replicated(acc)
        if group is not None:
            acc = tree_map(lambda x, cut: x if cut else all_reduce(x, group=group), acc,
                           blocks.data_cut if fsdp else tree_map(lambda x: (), acc))
        if grad_accum == 1:  # the single-process step's leaf dtypes
            out = tree_map(lambda x, p: x.to(p.dtype), acc, params)
        else:  # the f32 mean
            out = tree_map(lambda x: x / grad_accum, acc)
        return out, _reduce_metrics(macc, 1.0 / grad_accum, group)

    def step(state, batch):
        g, metrics = grads(state["params"], batch)
        return _apply(state, g, metrics, schedule, adamw_cfg, blocks)

    step.grads = grads
    step.blocks = blocks
    return step


def make_dp_train_step_compressed(
    model: Model,
    schedule: Callable,
    mesh,
    adamw_cfg: AdamWConfig = AdamWConfig(),
    dp_axes: Tuple[str, ...] = ("data",),
) -> Callable:
    """Data-parallel step with the explicit int8 error-feedback all-reduce
    (the reference's shard_map step).  State additionally carries
    {"err": this rank's residual tree, leaves (1, *shape)}; params and
    optimizer state are replicated.  The global batch splits evenly over
    the ranks of `dp_axes`; each rank routes and averages its own rows,
    and the metrics are the ranks' plain mean, as under shard_map."""
    group, ranks, idx = axis_group(mesh, dp_axes)

    def step(state, batch):
        params = state["params"]
        batch = _on_device(batch, params)
        total = next(iter(batch.values())).shape[0]
        if total % ranks:
            raise ValueError(f"a global batch of {total} rows does not split over {ranks} ranks")
        size = total // ranks
        local = {k: v[idx * size:(idx + 1) * size] for k, v in batch.items()}
        grads, metrics = _grads_of(model, params, local)
        err = tree_map(lambda e: e[0], state["err"])
        means, new_err = compressed_pmean_tree(grads, err, dp_axes, mesh=mesh)
        del grads
        metrics = _reduce_metrics(metrics, 1.0 / ranks, group)
        lr = schedule(state["opt"]["count"])
        new_params, new_opt, gnorm = adamw_update(means, state["opt"], params, lr, adamw_cfg)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1,
                     "err": tree_map(lambda e: e[None], new_err)}
        return new_state, {**metrics, "grad_norm": gnorm}

    return step


def init_dp_train_state_compressed(model: Model, generator: torch.Generator, device=None):
    """`init_train_state` plus this rank's zero residuals: err leaves
    (1, *param_shape), its slice of the reference's (dp, *param_shape)
    (so, unlike the reference's, it needs no mesh)."""
    state = init_train_state(model, generator, device)
    state["err"] = tree_map(lambda e: e[None], init_error_state(state["params"]))
    return state


def _next_token(logits: torch.Tensor, rows: int, cfg, ctx: ShardCtx) -> torch.Tensor:
    """Greedy next token of each of the batch's `rows` rows, on every rank:
    the last position's logits, gathered over the ranks that hold other
    rows or vocab entries, then the argmax (the serving handoff)."""
    last = logits[:, -1, :]
    vocab = last.shape[-1] * ctx.part("vocab", padded_vocab(cfg)).count
    last = ctx.gather(last, ("batch", "vocab"), (rows, vocab))
    return torch.argmax(last, dim=-1).to(torch.int32)


def _local_rows(tree, ctx: ShardCtx):
    """This process's rows of every tensor of `tree` (dim 0: the batch)."""
    return {k: ctx.c(v, ("batch",) + (None,) * (v.dim() - 1)) for k, v in tree.items()}


def make_prefill_step(model: Model, ctx: ShardCtx = NO_SHARD) -> Callable:
    """(params, batch) -> (next tokens (B,), decode state).  Under a mesh,
    every rank passes the whole batch; the model runs on this process's
    rows (split over 'data' where they divide) and the state holds them."""
    @torch.inference_mode()
    def prefill_step(params, batch):
        rows = batch["tokens"].shape[0]
        c = ctx.for_rows(rows)
        logits, state = model.prefill(params, _local_rows(batch, c), c)
        # next token from the last position — the serving handoff
        return _next_token(logits, rows, model.cfg, c), state

    return prefill_step


def make_serve_step(model: Model, ctx: ShardCtx = NO_SHARD) -> Callable:
    """(params, tokens (B, T), state, pos) -> (next tokens (B,), state), the
    tokens whole on every rank as `make_prefill_step`'s."""
    @torch.inference_mode()
    def serve_step(params, tokens, state, pos):
        rows = tokens.shape[0]
        c = ctx.for_rows(rows)
        logits, new_state = model.decode(params, _local_rows({"t": tokens}, c)["t"], state,
                                         pos, c)
        return _next_token(logits, rows, model.cfg, c), new_state

    return serve_step
